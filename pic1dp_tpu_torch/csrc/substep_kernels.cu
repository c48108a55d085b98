// Fused RK2 substep kernels of the matrix-free spectral step, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (pic1dp_tpu_torch/ops/substep_kernels.py).
//
// They replace the TPU kernel built by make_substep_call in
// pic1dp_tpu/ops/pallas_kernels.py (:395-730): substep 1 is
// make_substep_call(cfg, 1, n) (body :558-591) and substep 2 is
// make_substep_call(cfg, 2, n) (body :592-622), each with the mode-projection
// deposit of :624-643, with separate streams, any number of kept modes
// (each evaluated directly, no angle-addition recurrence) and of species,
// float and double.  One body per substep serves every layout of the TPU
// kernel (:499-508), the template parameter L:
//
//   kNonlinear  nonlinear delta-f, stream_v1:
//               substep 1 reads x0, v0, p, w0, writes w1, v1;
//               substep 2 reads x0, v0, p, w0, w1, v1, writes x2, v2, w2;
//   kLinear     linear delta-f (v frozen, drive p E, :526):
//               substep 1 reads x0, v0, p, w0, writes w1;
//               substep 2 reads x0, v0, p, w0, w1, writes x2, w2 (v1 = v0,
//               :604-605, so it takes only the midpoint modes);
//   kFullf      full-f (w unused, deposit charge p, :629):
//               substep 1 reads x0, v0, p and writes no marker stream;
//               substep 2 reads x0, v0, p and rebuilds v1 from a gather at
//               x0 with the step-start modes (the recompute layout,
//               :601-603), writes x2, v2;
//   kRecompute  nonlinear delta-f without stream_v1 (:501-507, :599-603):
//               substep 1 reads x0, v0, p, w0, writes w1;
//               substep 2 reads x0, v0, p, w0, w1 and rebuilds v1 as full-f
//               does, with the same device functions and expression as
//               substep 1's v1 (so the same bits), writes x2, v2, w2;
//
// and both species modes, the template parameter kSpecies:
//
//   false  the main path's kernel: one species and the bump-on-tail or
//          Maxwellian drive (forms 0 and 1 of minus_dlnf0_dv; core
//          fractions 0 and 1 included), nonlinear delta-f with v1 streamed
//          or rebuilt, up to kMaxModes modes;
//   true   the port of pallas_kernels._make_sel (:71-89): the state is
//          (ns, n) and contiguous, so species s is the slice [s n, (s + 1) n).
//          As the TPU kernel's grid gives each block one species (:36-39),
//          the launch is a (bps, ns) grid (the wrapper's species_grid gives
//          ns bps blocks; a count that is not a multiple of ns is refused):
//          block (b, s) walks species s alone, over the positions block b
//          of a one-species launch of bps blocks walks, so every block has
//          markers at any species count and no index costs a division (the
//          loop over species stays, from blockIdx.y in steps of gridDim.y:
//          at this grid it runs once).  The
//          block's constants (dt q/m, charge, the -f0'/f0 form and its
//          constants) are selected once (with_species), and every form is
//          compiled in, the two-stream drives and the mixed-degenerate clamp
//          included.  Species kMaxSpecies and above take their constants
//          from a device table instead of the parameter bank.
//
// The kept modes come in bins, the template parameters NM and kGrid.  Up
// to 4 modes (NM = 1 or 4) each thread keeps NM projection sums, NM mode
// components and the constants of hat_table in registers and folds every
// mode per marker.  Above 4 modes the grid bin (kGrid, NM = 0) works
// through the nx cells instead, as the reference's shape matrix and partial
// DFT do (pic1dp_field.F90:176-257): the hat fold is linear in the table
// entries, so the gather is the hat lerp of E on the grid, and the deposit
// is the hat deposit onto a charge grid rho projected once per block.  A
// TPU kernel folds per mode because it has no fast scatter or per-lane
// gather (pallas_kernels.py:624-643); on Hopper a grid of nx values in
// shared memory is cheap.  Each block
//
//   * forms E_g[j] = 2 sum_m (cos th_mj re_m - sin th_mj im_m) for every
//     cell in shared memory from the angle table (grid_e; and E_g0 from the
//     step-start modes where substep 2 rebuilds v1), nx nmode FMAs per grid;
//   * pushes its markers with E = (1 - f) E_g[ix0] + f E_g[ix0 + 1]
//     (grid_gather), V markers per thread with 16-byte loads as in the
//     register bins, and deposits charge * w at x with the hat weights onto
//     its warp's charge grid (deposit_lanes: one __match_any_sync a marker
//     finds the lanes that share its cell, whose two halves the lowest of
//     them sums in lane order onto rho[ix0] and rho[nx + ix0]; so there is
//     no float atomic and the sum repeats bit for bit.  Two matches a
//     marker, one per half, or the lanes one after another, measured
//     slower: PERF.md, PR 8);
//   * sums the warps' grids in warp order, rho[j] + rho[nx + j - 1],
//     projects the block's charge onto the kept modes with the table, a
//     warp a mode (the same (2, nmode) partials row as the register bins),
//     and the last block sums the rows (grid_finish).
//
// So a marker's work does not depend on nmode: only the block's grid build
// and projection do.  The grids take (egrids (nx + 1) + 2 copies nx) values
// of T of dynamic shared memory (grid_smem; opted in above 48 KB): one
// charge grid per warp (copies = 8) where that fits in kGridSmemMax, else
// 4, 2 or 1 grids, each shared by kWarps / copies warps that deposit in
// turns separated by __syncthreads; where not even one fits, the block's
// grids lie in its own slice of the device buffer Args::grids, walked the
// same way.  The grid bin builds only the species loop.
//
// bf16_weights (the delta-f layouts; Config.validate refuses it with full-f):
// float arithmetic with p stored and w1 streamed as bfloat16
// (pallas_kernels.py:453-475, :555, :586, :610).  p and w1 are upcast in
// registers; substep 1 stores w1 rounded to nearest even
// (__float2bfloat16_rn, the same rounding as .astype(bfloat16)) and deposits
// the UNROUNDED w1 (:565-567, :629); v1 and the x, v, w state stay float.
//
// What bounds them on this card: memory traffic.  Per marker in f32,
// nonlinear substep 1 moves 6 values (24 bytes, 20 with bf16_weights) and
// substep 2 9 values (36 bytes, 32); linear 20 and 28 bytes; full-f 12 and
// 20.  Against that they do a few tens of flops per marker and mode, far
// below the H100's ~20 f32 flops per byte of HBM bandwidth.  Three parts of
// the design serve the bytes:
//
//   * The grid-angle table.  The TPU kernel computes each marker's angles
//     2 pi (m ix0 mod nx) / nx because a TPU has no cheap per-lane gather
//     from VMEM (_trig_block, :330-392); as a per-marker chain of %, divide
//     and sincospi that was most of these kernels' compute.  The angle takes
//     only nmode * nx values, so the wrapper builds them once in float64,
//     rounded to T, as (cos, sin) pairs (ang[j * nx + ix]); each block copies
//     the table into dynamic shared memory at its start with one
//     cp.async.bulk completed on an mbarrier, and a mode then costs one 8-byte
//     (16 in double) gather and the hat fold (hat_table).  A table too large
//     for the 48 KB a launch gets without an opt-in (angle_smem = 0) is read
//     from device memory, where it sits in L2, through the same pointer.
//   * Several markers per thread.  Each thread takes V consecutive markers
//     of a species per iteration with one 16-byte load of each stream (8
//     bytes for bfloat16 p and w1), all issued before the iteration's
//     arithmetic, and stores with 16-byte stores.  V is 4 in float and 2 in
//     double in every bin.  Loading the next iteration's group before
//     the current one's arithmetic was measured slower: it took the main
//     path's kernels to 58-80 registers, fewer blocks fit on an SM than the
//     grid has, and the last wave ran short.  Without it they use 40-64
//     registers and every block of the grid is resident.  A species slice
//     whose start is not V-aligned (s n with n not a multiple of V), or a
//     stream that is not 16-byte aligned, is walked with single-marker
//     iterations at its head and ragged tail (or entirely).
//   * A grid sized to the work and the projection sum in the kernel.  The
//     wrapper launches min(B * SMs, ceil(markers / (256 V))) blocks, and in
//     the species loop (bps, ns) with bps = min(B * SMs / ns, ceil(n /
//     (256 V))) (the same grid at one species).  Hopper
//     blocks run in no order, so each block reduces its threads' sums (of
//     its one species) with warp shuffles and shared memory in a
//     fixed tree and writes one (2, nmode) row of a (grid, 2, nmode)
//     partials buffer; the last block to finish (a __threadfence and an
//     atomicAdd on an int counter) sums the rows, thread t taking rows t,
//     t + 256, ... in order, then the same fixed tree, writes the (2, nmode)
//     projections and sets the counter back to 0 for the next launch or
//     graph replay.  There are no float atomics, so with a fixed grid the sum
//     is the same from run to run.
//   * The mode solve in the last block.  Where the launch is given `modes`,
//     the last block also writes the E-field modes of the projections it
//     has just stored, mode_re = -p_s g and mode_im = -p_c g with g =
//     grad_inv / lx (the wrapper's buffer, made by torch): one rounded
//     product each (__fmul_rn / __dmul_rn, never contracted), the bits of
//     ops/spectral.solve_modes.  So a step launches no solve between or
//     after its two kernels.  A rank of a particle-sharded run holds partial
//     projections and gets no `modes`: it solves after the all_reduce.
//
// Substep 2 updates x, v and w in place: each thread reads its own elements
// of each stream before it writes them, and no thread touches another's, so
// those pointers are not __restrict__ and are read by plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"
#include "substep_math.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A launch gets 48 KB of shared memory without cudaFuncSetAttribute; the
// register bins' static shared memory (the block sum of at most kMaxModes
// modes, the mbarrier, the last-block flag) stays within kStaticSmem, and the
// angle table may have the rest.
constexpr int kSmemNoOptIn = 48 * 1024;
constexpr int kStaticSmem = 4096;
constexpr int kAngleSmemMax = kSmemNoOptIn - kStaticSmem;
static_assert(kWarps * 2 * kMaxModes * sizeof(double) + 64 <= kStaticSmem,
              "the block sum outgrew kStaticSmem");
// The grid bin's dynamic shared memory at most: a block's 232,448 bytes with
// an opt-in, less kGridStaticSmem for its static arrays (2 kThreads values
// of T and the last-block flag).
constexpr int kGridStaticSmem = 8192;
constexpr int kGridSmemMax = 232448 - kGridStaticSmem;
static_assert(2 * kThreads * sizeof(double) + 64 <= kGridStaticSmem,
              "the grid bin's static arrays outgrew kGridStaticSmem");

// The most species a species-loop launch takes: its grid's y extent.
constexpr int kMaxGridSpecies = 65535;

// Blocks of kThreads an SM whose registers the grid bin's float kernels
// leave room for (0: no bound): its grid holds up to 4 an SM
// (ops/substep_kernels.grid_blocks_per_sm), so they keep to 64 registers.
// Unbound, ptxas gave its substep 2 up to 80 once each block walked one
// species, and a quarter of the grid then ran as a second wave.  The
// register bins stay unbound: bound, their species-loop substep 2 ran
// slower at the small verification shapes (PERF.md, PR 10).
template <typename T, bool kGrid>
constexpr int kMinBlocks = kGrid && sizeof(T) == 4 ? 4 : 0;

// The layouts; ops/substep_kernels.py passes these ints.
enum Layout { kNonlinear = 0, kLinear = 1, kFullf = 2, kRecompute = 3 };

// Markers per thread and iteration, in every bin (ops/substep_kernels.
// vector_width mirrors it).
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// The grid bin's dynamic shared memory: `egrids` E grids of nx + 1 values of
// `itemsize` bytes and *copies charge grids of 2 nx values (deposit_lanes'
// two halves), the most copies of 8, 4, 2, 1 that fit in kGridSmemMax; 0
// bytes (and one copy, in the device buffer) when not even one fits
// (ops/substep_kernels.grid_smem mirrors it).
inline int grid_smem(int nx, int itemsize, int egrids, int* copies) {
  for (int c = kWarps; c >= 1; c /= 2) {
    const long long bytes = (static_cast<long long>(egrids) * (nx + 1) +
                             static_cast<long long>(c) * 2 * nx) * itemsize;
    if (bytes <= kGridSmemMax) {
      *copies = c;
      return static_cast<int>(bytes);
    }
  }
  *copies = 1;
  return 0;
}

// The E grids a substep's grid-bin kernel has room for: E_g, and in
// substep 2 E_g0, which it forms where it rebuilds v1.  The room is kept in
// every layout, so that both nonlinear delta-f layouts share their charge
// grids and grid, and so their bits.
template <int SUB>
__host__ __device__ constexpr int egrids() {
  return SUB == 2 ? 2 : 1;
}

namespace {

// Storage type -> arithmetic type in registers, and back on a store.  A
// bfloat16 store rounds to nearest even.
template <typename T>
__device__ __forceinline__ T upcast(T v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename S, typename T>
__device__ __forceinline__ S to_storage(T v) {
  if constexpr (std::is_same<S, T>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// W elements of type S as one load or store of W * sizeof(S) bytes.
template <int Bytes>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// kNc: through the read-only path (streams nothing in the kernel writes)
template <int W, bool kNc, typename S>
__device__ __forceinline__ void load_vec(S (&dst)[W], const S* src) {
  using R = typename Raw<W * sizeof(S)>::type;
  const R* r = reinterpret_cast<const R*>(src);
  *reinterpret_cast<R*>(dst) = kNc ? __ldg(r) : *r;
}

template <int W, typename S>
__device__ __forceinline__ void store_vec(S* dst, const S (&src)[W]) {
  using R = typename Raw<W * sizeof(S)>::type;
  *reinterpret_cast<R*>(dst) = *reinterpret_cast<const R*>(src);
}

// What a launch is given besides the constants: the marker streams (those
// the layout does not touch may be null), the modes (re0, im0: the
// step-start modes of substep 2 where it rebuilds v1), the species table,
// the grid bin's device buffer, the partials, projections and counter of
// the final sum, the solve's factor and output (modes null: no solve), and
// the angle table.
template <typename T, typename PT, typename WT>
struct Args {
  T* x;
  T* v;
  const PT* p;
  T* w;
  WT* w1;
  T* v1;
  const T* re;
  const T* im;
  const T* re0;
  const T* im0;
  const T* species;      // (nspecies, kSpeciesFields); read above kMaxSpecies
  T* grids;              // (grid, egrids (nx + 1) + 2 nx): the grid bin's grids
                         // where they do not fit in shared memory, else null
  T* partials;           // (grid, 2, nmode)
  T* proj;               // (2, nmode)
  const T* g;            // (nmode,) grad_inv / lx
  T* modes;              // (2, nmode): mode_re, mode_im; null: no solve
  unsigned int* done;    // blocks finished; 0 between launches
  const Pair<T>* angles;  // (nmode, nx) pairs in device memory
  int angle_smem;        // dynamic shared memory bytes: the register bins'
                         // staged table (0: read in place), the grid bin's
                         // grids (0: in `grids`)
  int aligned;           // every stream 16-byte aligned
};

// V markers' stream values in registers; a layout loads and stores only
// the members it uses.
template <typename T, typename PT, typename WT, int W>
struct Group {
  alignas(W * sizeof(T)) T x[W];
  alignas(W * sizeof(T)) T v[W];
  alignas(W * sizeof(PT)) PT p[W];
  alignas(W * sizeof(T)) T w[W];
  alignas(W * sizeof(WT)) WT w1[W];
  alignas(W * sizeof(T)) T v1[W];
};

// The register bins' copies of the mode components.
template <typename T, int NM>
struct Modes {
  T re[NM], im[NM], re0[NM], im0[NM];
};

// The table, in shared memory when the launch gave it angle_smem bytes (a
// multiple of 16, from a 16-byte aligned table padded to it), else in place.
// Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ const Pair<T>* stage_angles(const Pair<T>* angles,
                                                       int angle_smem) {
  extern __shared__ __align__(128) unsigned char angle_buf[];
  __shared__ uint64_t angle_bar;
  if (angle_smem == 0) return angles;
  if (threadIdx.x == 0) {
    mbar_init(&angle_bar, 1);
    fence_mbarrier_init();
    mbar_arrive_expect_tx(&angle_bar, static_cast<uint32_t>(angle_smem));
    bulk_load(angle_buf, angles, static_cast<uint32_t>(angle_smem), &angle_bar);
  }
  __syncthreads();
  while (!mbar_try_wait(&angle_bar, 0)) {
  }
  return reinterpret_cast<const Pair<T>*>(angle_buf);
}

// E at the marker: 2 sum_m (C_m re_m - S_m im_m).
template <typename T, int NM>
__device__ __forceinline__ T gather_e(const T (&C)[NM], const T (&S)[NM],
                                      const T (&re)[NM], const T (&im)[NM]) {
  T e = T(0);
#pragma unroll
  for (int j = 0; j < NM; ++j) e += C[j] * re[j] - S[j] * im[j];
  return T(2) * e;
}

template <typename T, int NM>
__device__ __forceinline__ void load_modes(const Params<T>& p, const T* re_in,
                                           const T* im_in, T (&re)[NM],
                                           T (&im)[NM]) {
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    re[j] = j < p.nmode ? re_in[j] : T(0);
    im[j] = j < p.nmode ? im_in[j] : T(0);
  }
}

// E at x from the register copies of the modes (re, im) and the constants
// in q.
template <typename T, int NM>
__device__ __forceinline__ T field_at(const Params<T>& q, const Pair<T>* ang, T x,
                                      const T (&re)[NM], const T (&im)[NM]) {
  T C[NM], S[NM];
  hat_table(q, ang, x, C, S);
  return gather_e(C, S, re, im);
}

// Adds val (C_m, S_m) at x to the bin's sums.
template <typename T, int NM>
__device__ __forceinline__ void deposit_at(const Params<T>& q, const Pair<T>* ang, T x, T val,
                                           T (&acc_c)[NM], T (&acc_s)[NM]) {
  T C[NM], S[NM];
  hat_table(q, ang, x, C, S);
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    acc_c[j] += val * C[j];
    acc_s[j] += val * S[j];
  }
}

__device__ __forceinline__ float neg_mul(float a, float b) { return __fmul_rn(-a, b); }
__device__ __forceinline__ double neg_mul(double a, double b) { return __dmul_rn(-a, b); }

// The solve of component c of a (2, nmode) projection row (c < nmode: p_c of
// mode c, else p_s of mode c - nmode) from its stored value:
// mode_im = -p_c g, mode_re = -p_s g (ops/spectral.solve_modes).
template <typename T>
__device__ __forceinline__ void store_mode(int nmode, const T* g, T* modes, int c, T proj) {
  const bool cosine = c < nmode;
  const int k = cosine ? c : c - nmode;
  modes[(cosine ? nmode : 0) + k] = neg_mul(proj, g[k]);
}

// Deterministic block sum of the threads' sums of the NM modes (those below
// nmode), written into a row of 2 nmode values [cos_0 .. cos_{nmode-1},
// sin_0 .. sin_{nmode-1}]; where modes is not null, their solve too
// (store_mode).  Every thread of the block must call it.
template <typename T, int NM>
__device__ __forceinline__ void block_sum_store(const Params<T>& p,
                                                const T (&acc_c)[NM],
                                                const T (&acc_s)[NM], T* out,
                                                const T* g = nullptr,
                                                T* modes = nullptr) {
  __shared__ T red[kWarps][2 * NM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    T c = acc_c[j];
    T s = acc_s[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, off);
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      red[warp][j] = c;
      red[warp][NM + j] = s;
    }
  }
  __syncthreads();
  const int cnt = min(NM, p.nmode);
  const int t = threadIdx.x;
  if (t < 2 * cnt) {
    const bool cosine = t < cnt;
    const int k = cosine ? t : t - cnt;
    T sum = T(0);
    for (int w = 0; w < kWarps; ++w) sum += red[w][cosine ? k : NM + k];
    const int c = (cosine ? 0 : p.nmode) + k;
    out[c] = sum;
    if (modes != nullptr) store_mode(p.nmode, g, modes, c, sum);
  }
  __syncthreads();
}

// A block's partials row and the launch's block count: the species loop's
// grid is (bps, ns), its rows species by species; the main path's is 1D.
template <bool kSpecies>
__device__ __forceinline__ unsigned block_row() {
  if constexpr (kSpecies)
    return blockIdx.y * gridDim.x + blockIdx.x;
  else
    return blockIdx.x;
}

template <bool kSpecies>
__device__ __forceinline__ unsigned grid_blocks() {
  if constexpr (kSpecies)
    return gridDim.x * gridDim.y;
  else
    return gridDim.x;
}

// After this block's partials row is written: the last block to finish sums
// the rows into the projections (and their modes, where a.modes is set)
// and sets the counter back to 0.  Every thread of the block must call it.
template <typename T, typename PT, typename WT, int NM, bool kSpecies>
__device__ __forceinline__ void finish(const Params<T>& p, const Args<T, PT, WT>& a) {
  __shared__ bool last;
  const int m = 2 * p.nmode;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.done, 1u) == grid_blocks<kSpecies>() - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  T acc_c[NM], acc_s[NM];
#pragma unroll
  for (int k = 0; k < NM; ++k) acc_c[k] = acc_s[k] = T(0);
  for (int b = threadIdx.x; b < static_cast<int>(grid_blocks<kSpecies>()); b += kThreads) {
    const T* row = a.partials + static_cast<long long>(b) * m;
#pragma unroll
    for (int k = 0; k < NM; ++k) {
      if (k < p.nmode) {
        acc_c[k] += __ldcg(row + k);
        acc_s[k] += __ldcg(row + p.nmode + k);
      }
    }
  }
  block_sum_store(p, acc_c, acc_s, a.proj, a.g, a.modes);
  if (threadIdx.x == 0) *a.done = 0u;
}

// The streams of substep SUB in layout L for W markers from element i.
// Substep 2 overwrites x, v and w, so those are read by plain loads.
template <int SUB, int L, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void load_group(Group<T, PT, WT, W>& g,
                                           const Args<T, PT, WT>& a, long long i) {
  constexpr bool kNc = SUB == 1;
  load_vec<W, kNc>(g.x, a.x + i);
  load_vec<W, kNc>(g.v, a.v + i);
  load_vec<W, true>(g.p, a.p + i);
  if constexpr (L != kFullf) load_vec<W, kNc>(g.w, a.w + i);
  if constexpr (SUB == 2 && L != kFullf) load_vec<W, true>(g.w1, a.w1 + i);
  if constexpr (SUB == 2 && L == kNonlinear) load_vec<W, true>(g.v1, a.v1 + i);
}

template <int SUB, int L, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void store_group(const Group<T, PT, WT, W>& g,
                                            const Args<T, PT, WT>& a, long long i) {
  if constexpr (SUB == 1) {
    if constexpr (L != kFullf) store_vec<W>(a.w1 + i, g.w1);
    if constexpr (L == kNonlinear) store_vec<W>(a.v1 + i, g.v1);
  } else {
    store_vec<W>(a.x + i, g.x);
    if constexpr (L != kLinear) store_vec<W>(a.v + i, g.v);
    if constexpr (L != kFullf) store_vec<W>(a.w + i, g.w);
  }
}

// Substep 1 on W markers: gather E at x0 from the step-start modes, push by
// dt/2 in the reference's order x, w, v, and deposit charge * w1 (full-f:
// charge * p) at x1.  w1 and v1 go to the group (then to fresh buffers:
// substep 2 still reads w0 and v0); the deposit uses w1 before it is rounded
// to WT.
template <int L, bool kSpecies, int NM, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void push1(const Params<T>& q, const Pair<T>* ang,
                                      const Modes<T, NM>& md, Group<T, PT, WT, W>& g,
                                      T (&acc_c)[NM], T (&acc_s)[NM]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T x = g.x[k], v = g.v[k], pp = upcast(g.p[k]), w = L == kFullf ? T(0) : g.w[k];
    const T e = field_at(q, ang, x, md.re, md.im);
    const T x1 = wrap(q, x + q.dt_half * v);
    const T w1 = w + q.dtqm_half * (L == kLinear ? pp * e : (pp - w) * e) *
                         minus_dlnf0_dv<T, kSpecies>(q, v);
    g.w1[k] = to_storage<WT>(w1);
    g.v1[k] = v + q.dtqm_half * e;
    deposit_at(q, ang, x1, q.charge * (L == kFullf ? pp : w1), acc_c, acc_s);
  }
}

// Substep 2 on W markers: recompute x1 = wrap(x0 + dt/2 v0) in registers,
// take v1 by the layout (streamed; rebuilt from the step-start modes at x0
// by substep 1's own expression; or v0), gather E at x1 from the midpoint
// modes, push by the full dt from the step-start values, and deposit
// charge * w2 (full-f: charge * p) at x2.  x2, v2 and w2 replace x0, v0 and
// w0 in the group.
template <int L, bool kSpecies, int NM, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void push2(const Params<T>& q, const Pair<T>* ang,
                                      const Modes<T, NM>& md, Group<T, PT, WT, W>& g,
                                      T (&acc_c)[NM], T (&acc_s)[NM]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T x0 = g.x[k], v0 = g.v[k], pp = upcast(g.p[k]),
            w0 = L == kFullf ? T(0) : g.w[k];
    const T w1 = L == kFullf ? T(0) : upcast(g.w1[k]);
    T v1 = v0;
    if constexpr (L == kNonlinear) {
      v1 = g.v1[k];
    } else if constexpr (L == kFullf || L == kRecompute) {
      v1 = v0 + q.dtqm_half * field_at(q, ang, x0, md.re0, md.im0);
    }
    const T x1 = wrap(q, x0 + q.dt_half * v0);
    const T e = field_at(q, ang, x1, md.re, md.im);
    const T x2 = wrap(q, x0 + q.dt * v1);
    const T w2 = w0 + q.dtqm_full * (L == kLinear ? pp * e : (pp - w1) * e) *
                          minus_dlnf0_dv<T, kSpecies>(q, v1);
    g.x[k] = x2;
    g.v[k] = v0 + q.dtqm_full * e;
    g.w[k] = w2;
    deposit_at(q, ang, x2, q.charge * (L == kFullf ? pp : w2), acc_c, acc_s);
  }
}

template <int SUB, int L, bool kSpecies, int NM, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void push(const Params<T>& q, const Pair<T>* ang,
                                     const Modes<T, NM>& md, Group<T, PT, WT, W>& g,
                                     T (&acc_c)[NM], T (&acc_s)[NM]) {
  if constexpr (SUB == 1)
    push1<L, kSpecies>(q, ang, md, g, acc_c, acc_s);
  else
    push2<L, kSpecies>(q, ang, md, g, acc_c, acc_s);
}

// The markers [base, base + n) of one species, whose constants q holds, as
// block blockIdx.x of the gridDim.x that walk it: single markers up to the
// first V-aligned element and after the last whole group (every marker when
// a stream is not 16-byte aligned), V-marker groups between them, each
// group's loads all issued before its arithmetic.
template <int SUB, int L, bool kSpecies, int NM, typename T, typename PT, typename WT>
__device__ __forceinline__ void walk(const Params<T>& q, const Pair<T>* ang,
                                     const Args<T, PT, WT>& a, const Modes<T, NM>& md,
                                     T (&acc_c)[NM], T (&acc_s)[NM], long long base) {
  constexpr int V = vec_width<T>();
  const long long n = q.n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long head = a.aligned ? min(n, (V - base % V) % V) : n;
  const long long groups = (n - head) / V;
  const long long body = base + head;
  auto one = [&](long long i) {
    Group<T, PT, WT, 1> g;
    load_group<SUB, L>(g, a, i);
    push<SUB, L, kSpecies>(q, ang, md, g, acc_c, acc_s);
    store_group<SUB, L>(g, a, i);
  };
  for (long long t = first; t < head; t += stride) one(base + t);
  for (long long t = head + groups * V + first; t < n; t += stride) one(base + t);
  for (long long k = first; k < groups; k += stride) {
    Group<T, PT, WT, V> g;
    load_group<SUB, L>(g, a, body + k * V);
    push<SUB, L, kSpecies>(q, ang, md, g, acc_c, acc_s);
    store_group<SUB, L>(g, a, body + k * V);
  }
}

// The register bins' body for both substeps: stage the table, walk the
// markers (in the species loop, those of the block's species), write this
// block's sums to its partials row, then finish the projection sum.
template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__device__ __forceinline__ void substep_body(const Params<T>& p, const Args<T, PT, WT>& a,
                                             const SpeciesTable<T>& tab) {
  const Pair<T>* ang = stage_angles<T>(a.angles, a.angle_smem);
  Modes<T, NM> md;
  load_modes(p, a.re, a.im, md.re, md.im);
  if constexpr (SUB == 2 && (L == kFullf || L == kRecompute))
    load_modes(p, a.re0, a.im0, md.re0, md.im0);
  T acc_c[NM], acc_s[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  if constexpr (kSpecies) {
    for (int s = blockIdx.y; s < tab.ns; s += gridDim.y)
      walk<SUB, L, kSpecies>(with_species(p, tab, a.species, s), ang, a, md, acc_c, acc_s,
                             s * p.n);
  } else {
    walk<SUB, L, kSpecies>(p, ang, a, md, acc_c, acc_s, 0);
  }
  block_sum_store(p, acc_c, acc_s,
                  a.partials + static_cast<long long>(block_row<kSpecies>()) * 2 * p.nmode);
  finish<T, PT, WT, NM, kSpecies>(p, a);
}

// ---- the grid bin ----

// Where a block's grids are and how its warps share them: eg (and eg0) of
// nx + 1 values, this warp's charge grid (2 nx values) and 64 values of
// staging, and the turn (phase of phases) in which this warp deposits.
template <typename T>
struct GridRefs {
  const T* eg;
  const T* eg0;
  T* rho;
  T* stage;
  int phase, phases;
};

// Deposits val with the hat weights at the cell and fraction of each of the
// warp's W markers per lane ((1 - f) val at the cell, f val at the next:
// one deposit_lanes a marker), on lanes where `on`; the warps that share a
// charge grid take their turns between __syncthreads.  Every thread of the
// block must call it.
template <int W, typename T>
__device__ __forceinline__ void deposit_group(const GridRefs<T>& r, int nx, const int (&cell)[W],
                                              const T (&frac)[W], const T (&val)[W], bool on) {
  for (int ph = 0; ph < r.phases; ++ph) {
    if (ph == r.phase) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        deposit_lanes(r.rho, nx, r.stage, on ? cell[k] : -1, val[k] * (T(1) - frac[k]),
                      val[k] * frac[k]);
    }
    if (r.phases > 1) __syncthreads();
  }
}

// push1 and push2 in the grid form: E from the E grids by grid_gather, the
// deposit onto the warp's charge grid.  Substep 1's v1 and substep 2's rebuilt
// v1 are the same FMA of the same gather from equal grids, so the same bits.
template <int SUB, int L, bool kSpecies, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void grid_push(const Params<T>& q, const GridRefs<T>& r,
                                          Group<T, PT, WT, W>& g, bool on) {
  int cell[W];
  T frac[W], val[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T x0 = g.x[k], v0 = g.v[k], pp = upcast(g.p[k]),
            w0 = L == kFullf ? T(0) : g.w[k];
    T f0;
    int c0;
    hat_cell(q, x0, &f0, &c0);
    const T x1 = wrap(q, x0 + q.dt_half * v0);
    if constexpr (SUB == 1) {
      const T e = grid_gather(r.eg, c0, f0);
      const T w1 = w0 + q.dtqm_half * (L == kLinear ? pp * e : (pp - w0) * e) *
                            minus_dlnf0_dv<T, kSpecies>(q, v0);
      g.w1[k] = to_storage<WT>(w1);
      g.v1[k] = fma_t(q.dtqm_half, e, v0);
      hat_cell(q, x1, &frac[k], &cell[k]);
      val[k] = q.charge * (L == kFullf ? pp : w1);
    } else {
      const T w1 = L == kFullf ? T(0) : upcast(g.w1[k]);
      T v1 = v0;
      if constexpr (L == kNonlinear) {
        v1 = g.v1[k];
      } else if constexpr (L == kFullf || L == kRecompute) {
        v1 = fma_t(q.dtqm_half, grid_gather(r.eg0, c0, f0), v0);
      }
      T f1;
      int c1;
      hat_cell(q, x1, &f1, &c1);
      const T e = grid_gather(r.eg, c1, f1);
      const T x2 = wrap(q, x0 + q.dt * v1);
      const T w2 = w0 + q.dtqm_full * (L == kLinear ? pp * e : (pp - w1) * e) *
                            minus_dlnf0_dv<T, kSpecies>(q, v1);
      g.x[k] = x2;
      g.v[k] = v0 + q.dtqm_full * e;
      g.w[k] = w2;
      hat_cell(q, x2, &frac[k], &cell[k]);
      val[k] = q.charge * (L == kFullf ? pp : w2);
    }
  }
  deposit_group(r, q.nx, cell, frac, val, on);
}

// walk in the grid form: the same markers in the same groups, but every
// loop runs as often in each thread of the block (a thread past the end
// takes zeros, deposits nothing and stores nothing), so that the lanes of a
// warp deposit together and the warps that share a charge grid can take turns.
template <int SUB, int L, bool kSpecies, typename T, typename PT, typename WT>
__device__ __forceinline__ void grid_walk(const Params<T>& q, const Args<T, PT, WT>& a,
                                          const GridRefs<T>& r, long long base) {
  constexpr int V = vec_width<T>();
  const long long n = q.n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads;
  const long long head = a.aligned ? min(n, (V - base % V) % V) : n;
  const long long groups = (n - head) / V;
  const long long body = base + head;
  auto one = [&](long long t, long long end) {
    Group<T, PT, WT, 1> g{};
    const bool on = t < end;
    if (on) load_group<SUB, L>(g, a, base + t);
    grid_push<SUB, L, kSpecies>(q, r, g, on);
    if (on) store_group<SUB, L>(g, a, base + t);
  };
  for (long long t = start; t < head; t += stride) one(t + threadIdx.x, head);
  for (long long t = head + groups * V + start; t < n; t += stride) one(t + threadIdx.x, n);
  for (long long k0 = start; k0 < groups; k0 += stride) {
    const long long k = k0 + threadIdx.x;
    const bool on = k < groups;
    Group<T, PT, WT, V> g{};
    if (on) load_group<SUB, L>(g, a, body + k * V);
    grid_push<SUB, L, kSpecies>(q, r, g, on);
    if (on) store_group<SUB, L>(g, a, body + k * V);
  }
}

// The block's projections of its charge grid rho onto the kept modes, into
// its partials row: warp w takes modes w, w + kWarps, ...; its lanes sum
// rho_j (cos, sin) th_mj over cells lane, lane + 32, ... in cell order
// (coalesced table reads), then a fixed shuffle tree sums the lanes.
template <typename T>
__device__ __forceinline__ void project_grid(const Params<T>& p, const Pair<T>* ang,
                                             const T* rho, T* row) {
  const int nm = p.nmode, nx = p.nx, lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < nm; m += kWarps) {
    const Pair<T>* tab = ang + static_cast<long long>(m) * nx;
    T c = T(0), s = T(0);
#pragma unroll 8
    for (int j = lane; j < nx; j += 32) {
      const Pair<T> e = __ldg(tab + j);
      c = fma_t(rho[j], e.x, c);
      s = fma_t(rho[j], e.y, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, off);
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      row[m] = c;
      row[nm + m] = s;
    }
  }
}

// The grid bin's end: the last block to finish sums the partials rows into
// the projections, 32 of the 2 nmode components a pass: lane l takes
// component c0 + l, warp w rows w, w + kWarps, ... in order (coalesced
// reads), then the warps are summed in order (red: kThreads values), and
// where a.modes is set each component's solve (store_mode); it sets the
// counter back to 0.  Every thread of the block must call it.
template <bool kSpecies, typename T, typename PT, typename WT>
__device__ __forceinline__ void grid_finish(const Params<T>& p, const Args<T, PT, WT>& a,
                                            T* red) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.done, 1u) == grid_blocks<kSpecies>() - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int m2 = 2 * p.nmode, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < m2; c0 += 32) {
    const int k = c0 + lane;
    T s = T(0);
    if (k < m2) {
#pragma unroll 16
      for (int b = warp; b < static_cast<int>(grid_blocks<kSpecies>()); b += kWarps)
        s += __ldcg(a.partials + static_cast<long long>(b) * m2 + k);
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (warp == 0 && k < m2) {
      T sum = T(0);
      for (int w = 0; w < kWarps; ++w) sum += red[32 * w + lane];
      a.proj[k] = sum;
      if (a.modes != nullptr) store_mode(p.nmode, a.g, a.modes, k, sum);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.done = 0u;
}

// The grid bin's body on its grids at g (shared memory or the block's slice
// of Args::grids): eg, [eg0,] then `copies` charge grids of 2 nx values.
// Build the E grids and zero the charge grids; walk the block's species;
// sum the copies in order, rho[j] + rho[nx + j - 1] of each, into the
// first's rho[0, nx); project it into the partials row; finish.
template <int SUB, typename T, typename PT, typename WT, int L, bool kSpecies>
__device__ __forceinline__ void grid_run(const Params<T>& p, const Args<T, PT, WT>& a,
                                         const SpeciesTable<T>& tab, T* g, int copies,
                                         T* red) {
  constexpr bool kTwo = SUB == 2 && (L == kFullf || L == kRecompute);
  const int nx = p.nx;
  T* eg = g;
  T* eg0 = g + (nx + 1);
  T* rho = g + egrids<SUB>() * (nx + 1);
  for (int j = threadIdx.x; j < nx; j += kThreads) {
    const T e = grid_e(a.angles, nx, p.nmode, j, a.re, a.im);
    eg[j] = e;
    if (j == 0) eg[nx] = e;
    if constexpr (kTwo) {
      const T e0 = grid_e(a.angles, nx, p.nmode, j, a.re0, a.im0);
      eg0[j] = e0;
      if (j == 0) eg0[nx] = e0;
    }
  }
  for (int i = threadIdx.x; i < copies * 2 * nx; i += kThreads) rho[i] = T(0);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const GridRefs<T> r{eg, eg0, rho + (warp % copies) * 2 * nx, red + 64 * warp, warp / copies,
                      kWarps / copies};
  if constexpr (kSpecies) {
    for (int s = blockIdx.y; s < tab.ns; s += gridDim.y)
      grid_walk<SUB, L, kSpecies>(with_species(p, tab, a.species, s), a, r, s * p.n);
  } else {
    grid_walk<SUB, L, kSpecies>(p, a, r, 0);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nx; j += kThreads) {
    const int left = j == 0 ? nx - 1 : j - 1;
    T sum = rho[j] + rho[nx + left];
    for (int c = 1; c < copies; ++c) sum += rho[2 * c * nx + j] + rho[(2 * c + 1) * nx + left];
    rho[j] = sum;
  }
  __syncthreads();
  project_grid(p, a.angles, rho,
               a.partials + static_cast<long long>(block_row<kSpecies>()) * 2 * p.nmode);
  grid_finish<kSpecies>(p, a, red);
}

// The grid bin's body for both substeps: its grids in dynamic shared memory
// (angle_smem bytes, copies from grid_smem's rule), or in the block's slice
// of Args::grids with one charge grid.  Each branch inlines grid_run with
// pointers of one memory space.
template <int SUB, typename T, typename PT, typename WT, int L, bool kSpecies>
__device__ __forceinline__ void grid_body(const Params<T>& p, const Args<T, PT, WT>& a,
                                          const SpeciesTable<T>& tab) {
  extern __shared__ __align__(128) unsigned char angle_buf[];
  __shared__ T red[2 * kThreads];
  const int nx = p.nx;
  const int eg = egrids<SUB>() * (nx + 1);
  if (a.angle_smem > 0) {
    const int copies = (a.angle_smem / static_cast<int>(sizeof(T)) - eg) / (2 * nx);
    grid_run<SUB, T, PT, WT, L, kSpecies>(p, a, tab, reinterpret_cast<T*>(angle_buf), copies,
                                          red);
  } else {
    grid_run<SUB, T, PT, WT, L, kSpecies>(
        p, a, tab, a.grids + static_cast<long long>(block_row<kSpecies>()) * (eg + 2 * nx), 1,
        red);
  }
}

// Substep 1 (reads x0, v0, p, w0 and the step-start modes; writes w1, v1
// where the layout streams them, and the projections at x1).  PT and WT are
// the storage types of p and w1 (T, or bfloat16 with T float).
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies, bool kGrid>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kGrid>))
substep1_kernel(const Params<T> p, const Args<T, PT, WT> a, const SpeciesTable<T> tab) {
  if constexpr (kGrid)
    grid_body<1, T, PT, WT, L, kSpecies>(p, a, tab);
  else
    substep_body<1, T, PT, WT, NM, L, kSpecies>(p, a, tab);
}

// Substep 2 (reads x0, v0, p, w0, w1, v1 and the midpoint modes, and the
// step-start modes where it rebuilds v1; writes x2, v2, w2 over x0, v0, w0
// where the layout updates them, and the projections at x2).
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies, bool kGrid>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kGrid>))
substep2_kernel(const Params<T> p, const Args<T, PT, WT> a, const SpeciesTable<T> tab) {
  if constexpr (kGrid)
    grid_body<2, T, PT, WT, L, kSpecies>(p, a, tab);
  else
    substep_body<2, T, PT, WT, NM, L, kSpecies>(p, a, tab);
}

// The device's grid-angle trig chain (hat_trig's) on its own, for the
// accuracy check against float64 (chip_smoke.py); not on the simulation's
// path.
__global__ void grid_angle_kernel(const int* __restrict__ k, int nx, long long n,
                                  float* __restrict__ c, float* __restrict__ s) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) grid_angle(k[i], nx, &s[i], &c[i]);
}

// Entries idx[i] of the angle table as the substep kernels read them (staged
// into shared memory when angle_smem > 0), into out[i]; checks only.
template <typename T>
__global__ void angle_gather_kernel(const Pair<T>* angles, int angle_smem,
                                    const int* __restrict__ idx, long long n,
                                    Pair<T>* __restrict__ out) {
  const Pair<T>* ang = stage_angles<T>(angles, angle_smem);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = ang[idx[i]];
}

template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies,
          bool kGrid>
auto kernel_of() {
  if constexpr (SUB == 1)
    return substep1_kernel<T, PT, WT, NM, L, kSpecies, kGrid>;
  else
    return substep2_kernel<T, PT, WT, NM, L, kSpecies, kGrid>;
}

template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies,
          bool kGrid>
void launch(const HostParams& h, const Args<T, PT, WT>& a, int grid, cudaStream_t st) {
  const auto kernel = kernel_of<SUB, T, PT, WT, NM, L, kSpecies, kGrid>();
  // the species loop: grid / ns blocks for each species (block_row)
  const dim3 blocks = kSpecies ? dim3(grid / h.nspecies, h.nspecies) : dim3(grid);
  kernel<<<blocks, kThreads, a.angle_smem, st>>>(to_params<T>(h), a, to_species<T>(h));
}

// The species mode of a register bin: the main path's kernel for nonlinear
// delta-f (v1 streamed or rebuilt) with one bump-on-tail or Maxwellian
// species, the species loop otherwise.
template <int SUB, typename T, typename PT, typename WT, int NM, int L>
void launch_species(const HostParams& h, const Args<T, PT, WT>& a, int grid,
                    cudaStream_t st) {
  if constexpr (L == kNonlinear || L == kRecompute) {
    if (h.nspecies == 1 && h.sp_kform[0] <= 1)
      return launch<SUB, T, PT, WT, NM, L, false, false>(h, a, grid, st);
  }
  launch<SUB, T, PT, WT, NM, L, true, false>(h, a, grid, st);
}

// The grid bin (species loop only): its grids' shared memory by grid_smem,
// opted in above 48 KB once per device (at the first launch, which the
// wrapper's callers make outside any graph capture), else the device buffer.
template <int SUB, typename T, typename PT, typename WT, int L>
int launch_grid_bin(const HostParams& h, Args<T, PT, WT> a, int grid, cudaStream_t st) {
  static unsigned long long opted_in = 0;   // one bit per device
  int copies = 0;
  a.angle_smem = grid_smem(h.nx, static_cast<int>(sizeof(T)), egrids<SUB>(), &copies);
  if (a.angle_smem == 0 && a.grids == nullptr) return cudaErrorInvalidValue;
  if (a.angle_smem > kSmemNoOptIn) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !(opted_in >> dev & 1ull)) {
      e = cudaFuncSetAttribute(kernel_of<SUB, T, PT, WT, 0, L, true, true>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kGridSmemMax);
      if (e != cudaSuccess) return e;
      if (dev < 64) opted_in |= 1ull << dev;
    }
  }
  launch<SUB, T, PT, WT, 0, L, true, true>(h, a, grid, st);
  return cudaSuccess;
}

// The bin of kept modes: the register bins keep NM sums per thread, so NM
// is a template parameter; a run uses the smallest that holds its nmode,
// and above 4 modes the grid bin (kGridBin).  -1 below 1.
constexpr int kGridBin = 0;
constexpr int mode_bin(int nmode) {
  return nmode == 1 ? 1 : nmode < 1 ? -1 : nmode <= 4 ? 4 : kGridBin;
}

// grid_bin != 0 takes the grid bin at any nmode (the bin line's probe).
template <int SUB, typename T, typename PT, typename WT, int L>
int launch_modes(const HostParams& h, const Args<T, PT, WT>& a, int grid, cudaStream_t st,
                 int grid_bin) {
  switch (grid_bin ? kGridBin : mode_bin(h.nmode)) {
    case 1:
      launch_species<SUB, T, PT, WT, 1, L>(h, a, grid, st);
      return cudaSuccess;
    case 4:
      launch_species<SUB, T, PT, WT, 4, L>(h, a, grid, st);
      return cudaSuccess;
    default:
      return launch_grid_bin<SUB, T, PT, WT, L>(h, a, grid, st);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Check the launch (the species loop's block count must be a multiple of
// ns: its grid is (grid / ns, ns)), note whether every stream is 16-byte
// aligned, and launch the layout's instantiation (full-f only where p is
// stored at T).
template <int SUB, typename T, typename PT, typename WT>
int substep(const HostParams* h, int layout, Args<T, PT, WT> a, int grid, int grid_bin,
            void* stream) {
  if (grid <= 0 || mode_bin(h->nmode) < 0 || h->nspecies < 1 ||
      h->nspecies > kMaxGridSpecies || grid % h->nspecies != 0 ||
      (h->nspecies > kMaxSpecies && a.species == nullptr) || a.angle_smem < 0 ||
      a.angle_smem > kAngleSmemMax || a.angle_smem % 16 != 0 || !aligned16(a.angles) ||
      a.partials == nullptr || a.proj == nullptr || a.done == nullptr ||
      (a.modes != nullptr && a.g == nullptr))
    return cudaErrorInvalidValue;
  a.aligned = aligned16(a.x) && aligned16(a.v) && aligned16(a.p) && aligned16(a.w) &&
              aligned16(a.w1) && aligned16(a.v1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (layout == kNonlinear) {
    rc = launch_modes<SUB, T, PT, WT, kNonlinear>(*h, a, grid, st, grid_bin);
  } else if (layout == kRecompute) {
    rc = launch_modes<SUB, T, PT, WT, kRecompute>(*h, a, grid, st, grid_bin);
  } else if (layout == kLinear) {
    rc = launch_modes<SUB, T, PT, WT, kLinear>(*h, a, grid, st, grid_bin);
  } else if constexpr (std::is_same<T, PT>::value) {
    if (layout != kFullf) return cudaErrorInvalidValue;
    rc = launch_modes<SUB, T, PT, WT, kFullf>(*h, a, grid, st, grid_bin);
  } else {
    return cudaErrorInvalidValue;
  }
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

template <typename T>
int angle_gather(const void* angles, int angle_smem, const int* idx, long long n, void* out,
                 void* stream) {
  if (angle_smem < 0 || angle_smem > kAngleSmemMax || angle_smem % 16 != 0 ||
      !aligned16(angles))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  angle_gather_kernel<T><<<64, kThreads, angle_smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Pair<T>*>(angles), angle_smem, idx, n, static_cast<Pair<T>*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pic1dp_max_modes() { return kMaxModes; }

int pic1dp_max_species() { return kMaxSpecies; }

int pic1dp_species_fields() { return kSpeciesFields; }

int pic1dp_params_size() { return static_cast<int>(sizeof(HostParams)); }

int pic1dp_angle_smem_max() { return kAngleSmemMax; }

int pic1dp_grid_smem_max() { return kGridSmemMax; }

// The bin of nmode kept modes (mode_bin; ops/substep_kernels.mode_bin
// mirrors it).
int pic1dp_mode_bin(int nmode) { return mode_bin(nmode); }

// The grid bin's dynamic shared memory bytes and rho copies (grid_smem).
int pic1dp_grid_smem(int nx, int itemsize, int egrids, int* copies) {
  return grid_smem(nx, itemsize, egrids, copies);
}

// V of the instantiation that runs nmode kept modes with arithmetic of
// `itemsize` bytes (4 or 8); 0 for a count below 1.
int pic1dp_vector_width(int nmode, int itemsize) {
  if (mode_bin(nmode) < 0) return 0;
  if (itemsize == 4) return vec_width<float>();
  if (itemsize == 8) return vec_width<double>();
  return 0;
}

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One pair of entry points per (arithmetic, storage of p and w1) build: f32,
// f64, and f32 with bfloat16 p and w1 (bf16_weights).  `layout` is enum
// Layout; a stream the layout does not touch may be null.  species is the
// (nspecies, kSpeciesFields) table at the arithmetic type (null where the
// run has at most kMaxSpecies species); grids the grid bin's device buffer
// of grid (egrids (nx + 1) + 2 nx) values (null unless grid_smem gives 0
// bytes); partials holds (grid, 2, nmode) values, proj (2, nmode); g is the
// (nmode,) factor grad_inv / lx and modes the (2, nmode) modes the last
// block solves (both may be null: no solve); done is
// an int that is 0 and is left 0; angles is the (nmode, nx) table of
// (cos, sin) pairs, 16-byte aligned and padded to angle_smem bytes when
// angle_smem > 0; grid_bin != 0 takes the grid bin at any nmode (probes
// only).
#define PIC1DP_SUBSTEPS(SUFFIX, T, PT, WT)                                                \
  int pic1dp_substep1_##SUFFIX(const HostParams* h, int layout, const void* x,            \
                               const void* v, const void* pw, const void* w,              \
                               const void* mre, const void* mim, const void* species,     \
                               void* grids, void* w1, void* v1, void* partials,           \
                               void* proj, const void* g, void* modes, void* done,        \
                               const void* angles, int angle_smem, int grid,              \
                               int grid_bin, void* stream) {                              \
    const Args<T, PT, WT> a{const_cast<T*>(static_cast<const T*>(x)),                     \
                            const_cast<T*>(static_cast<const T*>(v)),                     \
                            static_cast<const PT*>(pw),                                   \
                            const_cast<T*>(static_cast<const T*>(w)),                     \
                            static_cast<WT*>(w1),                                         \
                            static_cast<T*>(v1),                                          \
                            static_cast<const T*>(mre),                                   \
                            static_cast<const T*>(mim),                                   \
                            nullptr,                                                      \
                            nullptr,                                                      \
                            static_cast<const T*>(species),                               \
                            static_cast<T*>(grids),                                       \
                            static_cast<T*>(partials),                                    \
                            static_cast<T*>(proj),                                        \
                            static_cast<const T*>(g),                                     \
                            static_cast<T*>(modes),                                       \
                            static_cast<unsigned int*>(done),                             \
                            static_cast<const Pair<T>*>(angles),                          \
                            angle_smem,                                                   \
                            0};                                                           \
    return substep<1>(h, layout, a, grid, grid_bin, stream);                              \
  }                                                                                       \
  int pic1dp_substep2_##SUFFIX(const HostParams* h, int layout, void* x, void* v,         \
                               const void* pw, void* w, const void* w1, const void* v1,   \
                               const void* mre, const void* mim, const void* mre0,        \
                               const void* mim0, const void* species, void* grids,        \
                               void* partials, void* proj, const void* g, void* modes,    \
                               void* done, const void* angles, int angle_smem, int grid,  \
                               int grid_bin, void* stream) {                              \
    const Args<T, PT, WT> a{static_cast<T*>(x),                                           \
                            static_cast<T*>(v),                                           \
                            static_cast<const PT*>(pw),                                   \
                            static_cast<T*>(w),                                           \
                            const_cast<WT*>(static_cast<const WT*>(w1)),                  \
                            const_cast<T*>(static_cast<const T*>(v1)),                    \
                            static_cast<const T*>(mre),                                   \
                            static_cast<const T*>(mim),                                   \
                            static_cast<const T*>(mre0),                                  \
                            static_cast<const T*>(mim0),                                  \
                            static_cast<const T*>(species),                               \
                            static_cast<T*>(grids),                                       \
                            static_cast<T*>(partials),                                    \
                            static_cast<T*>(proj),                                        \
                            static_cast<const T*>(g),                                     \
                            static_cast<T*>(modes),                                       \
                            static_cast<unsigned int*>(done),                             \
                            static_cast<const Pair<T>*>(angles),                          \
                            angle_smem,                                                   \
                            0};                                                           \
    return substep<2>(h, layout, a, grid, grid_bin, stream);                              \
  }

PIC1DP_SUBSTEPS(f32, float, float, float)
PIC1DP_SUBSTEPS(f64, double, double, double)
PIC1DP_SUBSTEPS(f32_bf16, float, __nv_bfloat16, __nv_bfloat16)

#undef PIC1DP_SUBSTEPS

int pic1dp_grid_angle_f32(const int* k, int nx, long long n, float* c, float* s,
                          void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  grid_angle_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(k, nx, n, c, s);
  return cudaGetLastError();
}

int pic1dp_angle_gather_f32(const void* angles, int angle_smem, const int* idx,
                            long long n, void* out, void* stream) {
  return angle_gather<float>(angles, angle_smem, idx, n, out, stream);
}

int pic1dp_angle_gather_f64(const void* angles, int angle_smem, const int* idx,
                            long long n, void* out, void* stream) {
  return angle_gather<double>(angles, angle_smem, idx, n, out, stream);
}

}  // extern "C"
