// Fused RK2 substep kernels of the matrix-free spectral step, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (pic1dp_tpu_torch/ops/substep_kernels.py).
//
// They replace the TPU kernel built by make_substep_call in
// pic1dp_tpu/ops/pallas_kernels.py (:395-730): substep 1 is
// make_substep_call(cfg, 1, n) (body :558-591) and substep 2 is
// make_substep_call(cfg, 2, n) (body :592-622), each with the mode-projection
// deposit of :624-643, with separate streams, up to kMaxModes kept modes
// (each evaluated directly, no angle-addition recurrence), float and double.
// One body per substep serves every layout of the TPU kernel (:499-508), the
// template parameter L:
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
//
// and both species modes, the template parameter kSpecies:
//
//   false  the main path's kernel: one species and the bump-on-tail or
//          Maxwellian drive (forms 0 and 1 of minus_dlnf0_dv; core
//          fractions 0 and 1 included), nonlinear delta-f only;
//   true   the port of pallas_kernels._make_sel (:71-89): the state is
//          (ns, n) and contiguous, so species s is the slice [s n, (s + 1) n).
//          Each thread walks the species in order, and within one species the
//          same positions as for one species: the species loop is outside the
//          marker loop, so no marker pays for a 64-bit division.  Each
//          species' constants (dt q/m, charge, the -f0'/f0 form and its
//          constants) are selected once per species (with_species), and every
//          form is compiled in, the two-stream drives and the mixed-degenerate
//          clamp included.  At most kMaxSpecies species.
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
//     double for the NM <= 4 bins, 1 at NM = 16, where the per-mode sums
//     already fill the registers.  Loading the next iteration's group before
//     the current one's arithmetic was measured slower: it took the main
//     path's kernels to 58-80 registers, fewer blocks fit on an SM than the
//     grid has, and the last wave ran short.  Without it they use 40-64
//     registers and every block of the grid is resident.  A species slice
//     whose start is not V-aligned (s n with n not a multiple of V), or a
//     stream that is not 16-byte aligned, is walked with single-marker
//     iterations at its head and ragged tail (or entirely).
//   * A grid sized to the work and the projection sum in the kernel.  The
//     wrapper launches min(B * SMs, ceil(markers / (256 V))) blocks.  Hopper
//     blocks run in no order, so each block reduces its threads' sums (over
//     every species, in order) with warp shuffles and shared memory in a
//     fixed tree and writes one (2, nmode) row of a (grid, 2, nmode)
//     partials buffer; the last block to finish (a __threadfence and an
//     atomicAdd on an int counter) sums the rows, thread t taking rows t,
//     t + 256, ... in order, then the same fixed tree, writes the (2, nmode)
//     projections and sets the counter back to 0 for the next launch or
//     graph replay.  There are no float atomics, so with a fixed grid the sum
//     is the same from run to run.
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
// kernels' static shared memory (the block sum, the mbarrier, the last-block
// flag) stays within kStaticSmem, and the angle table may have the rest.
constexpr int kSmemNoOptIn = 48 * 1024;
constexpr int kStaticSmem = 4096;
constexpr int kAngleSmemMax = kSmemNoOptIn - kStaticSmem;
static_assert(kWarps * 2 * kMaxModes * sizeof(double) + 64 <= kStaticSmem,
              "the block sum outgrew kStaticSmem");

// The layouts; ops/substep_kernels.py passes these ints.
enum Layout { kNonlinear = 0, kLinear = 1, kFullf = 2 };

// Markers per thread and iteration in the NM-mode bin
// (ops/substep_kernels.vector_width mirrors it).
template <typename T, int NM>
__host__ __device__ constexpr int vec_width() {
  return NM > 4 ? 1 : 16 / static_cast<int>(sizeof(T));
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
// step-start modes of full-f substep 2), the partials, projections and
// counter of the final sum, and the angle table.
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
  T* partials;           // (grid, 2, nmode)
  T* proj;               // (2, nmode)
  unsigned int* done;    // blocks finished; 0 between launches
  const Pair<T>* angles;  // (nmode, nx) pairs in device memory
  int angle_smem;        // bytes copied to shared memory, 0: read in place
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

// Deterministic block sum of the threads' projection sums, written as
// out[0 .. 2 nmode) = [cos_0 .. cos_{nmode-1}, sin_0 .. sin_{nmode-1}].
// Every thread of the block must call it.
template <typename T, int NM>
__device__ __forceinline__ void block_sum_store(const Params<T>& p,
                                                const T (&acc_c)[NM],
                                                const T (&acc_s)[NM], T* out) {
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
  const int t = threadIdx.x;
  if (t < 2 * p.nmode) {
    const int j = t < p.nmode ? t : NM + (t - p.nmode);
    T sum = T(0);
    for (int w = 0; w < kWarps; ++w) sum += red[w][j];
    out[t] = sum;
  }
}

// This block's row of partials; the last block to finish sums the rows into
// the projections and sets the counter back to 0.  Every thread of the
// block must call it.
template <typename T, typename PT, typename WT, int NM>
__device__ __forceinline__ void finish(const Params<T>& p, T (&acc_c)[NM], T (&acc_s)[NM],
                                       const Args<T, PT, WT>& a) {
  __shared__ bool last;
  const int m = 2 * p.nmode;
  block_sum_store(p, acc_c, acc_s, a.partials + static_cast<long long>(blockIdx.x) * m);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const T* row = a.partials + static_cast<long long>(b) * m;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      if (j < p.nmode) {
        acc_c[j] += __ldcg(row + j);
        acc_s[j] += __ldcg(row + p.nmode + j);
      }
    }
  }
  block_sum_store(p, acc_c, acc_s, a.proj);
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

template <int NM, typename T>
__device__ __forceinline__ void deposit(T val, const T (&C)[NM], const T (&S)[NM],
                                        T (&acc_c)[NM], T (&acc_s)[NM]) {
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    acc_c[j] += val * C[j];
    acc_s[j] += val * S[j];
  }
}

// Substep 1 on W markers: gather E at x0 from the step-start modes, push by
// dt/2 in the reference's order x, w, v, and deposit charge * w1 (full-f:
// charge * p) at x1.  w1 and v1 go to the group (then to fresh buffers:
// substep 2 still reads w0 and v0); the deposit uses w1 before it is
// rounded to WT.
template <int L, bool kSpecies, int NM, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void push1(const Params<T>& q, const Pair<T>* ang,
                                      const Modes<T, NM>& md, Group<T, PT, WT, W>& g,
                                      T (&acc_c)[NM], T (&acc_s)[NM]) {
  T C[NM], S[NM];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T x = g.x[k], v = g.v[k], pp = upcast(g.p[k]), w = L == kFullf ? T(0) : g.w[k];
    hat_table(q, ang, x, C, S);
    const T e = gather_e(C, S, md.re, md.im);
    const T x1 = wrap(q, x + q.dt_half * v);
    const T w1 = w + q.dtqm_half * (L == kLinear ? pp * e : (pp - w) * e) *
                         minus_dlnf0_dv<T, kSpecies>(q, v);
    g.w1[k] = to_storage<WT>(w1);
    g.v1[k] = v + q.dtqm_half * e;
    hat_table(q, ang, x1, C, S);
    deposit(q.charge * (L == kFullf ? pp : w1), C, S, acc_c, acc_s);
  }
}

// Substep 2 on W markers: recompute x1 = wrap(x0 + dt/2 v0) in registers,
// take v1 by the layout (streamed, rebuilt from the step-start modes at x0,
// or v0), gather E at x1 from the midpoint modes, push by the full dt from
// the step-start values, and deposit charge * w2 (full-f: charge * p) at x2.
// x2, v2 and w2 replace x0, v0 and w0 in the group.
template <int L, bool kSpecies, int NM, int W, typename T, typename PT, typename WT>
__device__ __forceinline__ void push2(const Params<T>& q, const Pair<T>* ang,
                                      const Modes<T, NM>& md, Group<T, PT, WT, W>& g,
                                      T (&acc_c)[NM], T (&acc_s)[NM]) {
  T C[NM], S[NM];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T x0 = g.x[k], v0 = g.v[k], pp = upcast(g.p[k]),
            w0 = L == kFullf ? T(0) : g.w[k];
    const T w1 = L == kFullf ? T(0) : upcast(g.w1[k]);
    T v1 = v0;
    if constexpr (L == kNonlinear) {
      v1 = g.v1[k];
    } else if constexpr (L == kFullf) {
      hat_table(q, ang, x0, C, S);
      v1 = v0 + q.dtqm_half * gather_e(C, S, md.re0, md.im0);
    }
    const T x1 = wrap(q, x0 + q.dt_half * v0);
    hat_table(q, ang, x1, C, S);
    const T e = gather_e(C, S, md.re, md.im);
    const T x2 = wrap(q, x0 + q.dt * v1);
    const T w2 = w0 + q.dtqm_full * (L == kLinear ? pp * e : (pp - w1) * e) *
                          minus_dlnf0_dv<T, kSpecies>(q, v1);
    g.x[k] = x2;
    g.v[k] = v0 + q.dtqm_full * e;
    g.w[k] = w2;
    hat_table(q, ang, x2, C, S);
    deposit(q.charge * (L == kFullf ? pp : w2), C, S, acc_c, acc_s);
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

// The markers [base, base + n) of one species, whose constants q holds:
// single markers up to the first V-aligned element and after the last whole
// group (every marker when a stream is not 16-byte aligned), V-marker groups
// between them, each group's loads all issued before its arithmetic.  Thread
// positions stride by the whole grid.
template <int SUB, int L, bool kSpecies, int NM, typename T, typename PT, typename WT>
__device__ __forceinline__ void walk(const Params<T>& q, const Pair<T>* ang,
                                     const Args<T, PT, WT>& a, const Modes<T, NM>& md,
                                     T (&acc_c)[NM], T (&acc_s)[NM], long long base) {
  constexpr int V = vec_width<T, NM>();
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

// One body for both substeps: stage the table, walk every species in order,
// and finish the projection sum.
template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__device__ __forceinline__ void substep_body(const Params<T>& p, const Args<T, PT, WT>& a,
                                             const SpeciesTable<T>& tab) {
  const Pair<T>* ang = stage_angles<T>(a.angles, a.angle_smem);
  Modes<T, NM> md;
  load_modes(p, a.re, a.im, md.re, md.im);
  if constexpr (SUB == 2 && L == kFullf) load_modes(p, a.re0, a.im0, md.re0, md.im0);
  T acc_c[NM], acc_s[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  if constexpr (kSpecies) {
    for (int s = 0; s < tab.ns; ++s)
      walk<SUB, L, kSpecies>(with_species(p, tab, s), ang, a, md, acc_c, acc_s, s * p.n);
  } else {
    walk<SUB, L, kSpecies>(p, ang, a, md, acc_c, acc_s, 0);
  }
  finish(p, acc_c, acc_s, a);
}

// Substep 1 (reads x0, v0, p, w0 and the step-start modes; writes w1, v1
// and the projections at x1).  PT and WT are the storage types of p and w1
// (T, or bfloat16 with T float).
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__global__ void __launch_bounds__(kThreads)
substep1_kernel(const Params<T> p, const Args<T, PT, WT> a, const SpeciesTable<T> tab) {
  substep_body<1, T, PT, WT, NM, L, kSpecies>(p, a, tab);
}

// Substep 2 (reads x0, v0, p, w0, w1, v1 and the midpoint modes; writes x2,
// v2, w2 over x0, v0, w0 where the layout updates them, and the projections
// at x2).
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__global__ void __launch_bounds__(kThreads)
substep2_kernel(const Params<T> p, const Args<T, PT, WT> a, const SpeciesTable<T> tab) {
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

template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
void launch(const HostParams& h, const Args<T, PT, WT>& a, int grid, cudaStream_t st) {
  if constexpr (SUB == 1)
    substep1_kernel<T, PT, WT, NM, L, kSpecies><<<grid, kThreads, a.angle_smem, st>>>(
        to_params<T>(h), a, to_species<T>(h));
  else
    substep2_kernel<T, PT, WT, NM, L, kSpecies><<<grid, kThreads, a.angle_smem, st>>>(
        to_params<T>(h), a, to_species<T>(h));
}

// The species mode: the main path's kernel for nonlinear delta-f with one
// bump-on-tail or Maxwellian species, the species loop otherwise.
template <int SUB, typename T, typename PT, typename WT, int NM, int L>
void launch_species(const HostParams& h, const Args<T, PT, WT>& a, int grid,
                    cudaStream_t st) {
  if constexpr (L == kNonlinear) {
    if (h.nspecies == 1 && h.sp_kform[0] <= 1)
      return launch<SUB, T, PT, WT, NM, L, false>(h, a, grid, st);
  }
  launch<SUB, T, PT, WT, NM, L, true>(h, a, grid, st);
}

// The bin of kept modes: the kernels keep NM sums per thread in registers, so
// NM is a template parameter; a run uses the smallest bin that holds its
// nmode.  -1 outside [1, kMaxModes].
constexpr int mode_bin(int nmode) {
  return nmode == 1 ? 1 : nmode < 1 ? -1 : nmode <= 4 ? 4 : nmode <= kMaxModes ? kMaxModes : -1;
}

template <int SUB, typename T, typename PT, typename WT, int L>
void launch_modes(const HostParams& h, const Args<T, PT, WT>& a, int grid,
                  cudaStream_t st) {
  switch (mode_bin(h.nmode)) {
    case 1:
      return launch_species<SUB, T, PT, WT, 1, L>(h, a, grid, st);
    case 4:
      return launch_species<SUB, T, PT, WT, 4, L>(h, a, grid, st);
    default:
      return launch_species<SUB, T, PT, WT, kMaxModes, L>(h, a, grid, st);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Check the launch, note whether every stream is 16-byte aligned, and launch
// the layout's instantiation (full-f only where p is stored at T).
template <int SUB, typename T, typename PT, typename WT>
int substep(const HostParams* h, int layout, Args<T, PT, WT> a, int grid, void* stream) {
  if (grid <= 0 || mode_bin(h->nmode) < 0 || h->nspecies < 1 ||
      h->nspecies > kMaxSpecies || a.angle_smem < 0 || a.angle_smem > kAngleSmemMax ||
      a.angle_smem % 16 != 0 || !aligned16(a.angles) || a.partials == nullptr ||
      a.proj == nullptr || a.done == nullptr)
    return cudaErrorInvalidValue;
  a.aligned = aligned16(a.x) && aligned16(a.v) && aligned16(a.p) && aligned16(a.w) &&
              aligned16(a.w1) && aligned16(a.v1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kNonlinear) {
    launch_modes<SUB, T, PT, WT, kNonlinear>(*h, a, grid, st);
  } else if (layout == kLinear) {
    launch_modes<SUB, T, PT, WT, kLinear>(*h, a, grid, st);
  } else if constexpr (std::is_same<T, PT>::value) {
    if (layout != kFullf) return cudaErrorInvalidValue;
    launch_modes<SUB, T, PT, WT, kFullf>(*h, a, grid, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

int pic1dp_params_size() { return static_cast<int>(sizeof(HostParams)); }

int pic1dp_angle_smem_max() { return kAngleSmemMax; }

// V of the instantiation that runs nmode kept modes with arithmetic of
// `itemsize` bytes (4 or 8); 0 for a count outside the bins.
int pic1dp_vector_width(int nmode, int itemsize) {
  const int bin = mode_bin(nmode);
  if (bin < 0) return 0;
  const bool wide = bin > 4;
  if (itemsize == 4) return wide ? vec_width<float, kMaxModes>() : vec_width<float, 4>();
  if (itemsize == 8) return wide ? vec_width<double, kMaxModes>() : vec_width<double, 4>();
  return 0;
}

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One pair of entry points per (arithmetic, storage of p and w1) build: f32,
// f64, and f32 with bfloat16 p and w1 (bf16_weights).  `layout` is enum
// Layout; a stream the layout does not touch may be null.  partials holds
// (grid, 2, nmode) values, proj (2, nmode); done is an int that is 0 and is
// left 0; angles is the (nmode, nx) table of (cos, sin) pairs, 16-byte
// aligned and padded to angle_smem bytes when angle_smem > 0.
#define PIC1DP_SUBSTEPS(SUFFIX, T, PT, WT)                                                \
  int pic1dp_substep1_##SUFFIX(const HostParams* h, int layout, const void* x,            \
                               const void* v, const void* pw, const void* w,              \
                               const void* mre, const void* mim, void* w1, void* v1,      \
                               void* partials, void* proj, void* done,                    \
                               const void* angles, int angle_smem, int grid,              \
                               void* stream) {                                            \
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
                            static_cast<T*>(partials),                                    \
                            static_cast<T*>(proj),                                        \
                            static_cast<unsigned int*>(done),                             \
                            static_cast<const Pair<T>*>(angles),                          \
                            angle_smem,                                                   \
                            0};                                                           \
    return substep<1>(h, layout, a, grid, stream);                                        \
  }                                                                                       \
  int pic1dp_substep2_##SUFFIX(const HostParams* h, int layout, void* x, void* v,         \
                               const void* pw, void* w, const void* w1, const void* v1,   \
                               const void* mre, const void* mim, const void* mre0,        \
                               const void* mim0, void* partials, void* proj, void* done,  \
                               const void* angles, int angle_smem, int grid,              \
                               void* stream) {                                            \
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
                            static_cast<T*>(partials),                                    \
                            static_cast<T*>(proj),                                        \
                            static_cast<unsigned int*>(done),                             \
                            static_cast<const Pair<T>*>(angles),                          \
                            angle_smem,                                                   \
                            0};                                                           \
    return substep<2>(h, layout, a, grid, stream);                                        \
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
