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
//          same grid-stride positions as for one species: the species loop is
//          outside the marker loop, so no marker pays for a 64-bit division.
//          Each species' constants (dt q/m, charge, the -f0'/f0 form and its
//          constants) are selected once per species (with_species), and every
//          form is compiled in, the two-stream drives and the mixed-degenerate
//          clamp included.  At most kMaxSpecies species.
//
// The kSpecies = false instantiations are the only ones a nonlinear run with
// one bump-on-tail or Maxwellian species launches, so the species loop costs
// the main path nothing.
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
// 20.  Against that they do about 30 + 30 * nmode flops and 2 * nmode + 1
// transcendentals per marker and substep (pallas_kernels.py:697-702): some
// 2.5 flops per byte for one mode, far below the H100's ~20 f32 flops per
// byte of HBM bandwidth.  So the design keeps every intermediate in
// registers (one thread per marker, no shared-memory staging), reads and
// writes each stream once with neighbouring threads on neighbouring
// addresses, and reduces the projections only once per block at the end.
// Trig is one sincospi per mode and position, after an exact integer
// reduction of the grid angle; the TPU's quadrant polynomials existed only
// because Mosaic's sin/cos were slow.  The constants and the per-marker
// device functions (hat_trig, wrap, minus_dlnf0_dv, with_species) live in
// substep_math.cuh, which the probe kernels of stream_probes.cu time too.
//
// The projection sum: a TPU grid runs in order and carries the sum in one
// VMEM tile; Hopper blocks run in no order.  Each block reduces its threads'
// sums (over every species, in order) with warp shuffles and shared memory in
// a fixed tree and writes one (2, nmode) row of a (grid, 2, nmode) partials
// buffer, which the wrapper sums over the grid.  There are no float atomics,
// so with a fixed grid the sum is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "substep_math.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The layouts; ops/substep_kernels.py passes these ints.
enum Layout { kNonlinear = 0, kLinear = 1, kFullf = 2 };

namespace {

// Storage type -> arithmetic type in registers, and back on a store.  A
// bfloat16 store rounds to nearest even.
template <typename T>
__device__ __forceinline__ T upcast(T v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ void store(T* dst, T v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
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

// Deterministic block sum of the threads' projection sums, written as this
// block's row [cos_0 .. cos_{nmode-1}, sin_0 .. sin_{nmode-1}] of the
// partials buffer.  Every thread of the block must call it.
template <typename T, int NM>
__device__ __forceinline__ void block_sum_store(const Params<T>& p,
                                                const T (&acc_c)[NM],
                                                const T (&acc_s)[NM],
                                                T* __restrict__ partials) {
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
    partials[static_cast<long long>(blockIdx.x) * 2 * p.nmode + t] = sum;
  }
}

// Substep 1: gather E at x0 from the step-start modes, push by dt/2 in the
// reference's order x, w, v, and deposit charge * w1 (full-f: charge * p) at
// x1.  w1 and v1 go to fresh buffers: substep 2 still reads w0 and v0.  PT
// and WT are the storage types of p and w1 (T, or bfloat16 with T float);
// the deposit uses w1 before it is rounded to WT.  Streams the layout does
// not touch are not read or written (their pointers may be null); tab is read
// only with kSpecies.
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__global__ void __launch_bounds__(kThreads)
substep1_kernel(const Params<T> p, const T* __restrict__ x0,
                const T* __restrict__ v0, const PT* __restrict__ pw,
                const T* __restrict__ w0, const T* __restrict__ mode_re,
                const T* __restrict__ mode_im, WT* __restrict__ w1_out,
                T* __restrict__ v1_out, T* __restrict__ partials,
                const SpeciesTable<T> tab) {
  T re[NM], im[NM], acc_c[NM], acc_s[NM], C[NM], S[NM];
  load_modes(p, mode_re, mode_im, re, im);
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the markers [base, base + n) of one species, whose constants q holds
  auto markers = [&](const Params<T>& q, long long base) {
    for (long long i = base + first; i < base + p.n; i += stride) {
      const T x = x0[i], v = v0[i], pp = upcast(pw[i]), w = L == kFullf ? T(0) : w0[i];
      hat_trig(q, x, C, S);
      const T e = gather_e(C, S, re, im);
      const T x1 = wrap(q, x + q.dt_half * v);
      const T w1 = w + q.dtqm_half * (L == kLinear ? pp * e : (pp - w) * e) *
                           minus_dlnf0_dv<T, kSpecies>(q, v);
      const T v1 = v + q.dtqm_half * e;
      if constexpr (L != kFullf) store(&w1_out[i], w1);
      if constexpr (L == kNonlinear) v1_out[i] = v1;
      hat_trig(q, x1, C, S);
      const T val = q.charge * (L == kFullf ? pp : w1);
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        acc_c[j] += val * C[j];
        acc_s[j] += val * S[j];
      }
    }
  };
  if constexpr (kSpecies) {
    for (int s = 0; s < tab.ns; ++s) markers(with_species(p, tab, s), s * p.n);
  } else {
    markers(p, 0);
  }
  block_sum_store(p, acc_c, acc_s, partials);
}

// Substep 2: recompute x1 = wrap(x0 + dt/2 v0) in registers, take v1 by the
// layout (streamed, rebuilt from the step-start modes at x0, or v0), gather
// E at x1 from the midpoint modes, push by the full dt from the step-start
// values, and deposit charge * w2 (full-f: charge * p) at x2.  x, v and w are
// updated IN PLACE where the layout updates them (x2 over x0, v2 over v0, w2
// over w0).  That is safe because each thread reads its own element of each
// stream before it writes it, and no thread touches another's element; so
// those three pointers are not __restrict__.  p and w1 are read at their
// storage types PT and WT.
template <typename T, typename PT, typename WT, int NM, int L, bool kSpecies>
__global__ void __launch_bounds__(kThreads)
substep2_kernel(const Params<T> p, T* x, T* v, const PT* __restrict__ pw, T* w,
                const WT* __restrict__ w1_in, const T* __restrict__ v1_in,
                const T* __restrict__ mode_re, const T* __restrict__ mode_im,
                T* __restrict__ partials, const T* __restrict__ mode_re0,
                const T* __restrict__ mode_im0, const SpeciesTable<T> tab) {
  T re[NM], im[NM], acc_c[NM], acc_s[NM], C[NM], S[NM];
  T re0[L == kFullf ? NM : 1], im0[L == kFullf ? NM : 1];
  load_modes(p, mode_re, mode_im, re, im);
  if constexpr (L == kFullf) load_modes(p, mode_re0, mode_im0, re0, im0);
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  auto markers = [&](const Params<T>& q, long long base) {
    for (long long i = base + first; i < base + p.n; i += stride) {
      const T x0 = x[i], v0 = v[i], pp = upcast(pw[i]), w0 = L == kFullf ? T(0) : w[i];
      const T w1 = L == kFullf ? T(0) : upcast(w1_in[i]);
      T v1 = v0;
      if constexpr (L == kNonlinear) {
        v1 = v1_in[i];
      } else if constexpr (L == kFullf) {
        hat_trig(q, x0, C, S);
        v1 = v0 + q.dtqm_half * gather_e(C, S, re0, im0);
      }
      const T x1 = wrap(q, x0 + q.dt_half * v0);
      hat_trig(q, x1, C, S);
      const T e = gather_e(C, S, re, im);
      const T x2 = wrap(q, x0 + q.dt * v1);
      const T w2 = w0 + q.dtqm_full * (L == kLinear ? pp * e : (pp - w1) * e) *
                            minus_dlnf0_dv<T, kSpecies>(q, v1);
      const T v2 = v0 + q.dtqm_full * e;
      x[i] = x2;
      if constexpr (L != kLinear) v[i] = v2;
      if constexpr (L != kFullf) w[i] = w2;
      hat_trig(q, x2, C, S);
      const T val = q.charge * (L == kFullf ? pp : w2);
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        acc_c[j] += val * C[j];
        acc_s[j] += val * S[j];
      }
    }
  };
  if constexpr (kSpecies) {
    for (int s = 0; s < tab.ns; ++s) markers(with_species(p, tab, s), s * p.n);
  } else {
    markers(p, 0);
  }
  block_sum_store(p, acc_c, acc_s, partials);
}

// The device's grid-angle trig on its own, for the accuracy check against
// float64 (chip_smoke.py); not on the simulation's path.
__global__ void grid_angle_kernel(const int* __restrict__ k, int nx, long long n,
                                  float* __restrict__ c, float* __restrict__ s) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) grid_angle(k[i], nx, &s[i], &c[i]);
}

// One launch of substep SUB with the typed stream pointers `a` (in the
// kernel's order, between Params and the step-start modes or the table).
template <int SUB, typename T, typename PT, typename WT, int NM, int L, bool kSpecies,
          typename... A>
void launch(const HostParams& h, int grid, cudaStream_t st, A... a) {
  if constexpr (SUB == 1)
    substep1_kernel<T, PT, WT, NM, L, kSpecies><<<grid, kThreads, 0, st>>>(
        to_params<T>(h), a..., to_species<T>(h));
  else
    substep2_kernel<T, PT, WT, NM, L, kSpecies><<<grid, kThreads, 0, st>>>(
        to_params<T>(h), a..., to_species<T>(h));
}

// The species mode: the main path's kernel for nonlinear delta-f with one
// bump-on-tail or Maxwellian species, the species loop otherwise.
template <int SUB, typename T, typename PT, typename WT, int NM, int L, typename... A>
void launch_species(const HostParams& h, int grid, cudaStream_t st, A... a) {
  if constexpr (L == kNonlinear) {
    if (h.nspecies == 1 && h.sp_kform[0] <= 1)
      return launch<SUB, T, PT, WT, NM, L, false>(h, grid, st, a...);
  }
  launch<SUB, T, PT, WT, NM, L, true>(h, grid, st, a...);
}

// Mode-count bins: the kernels keep NM sums per thread in registers, so NM is
// a template parameter; a run uses the smallest bin that holds its nmode.
template <int SUB, typename T, typename PT, typename WT, int L, typename... A>
void launch_modes(const HostParams& h, int grid, cudaStream_t st, A... a) {
  if (h.nmode == 1)
    launch_species<SUB, T, PT, WT, 1, L>(h, grid, st, a...);
  else if (h.nmode <= 4)
    launch_species<SUB, T, PT, WT, 4, L>(h, grid, st, a...);
  else
    launch_species<SUB, T, PT, WT, kMaxModes, L>(h, grid, st, a...);
}

// The layout, a run-time argument of the entry points, picks its
// instantiation; full-f only where p is stored at T.
template <int SUB, typename T, typename PT, typename WT, typename... A>
int substep(const HostParams* h, int layout, int grid, void* stream, A... a) {
  if (grid <= 0 || h->nmode < 1 || h->nmode > kMaxModes || h->nspecies < 1 ||
      h->nspecies > kMaxSpecies)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kNonlinear) {
    launch_modes<SUB, T, PT, WT, kNonlinear>(*h, grid, st, a...);
  } else if (layout == kLinear) {
    launch_modes<SUB, T, PT, WT, kLinear>(*h, grid, st, a...);
  } else if constexpr (std::is_same<T, PT>::value) {
    if (layout != kFullf) return cudaErrorInvalidValue;
    launch_modes<SUB, T, PT, WT, kFullf>(*h, grid, st, a...);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pic1dp_max_modes() { return kMaxModes; }

int pic1dp_max_species() { return kMaxSpecies; }

int pic1dp_params_size() { return static_cast<int>(sizeof(HostParams)); }

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One pair of entry points per (arithmetic, storage of p and w1) build: f32,
// f64, and f32 with bfloat16 p and w1 (bf16_weights).  `layout` is enum
// Layout; a stream the layout does not touch may be null.
#define PIC1DP_SUBSTEPS(SUFFIX, T, PT, WT)                                             \
  int pic1dp_substep1_##SUFFIX(const HostParams* h, int layout, const void* x,         \
                               const void* v, const void* pw, const void* w,           \
                               const void* mre, const void* mim, void* w1, void* v1,   \
                               void* partials, int grid, void* stream) {               \
    return substep<1, T, PT, WT>(                                                      \
        h, layout, grid, stream, static_cast<const T*>(x), static_cast<const T*>(v),   \
        static_cast<const PT*>(pw), static_cast<const T*>(w),                          \
        static_cast<const T*>(mre), static_cast<const T*>(mim), static_cast<WT*>(w1),  \
        static_cast<T*>(v1), static_cast<T*>(partials));                               \
  }                                                                                    \
  int pic1dp_substep2_##SUFFIX(const HostParams* h, int layout, void* x, void* v,      \
                               const void* pw, void* w, const void* w1, const void* v1, \
                               const void* mre, const void* mim, void* partials,       \
                               const void* mre0, const void* mim0, int grid,           \
                               void* stream) {                                         \
    return substep<2, T, PT, WT>(                                                      \
        h, layout, grid, stream, static_cast<T*>(x), static_cast<T*>(v),               \
        static_cast<const PT*>(pw), static_cast<T*>(w), static_cast<const WT*>(w1),    \
        static_cast<const T*>(v1), static_cast<const T*>(mre),                         \
        static_cast<const T*>(mim), static_cast<T*>(partials),                         \
        static_cast<const T*>(mre0), static_cast<const T*>(mim0));                     \
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

}  // extern "C"
