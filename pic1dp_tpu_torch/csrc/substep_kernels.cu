// Fused RK2 substep kernels of the matrix-free spectral step, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (pic1dp_tpu_torch/ops/substep_kernels.py).
//
// They replace the TPU kernel built by make_substep_call in
// pic1dp_tpu/ops/pallas_kernels.py: substep 1 is make_substep_call(cfg, 1, n)
// (body :558-591) and substep 2 is make_substep_call(cfg, 2, n) (body
// :592-622), each with the mode-projection deposit of :624-643, in the
// stream_v1 layout with separate streams.  Covered variants: nonlinear
// delta-f, one species, up to kMaxModes kept modes (each evaluated directly,
// no angle-addition recurrence), the BUMP_ON_TAIL and MAXWELLIAN equilibria
// (bump-on-tail core fractions 0 and 1 included), float and double, and
// bf16_weights: float arithmetic with p stored and w1 streamed as bfloat16
// (pallas_kernels.py:453-475, :555, :586, :610).  The wrapper raises for
// anything else.
//
// bf16_weights: p and w1 are upcast in registers; substep 1 stores w1
// rounded to nearest even (__float2bfloat16_rn, the same rounding as
// .astype(bfloat16)) and deposits the UNROUNDED w1 (:565-567, :629); v1 and
// the x, v, w state stay float.
//
// What bounds them on this card: memory traffic.  Per marker, substep 1 reads
// x0, v0, p, w0 and writes w1, v1 (6 values, 24 bytes in f32, 20 with
// bf16_weights); substep 2 reads x0, v0, p, w0, w1, v1 and writes x2, v2, w2
// (9 values, 36 bytes in f32, 32 with bf16_weights).
// Against that they do about 30 + 30 * nmode flops and 2 * nmode + 1
// transcendentals per marker and substep (pallas_kernels.py:697-702): some
// 2.5 flops per byte for one mode, far below the H100's ~20 f32 flops per
// byte of HBM bandwidth.  So this first design keeps every intermediate in
// registers (one thread per marker, no shared-memory staging), reads and
// writes each stream once with neighbouring threads on neighbouring
// addresses, and reduces the projections only once per block at the end.
// Trig is one sincospi per mode and position, after an exact integer
// reduction of the grid angle; the TPU's quadrant polynomials existed only
// because Mosaic's sin/cos were slow.  The constants and the per-marker
// device functions (hat_trig, wrap, minus_dlnf0_dv) live in
// substep_math.cuh, which the probe kernels of stream_probes.cu time too.
//
// The projection sum: a TPU grid runs in order and carries the sum in one
// VMEM tile; Hopper blocks run in no order.  Each block reduces its threads'
// sums with warp shuffles and shared memory in a fixed tree and writes one
// (2, nmode) row of a (grid, 2, nmode) partials buffer, which the wrapper
// sums over the grid.  There are no float atomics, so with a fixed grid the
// sum is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "substep_math.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
// reference's order x, w, v, and deposit charge * w1 at x1.  w1 and v1 go to
// fresh buffers: substep 2 still reads w0 and v0.  PT and WT are the storage
// types of p and w1 (T, or bfloat16 with T float); the deposit uses w1 before
// it is rounded to WT.
template <typename T, typename PT, typename WT, int NM>
__global__ void __launch_bounds__(kThreads)
substep1_kernel(const Params<T> p, const T* __restrict__ x0,
                const T* __restrict__ v0, const PT* __restrict__ pw,
                const T* __restrict__ w0, const T* __restrict__ mode_re,
                const T* __restrict__ mode_im, WT* __restrict__ w1_out,
                T* __restrict__ v1_out, T* __restrict__ partials) {
  T re[NM], im[NM], acc_c[NM], acc_s[NM], C[NM], S[NM];
  load_modes(p, mode_re, mode_im, re, im);
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    const T x = x0[i], v = v0[i], pp = upcast(pw[i]), w = w0[i];
    hat_trig(p, x, C, S);
    const T e = gather_e(C, S, re, im);
    const T x1 = wrap(p, x + p.dt_half * v);
    const T w1 = w + p.dtqm_half * ((pp - w) * e) * minus_dlnf0_dv(p, v);
    const T v1 = v + p.dtqm_half * e;
    store(&w1_out[i], w1);
    v1_out[i] = v1;
    hat_trig(p, x1, C, S);
    const T val = p.charge * w1;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      acc_c[j] += val * C[j];
      acc_s[j] += val * S[j];
    }
  }
  block_sum_store(p, acc_c, acc_s, partials);
}

// Substep 2: recompute x1 = wrap(x0 + dt/2 v0) in registers, gather E at x1
// from the midpoint modes, push by the full dt from the step-start values
// with the midpoint v1 and w1, and deposit charge * w2 at x2.  x, v and w are
// updated IN PLACE (x2 over x0, v2 over v0, w2 over w0).  That is safe
// because each thread reads its own element of each stream before it writes
// it, and no thread touches another's element; so those three pointers are
// not __restrict__.  p and w1 are read at their storage types PT and WT.
template <typename T, typename PT, typename WT, int NM>
__global__ void __launch_bounds__(kThreads)
substep2_kernel(const Params<T> p, T* x, T* v, const PT* __restrict__ pw, T* w,
                const WT* __restrict__ w1_in, const T* __restrict__ v1_in,
                const T* __restrict__ mode_re, const T* __restrict__ mode_im,
                T* __restrict__ partials) {
  T re[NM], im[NM], acc_c[NM], acc_s[NM], C[NM], S[NM];
  load_modes(p, mode_re, mode_im, re, im);
#pragma unroll
  for (int j = 0; j < NM; ++j) acc_c[j] = acc_s[j] = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    const T x0 = x[i], v0 = v[i], pp = upcast(pw[i]), w0 = w[i];
    const T w1 = upcast(w1_in[i]), v1 = v1_in[i];
    const T x1 = wrap(p, x0 + p.dt_half * v0);
    hat_trig(p, x1, C, S);
    const T e = gather_e(C, S, re, im);
    const T x2 = wrap(p, x0 + p.dt * v1);
    const T w2 = w0 + p.dtqm_full * ((pp - w1) * e) * minus_dlnf0_dv(p, v1);
    const T v2 = v0 + p.dtqm_full * e;
    x[i] = x2;
    v[i] = v2;
    w[i] = w2;
    hat_trig(p, x2, C, S);
    const T val = p.charge * w2;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      acc_c[j] += val * C[j];
      acc_s[j] += val * S[j];
    }
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

template <typename T, typename PT, typename WT, int NM>
cudaError_t launch_substep1(const HostParams& h, const void* x, const void* v,
                            const void* pw, const void* w, const void* mre,
                            const void* mim, void* w1, void* v1, void* partials,
                            int grid, cudaStream_t stream) {
  substep1_kernel<T, PT, WT, NM><<<grid, kThreads, 0, stream>>>(
      to_params<T>(h), static_cast<const T*>(x), static_cast<const T*>(v),
      static_cast<const PT*>(pw), static_cast<const T*>(w),
      static_cast<const T*>(mre), static_cast<const T*>(mim),
      static_cast<WT*>(w1), static_cast<T*>(v1), static_cast<T*>(partials));
  return cudaGetLastError();
}

template <typename T, typename PT, typename WT, int NM>
cudaError_t launch_substep2(const HostParams& h, void* x, void* v,
                            const void* pw, void* w, const void* w1,
                            const void* v1, const void* mre, const void* mim,
                            void* partials, int grid, cudaStream_t stream) {
  substep2_kernel<T, PT, WT, NM><<<grid, kThreads, 0, stream>>>(
      to_params<T>(h), static_cast<T*>(x), static_cast<T*>(v),
      static_cast<const PT*>(pw), static_cast<T*>(w),
      static_cast<const WT*>(w1), static_cast<const T*>(v1),
      static_cast<const T*>(mre), static_cast<const T*>(mim),
      static_cast<T*>(partials));
  return cudaGetLastError();
}

// Mode-count bins: the kernels keep NM sums per thread in registers, so NM is
// a template parameter; a run uses the smallest bin that holds its nmode.
template <typename T, typename PT, typename WT>
int substep1(const HostParams* h, const void* x, const void* v, const void* pw,
             const void* w, const void* mre, const void* mim, void* w1, void* v1,
             void* partials, int grid, void* stream) {
  if (grid <= 0 || h->nmode < 1 || h->nmode > kMaxModes) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h->nmode == 1)
    return launch_substep1<T, PT, WT, 1>(*h, x, v, pw, w, mre, mim, w1, v1, partials,
                                         grid, st);
  if (h->nmode <= 4)
    return launch_substep1<T, PT, WT, 4>(*h, x, v, pw, w, mre, mim, w1, v1, partials,
                                         grid, st);
  return launch_substep1<T, PT, WT, kMaxModes>(*h, x, v, pw, w, mre, mim, w1, v1,
                                               partials, grid, st);
}

template <typename T, typename PT, typename WT>
int substep2(const HostParams* h, void* x, void* v, const void* pw, void* w,
             const void* w1, const void* v1, const void* mre, const void* mim,
             void* partials, int grid, void* stream) {
  if (grid <= 0 || h->nmode < 1 || h->nmode > kMaxModes) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h->nmode == 1)
    return launch_substep2<T, PT, WT, 1>(*h, x, v, pw, w, w1, v1, mre, mim, partials,
                                         grid, st);
  if (h->nmode <= 4)
    return launch_substep2<T, PT, WT, 4>(*h, x, v, pw, w, w1, v1, mre, mim, partials,
                                         grid, st);
  return launch_substep2<T, PT, WT, kMaxModes>(*h, x, v, pw, w, w1, v1, mre, mim,
                                               partials, grid, st);
}

}  // namespace

extern "C" {

int pic1dp_max_modes() { return kMaxModes; }

int pic1dp_params_size() { return static_cast<int>(sizeof(HostParams)); }

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One entry point per (arithmetic, storage of p and w1) pair: f32, f64, and
// f32 with bfloat16 p and w1 (bf16_weights).
#define PIC1DP_SUBSTEPS(SUFFIX, T, PT, WT)                                        \
  int pic1dp_substep1_##SUFFIX(const HostParams* h, const void* x, const void* v, \
                               const void* pw, const void* w, const void* mre,    \
                               const void* mim, void* w1, void* v1,               \
                               void* partials, int grid, void* stream) {          \
    return substep1<T, PT, WT>(h, x, v, pw, w, mre, mim, w1, v1, partials, grid,  \
                               stream);                                           \
  }                                                                               \
  int pic1dp_substep2_##SUFFIX(const HostParams* h, void* x, void* v,             \
                               const void* pw, void* w, const void* w1,           \
                               const void* v1, const void* mre, const void* mim,  \
                               void* partials, int grid, void* stream) {          \
    return substep2<T, PT, WT>(h, x, v, pw, w, w1, v1, mre, mim, partials, grid,  \
                               stream);                                           \
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
