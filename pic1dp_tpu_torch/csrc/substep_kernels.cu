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
// because Mosaic's sin/cos were slow.
//
// The projection sum: a TPU grid runs in order and carries the sum in one
// VMEM tile; Hopper blocks run in no order.  Each block reduces its threads'
// sums with warp shuffles and shared memory in a fixed tree and writes one
// (2, nmode) row of a (grid, 2, nmode) partials buffer, which the wrapper
// sums over the grid.  There are no float atomics, so with a fixed grid the
// sum is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModes = 16;

// Host constants, in double.  ops/substep_kernels.py mirrors this layout
// field by field in the ctypes.Structure SubstepParams.
struct HostParams {
  long long n;       // markers in each stream
  int nmode;
  int nx;
  int kform;         // -f0'/f0 form: 0 (v - k_v0) * k_iv, 1 two-Gaussian ratio
  int modes[kMaxModes];
  double cdm1[kMaxModes];  // cos(2 pi m / nx) - 1
  double sd[kMaxModes];    // sin(2 pi m / nx)
  double lx, inv_lx, nx_over_lx;
  double dt_half, dt;
  double dtqm_half, dtqm_full;  // dt_eff * q / m, evaluated on the host
  double charge;
  double k_v0, k_iv, k_ivb, k_half_iv, k_half_ivb, k_log_ratio;
};

namespace {

// The same constants at the kernel's type T, passed by value.
template <typename T>
struct Params {
  long long n;
  int nmode, nx, kform;
  int modes[kMaxModes];
  T cdm1[kMaxModes], sd[kMaxModes];
  T lx, inv_lx, nx_over_lx, dt_half, dt, dtqm_half, dtqm_full, charge;
  T k_v0, k_iv, k_ivb, k_half_iv, k_half_ivb, k_log_ratio;
};

template <typename T>
Params<T> to_params(const HostParams& h) {
  Params<T> p;
  p.n = h.n;
  p.nmode = h.nmode;
  p.nx = h.nx;
  p.kform = h.kform;
  for (int j = 0; j < kMaxModes; ++j) {
    p.modes[j] = h.modes[j];
    p.cdm1[j] = static_cast<T>(h.cdm1[j]);
    p.sd[j] = static_cast<T>(h.sd[j]);
  }
  p.lx = static_cast<T>(h.lx);
  p.inv_lx = static_cast<T>(h.inv_lx);
  p.nx_over_lx = static_cast<T>(h.nx_over_lx);
  p.dt_half = static_cast<T>(h.dt_half);
  p.dt = static_cast<T>(h.dt);
  p.dtqm_half = static_cast<T>(h.dtqm_half);
  p.dtqm_full = static_cast<T>(h.dtqm_full);
  p.charge = static_cast<T>(h.charge);
  p.k_v0 = static_cast<T>(h.k_v0);
  p.k_iv = static_cast<T>(h.k_iv);
  p.k_ivb = static_cast<T>(h.k_ivb);
  p.k_half_iv = static_cast<T>(h.k_half_iv);
  p.k_half_ivb = static_cast<T>(h.k_half_ivb);
  p.k_log_ratio = static_cast<T>(h.k_log_ratio);
  return p;
}

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float clamp_t(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double clamp_t(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}
__device__ __forceinline__ void sincospi_t(float t, float* s, float* c) {
  sincospif(t, s, c);
}
__device__ __forceinline__ void sincospi_t(double t, double* s, double* c) {
  sincospi(t, s, c);
}

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

// sin and cos of the grid angle 2 pi k / nx for an integer k in [0, nx).  k
// is folded into (-nx/2, nx/2] first, so the one rounding of the argument
// (the division) is at most half an ulp of a number of magnitude <= 1.
template <typename T>
__device__ __forceinline__ void grid_angle(int k, int nx, T* s, T* c) {
  const int kk = (2 * k > nx) ? k - nx : k;
  sincospi_t(static_cast<T>(2 * kk) / static_cast<T>(nx), s, c);
}

// Hat-interpolated (C_m, S_m) of each kept mode at x in [0, lx):
//   C = (1 - f) cos(th0) + f cos(th0 + d) = c0 (1 + f (cos d - 1)) - s0 f sin d
//   S = (1 - f) sin(th0) + f sin(th0 + d) = s0 (1 + f (cos d - 1)) + c0 f sin d
// with th0 = 2 pi (m ix0 mod nx) / nx reduced exactly in integers and
// d = 2 pi m / nx (the hat fold of pallas_kernels._trig_block).  Entries at
// and above nmode are 0.
template <typename T, int NM>
__device__ __forceinline__ void hat_trig(const Params<T>& p, T x, T (&C)[NM],
                                         T (&S)[NM]) {
  const T s = x * p.nx_over_lx;
  const T fl = floor_t(s);
  const T f = s - fl;
  const int ix0 = min(max(static_cast<int>(fl), 0), p.nx - 1);
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    C[j] = T(0);
    S[j] = T(0);
    if (j < p.nmode) {
      T sn, cs;
      grid_angle((p.modes[j] * ix0) % p.nx, p.nx, &sn, &cs);
      const T a = T(1) + f * p.cdm1[j];
      const T b = f * p.sd[j];
      C[j] = cs * a - sn * b;
      S[j] = sn * a + cs * b;
    }
  }
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

// Periodic wrap into [0, lx) by a reciprocal multiply; the reciprocal's
// rounding can land one ulp outside, which the two selects fix
// (pallas_kernels._fast_wrap).
template <typename T>
__device__ __forceinline__ T wrap(const Params<T>& p, T x) {
  const T y = x - p.lx * floor_t(x * p.inv_lx);
  return y >= p.lx ? y - p.lx : (y < T(0) ? y + p.lx : y);
}

// -f0'/f0 at v (pallas_kernels._minus_dlnf0_dv_fast): a Maxwellian, or a
// degenerate bump-on-tail, is linear in v; the two-Gaussian bump-on-tail is
// the single-exponential ratio (v/T + r (v - v0)/T2) / (1 + r) with
// r = beam/core, its exponent clamped to +-60.
template <typename T>
__device__ __forceinline__ T minus_dlnf0_dv(const Params<T>& p, T v) {
  if (p.kform == 0) return (v - p.k_v0) * p.k_iv;
  const T dv = v - p.k_v0;
  const T arg = clamp_t(v * v * p.k_half_iv - dv * dv * p.k_half_ivb + p.k_log_ratio,
                        T(-60), T(60));
  const T r = exp_t(arg);
  return (v * p.k_iv + r * (dv * p.k_ivb)) / (T(1) + r);
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
