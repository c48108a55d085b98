// The substep kernels' constants and per-marker device functions, shared by
// csrc/substep_kernels.cu (the production kernels) and csrc/stream_probes.cu
// (whose compute units time this very code, as the TPU probes import
// _trig_block, _sincos_turns and _fast_wrap from pallas_kernels.py).
//
// Host constants arrive as HostParams (in double, mirrored field by field by
// the ctypes.Structure SubstepParams in ops/substep_kernels.py) and reach a
// kernel as Params<T>, converted by to_params<T>.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace
