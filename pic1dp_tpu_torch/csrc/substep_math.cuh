// The substep kernels' constants and per-marker device functions, shared by
// csrc/substep_kernels.cu (the production kernels) and csrc/stream_probes.cu
// (whose compute units time wrap, minus_dlnf0_dv and the per-marker trig
// chain hat_trig, as the TPU probes import _trig_block, _sincos_turns and
// _fast_wrap from pallas_kernels.py).  The production kernels take their
// grid angles from a table (hat_table); hat_trig, the chain they ran before,
// stays for the probes and for the accuracy check of grid_angle_kernel.
//
// Host constants arrive as HostParams (in double, mirrored field by field by
// the ctypes.Structure SubstepParams in ops/substep_kernels.py) and reach a
// kernel as Params<T>, converted by to_params<T> (with species 0's
// constants), and as SpeciesTable<T>, the first kMaxSpecies species'
// constants, converted by to_species<T> and read by the species-loop
// instantiations only.  A run with more species than that has every
// species' constants in a device table as well (kSpeciesFields values of T
// per species, ops/substep_kernels.species_table), from which the species
// loop reads species kMaxSpecies and above.  HostParams holds the first
// kMaxModes kept modes; the register bins (at most 4 modes) read theirs
// from it, and the grid bin (more than 4) needs no per-mode constant.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxModes = 16;    // modes in Params
constexpr int kMaxSpecies = 8;   // species in the parameter table
// values per species in the device table: kform, then Species<T>'s T fields
// in their order
constexpr int kSpeciesFields = 10;

// Host constants, in double.  ops/substep_kernels.py mirrors this layout
// field by field in the ctypes.Structure SubstepParams.
struct HostParams {
  long long n;       // markers in each stream (per species)
  int nmode;
  int nx;
  int modes[kMaxModes];
  double cdm1[kMaxModes];  // cos(2 pi m / nx) - 1
  double sd[kMaxModes];    // sin(2 pi m / nx)
  double lx, inv_lx, nx_over_lx;
  double dt_half, dt;
  // each species' constants: the -f0'/f0 form (see minus_dlnf0_dv) and its
  // k_* constants, dt_eff * q / m evaluated on the host, the charge
  int nspecies;
  int sp_kform[kMaxSpecies];
  double sp_dtqm_half[kMaxSpecies], sp_dtqm_full[kMaxSpecies], sp_charge[kMaxSpecies];
  double sp_k_v0[kMaxSpecies], sp_k_iv[kMaxSpecies], sp_k_ivb[kMaxSpecies];
  double sp_k_half_iv[kMaxSpecies], sp_k_half_ivb[kMaxSpecies];
  double sp_k_log_ratio[kMaxSpecies];
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
  p.kform = h.sp_kform[0];
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
  p.dtqm_half = static_cast<T>(h.sp_dtqm_half[0]);
  p.dtqm_full = static_cast<T>(h.sp_dtqm_full[0]);
  p.charge = static_cast<T>(h.sp_charge[0]);
  p.k_v0 = static_cast<T>(h.sp_k_v0[0]);
  p.k_iv = static_cast<T>(h.sp_k_iv[0]);
  p.k_ivb = static_cast<T>(h.sp_k_ivb[0]);
  p.k_half_iv = static_cast<T>(h.sp_k_half_iv[0]);
  p.k_half_ivb = static_cast<T>(h.sp_k_half_ivb[0]);
  p.k_log_ratio = static_cast<T>(h.sp_k_log_ratio[0]);
  return p;
}

// One species' constants at the kernel's type T.
template <typename T>
struct Species {
  int kform;
  T dtqm_half, dtqm_full, charge, k_v0, k_iv, k_ivb, k_half_iv, k_half_ivb, k_log_ratio;
};

template <typename T>
struct SpeciesTable {
  int ns;
  Species<T> s[kMaxSpecies];
};

template <typename T>
SpeciesTable<T> to_species(const HostParams& h) {
  SpeciesTable<T> t;
  t.ns = h.nspecies;
  for (int s = 0; s < kMaxSpecies; ++s) {
    t.s[s].kform = h.sp_kform[s];
    t.s[s].dtqm_half = static_cast<T>(h.sp_dtqm_half[s]);
    t.s[s].dtqm_full = static_cast<T>(h.sp_dtqm_full[s]);
    t.s[s].charge = static_cast<T>(h.sp_charge[s]);
    t.s[s].k_v0 = static_cast<T>(h.sp_k_v0[s]);
    t.s[s].k_iv = static_cast<T>(h.sp_k_iv[s]);
    t.s[s].k_ivb = static_cast<T>(h.sp_k_ivb[s]);
    t.s[s].k_half_iv = static_cast<T>(h.sp_k_half_iv[s]);
    t.s[s].k_half_ivb = static_cast<T>(h.sp_k_half_ivb[s]);
    t.s[s].k_log_ratio = static_cast<T>(h.sp_k_log_ratio[s]);
  }
  return t;
}

// p with species s's constants in place of its own (the port of
// pallas_kernels._make_sel).  s is the same for every thread of the block.
// Below kMaxSpecies the entry is picked by a chain of selects over constant
// indices, so the table stays in the parameter bank instead of being copied
// to local memory for a run-time index; above, it is read from the device
// table `dev` (uniform loads of one row, once per block).
template <typename T>
__device__ __forceinline__ Params<T> with_species(const Params<T>& p,
                                                  const SpeciesTable<T>& tab,
                                                  const T* dev, int s) {
  Species<T> c = tab.s[0];
  if (s < kMaxSpecies) {
#pragma unroll
    for (int j = 1; j < kMaxSpecies; ++j)
      if (j == s) c = tab.s[j];
  } else {
    const T* r = dev + static_cast<long long>(s) * kSpeciesFields;
    c.kform = static_cast<int>(__ldg(r));
    c.dtqm_half = __ldg(r + 1);
    c.dtqm_full = __ldg(r + 2);
    c.charge = __ldg(r + 3);
    c.k_v0 = __ldg(r + 4);
    c.k_iv = __ldg(r + 5);
    c.k_ivb = __ldg(r + 6);
    c.k_half_iv = __ldg(r + 7);
    c.k_half_ivb = __ldg(r + 8);
    c.k_log_ratio = __ldg(r + 9);
  }
  Params<T> q = p;
  q.kform = c.kform;
  q.dtqm_half = c.dtqm_half;
  q.dtqm_full = c.dtqm_full;
  q.charge = c.charge;
  q.k_v0 = c.k_v0;
  q.k_iv = c.k_iv;
  q.k_ivb = c.k_ivb;
  q.k_half_iv = c.k_half_iv;
  q.k_half_ivb = c.k_half_ivb;
  q.k_log_ratio = c.k_log_ratio;
  return q;
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
// Part of hat_trig's chain (the probes, grid_angle_kernel), not of the
// production kernels.
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
// and above nmode are 0.  This per-marker chain (%, divide, sincospi) is what
// the substep kernels ran before the angle table; the compute probe still
// times it.  The production kernels call hat_table.
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

// One (cos, sin) entry of the grid-angle table: 8 bytes in float, 16 in
// double, so a mode costs one 8- or 16-byte gather.
template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<double> {
  using type = double2;
};
template <typename T>
using Pair = typename PairOf<T>::type;

// The cell of x in [0, lx): its hat fraction f and its index ix0, clamped
// (hat_trig's).
template <typename T>
__device__ __forceinline__ void hat_cell(const Params<T>& p, T x, T* f, int* ix0) {
  const T s = x * p.nx_over_lx;
  const T fl = floor_t(s);
  *f = s - fl;
  *ix0 = min(max(static_cast<int>(fl), 0), p.nx - 1);
}

// (C, S) of kept mode j in cell ix0 at fraction f, from the grid-angle
// table ang (ang[j * nx + ix] is (cos, sin) of 2 pi (m_j ix mod nx) / nx,
// built on the host in float64 and rounded once to T,
// ops/substep_kernels.angle_table) and the mode's constants
// cdm1 = cos(2 pi m_j / nx) - 1 and sd = sin(2 pi m_j / nx): hat_trig's
// fold, with no %, divide or sincospi.
template <typename T>
__device__ __forceinline__ void hat_mode(const Pair<T>* ang, int nx, int j, int ix0, T f,
                                         T cdm1, T sd, T* C, T* S) {
  const Pair<T> e = ang[j * nx + ix0];
  const T a = T(1) + f * cdm1;
  const T b = f * sd;
  *C = e.x * a - e.y * b;
  *S = e.y * a + e.x * b;
}

// hat_trig with the grid angles gathered from the table (hat_mode) for the
// first NM kept modes, whose constants p holds (NM <= kMaxModes).
template <typename T, int NM>
__device__ __forceinline__ void hat_table(const Params<T>& p, const Pair<T>* ang, T x,
                                          T (&C)[NM], T (&S)[NM]) {
  T f;
  int ix0;
  hat_cell(p, x, &f, &ix0);
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    C[j] = T(0);
    S[j] = T(0);
    if (j < p.nmode) hat_mode(ang, p.nx, j, ix0, f, p.cdm1[j], p.sd[j], &C[j], &S[j]);
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// ---- the grid form (the many-mode kernels): the hat fold is linear, so
// sum_m (C_m re_m - S_m im_m) at x is the hat lerp of E on the nx cells, and
// sum_p val_p (C_m, S_m)(x_p) is the projection of the hat deposit of val.
// Every rounding below is an explicit FMA or a lone add or multiply, so two
// kernels that form the same grid from the same modes get the same bits. ----

// E in cell j from the kept modes: 2 sum_m (cos th_mj re_m - sin th_mj im_m),
// in mode order, with (cos, sin) th_mj from the angle table in device memory.
template <typename T>
__device__ __forceinline__ T grid_e(const Pair<T>* ang, int nx, int nmode, int j, const T* re,
                                   const T* im) {
  T e = T(0);
#pragma unroll 16
  for (int m = 0; m < nmode; ++m) {
    const Pair<T> c = __ldg(ang + m * nx + j);
    e = fma_t(c.x, __ldg(re + m), e);
    e = fma_t(-c.y, __ldg(im + m), e);
  }
  return T(2) * e;
}

// E at a marker in cell ix0 at fraction f (hat_cell) from the E grid eg of
// nx + 1 values (eg[nx] = eg[0]): (1 - f) eg[ix0] + f eg[ix0 + 1], as
// eg[ix0] + f (eg[ix0 + 1] - eg[ix0]).  Substep 1's gather and both of
// substep 2's use it, so a rebuilt v1 has the streamed v1's bits.
template <typename T>
__device__ __forceinline__ T grid_gather(const T* eg, int ix0, T f) {
  const T a = eg[ix0];
  return fma_t(f, eg[ix0 + 1] - a, a);
}

// rho[c 2 nx + cell] += left[c] and rho[c 2 nx + nx + cell] += right[c],
// channel by channel (K channels, each a grid of 2 nx values), for every
// lane of the warp whose cell is >= 0 (a marker's two hat halves: rho[0, nx)
// holds the halves deposited at their cell ix0, rho[nx, 2 nx) those that
// belong to ix0 + 1, so one match serves both), in an order fixed by the
// lanes alone: the lanes that share a cell (__match_any_sync) are summed by
// the lowest of them, its own values first and then the others' in lane
// order, read from stage (the warp's 64 K values in shared memory), and
// that lane alone adds the sums to rho.  No float atomic, so the result does
// not depend on how the warps are scheduled.  Every lane of the warp must
// call it; it ends with __syncwarp, so rho and stage may be used again at
// once.  The substep kernels' charge grid is its one-channel form (below);
// the hat deposits of csrc/hist_kernels.cu call it with up to 3 channels.
template <typename T, int K>
__device__ __forceinline__ void deposit_lanes(T* rho, int nx, T* stage, int cell,
                                              T (&left)[K], T (&right)[K]) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  const bool lowest = (peers & ((1u << lane) - 1u)) == 0u;
  const unsigned above = peers & ~((2u << lane) - 1u);
  if (__any_sync(0xffffffffu, above != 0u)) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      stage[c * 64 + lane] = left[c];
      stage[c * 64 + 32 + lane] = right[c];
    }
    __syncwarp();
    if (lowest)
      for (unsigned rest = above; rest != 0u; rest &= rest - 1u) {
        const int src = __ffs(rest) - 1;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          left[c] += stage[c * 64 + src];
          right[c] += stage[c * 64 + 32 + src];
        }
      }
  }
  if (lowest && cell >= 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      rho[c * 2 * nx + cell] += left[c];
      rho[c * 2 * nx + nx + cell] += right[c];
    }
  }
  __syncwarp();
}

// One channel: rho[cell] += left and rho[nx + cell] += right.
template <typename T>
__device__ __forceinline__ void deposit_lanes(T* rho, int nx, T* stage, int cell, T left,
                                              T right) {
  T l[1] = {left}, r[1] = {right};
  deposit_lanes<T, 1>(rho, nx, stage, cell, l, r);
}

// Periodic wrap into [0, lx) by a reciprocal multiply; the reciprocal's
// rounding can land one ulp outside, which the two selects fix
// (pallas_kernels._fast_wrap).
template <typename T>
__device__ __forceinline__ T wrap(const Params<T>& p, T x) {
  const T y = x - p.lx * floor_t(x * p.inv_lx);
  return y >= p.lx ? y - p.lx : (y < T(0) ? y + p.lx : y);
}

// -f0'/f0 at v (pallas_kernels._minus_dlnf0_dv_fast), by kform:
//   0  a Maxwellian, or a degenerate bump-on-tail: (v - k_v0) * k_iv;
//   1  the two-Gaussian bump-on-tail: the single-exponential ratio
//      (v/T + r (v - v0)/T2) / (1 + r), r = beam/core, exponent clamped to
//      +-60;
//   2  TWO_STREAM1: v - 2/v;
//   3  TWO_STREAM2: ((v + v0) + (v - v0) r) / T / (1 + r), r = exp(2 v v0/T)
//      with k_ivb = 2 v0/T, exponent clamped to +-60.
// Forms 2 and 3 are compiled in only with kAllForms (the species-loop
// instantiations); the main path's kernels and the probes keep forms 0 and 1.
template <typename T, bool kAllForms = false>
__device__ __forceinline__ T minus_dlnf0_dv(const Params<T>& p, T v) {
  if constexpr (kAllForms) {
    if (p.kform == 2) return v - T(2) / v;
    if (p.kform == 3) {
      const T r = exp_t(clamp_t(v * p.k_ivb, T(-60), T(60)));
      return ((v + p.k_v0) + (v - p.k_v0) * r) * p.k_iv / (T(1) + r);
    }
  }
  if (p.kform == 0) return (v - p.k_v0) * p.k_iv;
  const T dv = v - p.k_v0;
  const T arg = clamp_t(v * v * p.k_half_iv - dv * dv * p.k_half_ivb + p.k_log_ratio,
                        T(-60), T(60));
  const T r = exp_t(arg);
  return (v * p.k_iv + r * (dv * p.k_ivb)) / (T(1) + r);
}

}  // namespace
