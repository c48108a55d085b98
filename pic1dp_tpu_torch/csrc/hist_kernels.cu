// Deterministic hat deposits onto small grids, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (pic1dp_tpu_torch/ops/hist_kernels.py).
//
// The JAX package computes these sums as one-hot contractions or segment
// sums, which repeat bit for bit on its device; they are not Pallas kernels.
// Three instantiations of one kernel family replace them (the `kind`):
//
//   kXV  the x-v snapshot histogram (pic1dp_tpu/core/diagnostics.py:78
//        deposit_xv): K value channels (k, n) of one species onto the
//        (nv, nx) diagnostic grid, hat weights in x (periodic) and in v
//        (inclusive [-v_max, v_max], markers with |v| >= v_max skipped):
//        four corners a marker;
//   kV   the |delta f|(v) profile that drives merge/remove/split
//        (diagnostics.py:184 dist_pertb_abs_v): |w| of the live markers with
//        |v| < v_max onto nv points per species, (ns, n) -> (ns, nv);
//   kX   the grid charge (pic1dp_tpu/ops/deposit.py:46-140): val at x onto
//        the periodic (nx,) grid, (ns, n) -> (nx,), every species summed.
//
// Each marker's hat weights are those of ops/interp.py (hat_x, hat_v), at
// the arithmetic type T, with the host's scale factors rounded to T as
// PyTorch rounds a Python float in a T tensor's product; each term is the
// plain version's product ((wv wx) val for kXV, w val for kV and kX).
//
// No float atomic anywhere, so a launch repeats bit for bit, a replay from a
// CUDA graph included:
//
//   * Within a warp (deposit_lanes of substep_math.cuh, the substep kernels'
//     own, with K channels): one __match_any_sync a marker and v row finds the
//     lanes that share its cell; the lowest of them sums their values in
//     lane order (its own first) and alone adds them to the grid.  A
//     marker's two x halves go to the left half [0, nbins) at its cell ix0
//     and to the right half [nbins, 2 nbins) at the same cell, which belongs
//     to ix0 + 1; one match serves both.  kXV calls it once per v row (cell
//     iv nx + ix0, rows iv0 and iv0 + 1).
//   * Within a block: `copies` grids of K channels x 2 nbins values in
//     dynamic shared memory (8, 4, 2 or 1, the most that fit in kSmemMax),
//     warp w depositing on grid w % copies, the warps that share a grid in
//     turns separated by __syncthreads.  Where not even one grid fits (the
//     charge grid at nx 32768 in f32 or f64), the block's grid is its own
//     slice of a device buffer, zeroed by the block and walked the same way.
//   * The block's tail folds each right half onto its neighbour (periodic
//     in x, none past the last v point) and sums the copies in copy order,
//     into the block's row of partials.
//   * Across blocks: a second, bin-parallel kernel sums the G rows of every
//     output value in block order (hist_sum_kernel).  The block count G and
//     each block's range of markers are fixed by n, the kind, the grid and
//     the card, so the order of every sum is fixed by the code.  No counter,
//     so nothing needs resetting between launches or graph replays.
//
// Sums are taken at T, the output's type, as the plain versions' index_add_
// takes them; only the order differs from theirs.
//
// What bounds them on this card: the bytes of the marker streams (x, v and
// K channels for kXV; v, w and the live byte for kV; x and val for kX) over
// HBM, against a few operations a marker; but this first design shares one
// block's grid between warps in turns, so the turns' barriers and the
// block's tail set the pace at small marker counts.  Making it fast is left
// for later: the design aims at a fixed order of every sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "substep_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 3;
// One block's dynamic shared memory at most with an opt-in (232,448 bytes
// on sm_90); the kernels use no static shared memory.
constexpr int kSmemMax = 232448;
constexpr int kSmemNoOptIn = 48 * 1024;
// blocks an SM at most: more rows of partials buy nothing once the SMs are
// full
constexpr int kMaxBlocksPerSm = 4;

enum Kind { kXV = 0, kV = 1, kX = 2 };

template <typename T>
struct Args {
  const T* a;                 // kXV, kX: x; kV: v
  const T* b;                 // kXV: v; kV: w; kX: val
  const void* c;              // kXV: the K channels (K, n); kV: live (bool); kX: unused
  long long n;                // markers (kV: ns * n_species)
  long long n_species;        // kV: markers per species
  long long per_block;        // markers per block, a multiple of kThreads
  int nx, nv, nbins;          // nbins: cells of one channel's grid (= outputs)
  T x_scale;                  // nx / lx
  T v_max, v_scale;           // v_max, (nv - 1) / (2 v_max)
  int copies;                 // grids in shared memory; 0: the device buffer
  T* grids;                   // the device buffer (copies == 0)
  T* partials;                // (G, K, nbins)
};

__device__ __forceinline__ double abs_t(double s) { return fabs(s); }
__device__ __forceinline__ float abs_t(float s) { return fabsf(s); }

// hat_x: cell ix0 in [0, nx) and the fraction f of an x in [0, lx).
template <typename T>
__device__ __forceinline__ int hat_xcell(T x, T scale, int n, T* frac) {
  const T s = x * scale;
  const T fl = floor_t(s);
  *frac = s - fl;
  const long long i = static_cast<long long>(fl);
  return static_cast<int>(i < 0 ? 0 : i > n - 1 ? n - 1 : i);
}

// hat_v: cell iv0 in [0, nv - 2] and the fraction f; *inside is |v| < v_max.
template <typename T>
__device__ __forceinline__ int hat_vcell(T v, T v_max, T scale, int nv, T* frac, bool* inside) {
  const T s = (v + v_max) * scale;
  const T fl = floor_t(s);
  *frac = s - fl;
  *inside = abs_t(v) < v_max;
  if (!*inside) return 0;   // its cell is never read
  const long long i = static_cast<long long>(fl);
  return static_cast<int>(i < 0 ? 0 : i > nv - 2 ? nv - 2 : i);
}

// The grid value a right half at cell `o`'s left neighbour adds to output
// o, or -1 where none does: x is periodic (kXV within a v row, kX); the
// v grid of kV has no point before the first of each species.
template <int KIND>
__device__ __forceinline__ int left_neighbour(int o, int nx, int nv) {
  if constexpr (KIND == kV) {
    return o % nv == 0 ? -1 : o - 1;
  } else {
    const int j = o % nx;
    return j == 0 ? o + nx - 1 : o - 1;
  }
}

template <typename T, int K, int KIND>
__global__ void __launch_bounds__(kThreads) hist_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const long long gstride = 2LL * K * a.nbins;   // one grid of K channels
  const int copies = a.copies > 0 ? a.copies : 1;
  T* grids = a.copies > 0 ? smem : a.grids + blockIdx.x * gstride;
  T* stage = (a.copies > 0 ? smem + copies * gstride : smem) + warp * 64 * K;
  for (long long j = threadIdx.x; j < copies * gstride; j += kThreads) grids[j] = T(0);
  __syncthreads();

  T* grid = grids + (warp % copies) * gstride;
  const int turns = kWarps / copies;
  const long long begin = blockIdx.x * a.per_block;
  const long long end = begin + a.per_block < a.n ? begin + a.per_block : a.n;
  for (long long base = begin; base < end; base += kThreads) {
    const long long i = base + threadIdx.x;
    int cell0 = -1, cell1 = -1;
    T l0[K], r0[K], l1[K], r1[K];
#pragma unroll
    for (int c = 0; c < K; ++c) l0[c] = r0[c] = l1[c] = r1[c] = T(0);
    if (i < end) {
      if constexpr (KIND == kXV) {
        T fx, fv;
        bool inside;
        const int ix0 = hat_xcell(a.a[i], a.x_scale, a.nx, &fx);
        const int iv0 = hat_vcell(a.b[i], a.v_max, a.v_scale, a.nv, &fv, &inside);
        if (inside) {
          const T wx0 = T(1) - fx, wx1 = fx, wv0 = T(1) - fv, wv1 = fv;
          const T w00 = wv0 * wx0, w01 = wv0 * wx1, w10 = wv1 * wx0, w11 = wv1 * wx1;
          const T* vals = static_cast<const T*>(a.c);
#pragma unroll
          for (int c = 0; c < K; ++c) {
            const T val = vals[c * a.n + i];
            l0[c] = w00 * val;
            r0[c] = w01 * val;
            l1[c] = w10 * val;
            r1[c] = w11 * val;
          }
          cell0 = iv0 * a.nx + ix0;
          cell1 = cell0 + a.nx;
        }
      } else if constexpr (KIND == kV) {
        T fv;
        bool inside;
        const T v = a.a[i];
        const int iv0 = hat_vcell(v, a.v_max, a.v_scale, a.nv, &fv, &inside);
        const bool live = static_cast<const unsigned char*>(a.c)[i] != 0;
        if (inside && live) {
          const T val = abs_t(a.b[i]);
          l0[0] = (T(1) - fv) * val;
          r0[0] = fv * val;
          cell0 = static_cast<int>(i / a.n_species) * a.nv + iv0;
        }
      } else {
        T fx;
        const int ix0 = hat_xcell(a.a[i], a.x_scale, a.nx, &fx);
        const T val = a.b[i];
        l0[0] = (T(1) - fx) * val;
        r0[0] = fx * val;
        cell0 = ix0;
      }
    }
    for (int t = 0; t < turns; ++t) {
      if (warp / copies == t) {
        deposit_lanes<T, K>(grid, a.nbins, stage, cell0, l0, r0);
        if constexpr (KIND == kXV) deposit_lanes<T, K>(grid, a.nbins, stage, cell1, l1, r1);
      }
      if (turns > 1) __syncthreads();
    }
  }
  __syncthreads();

  // the tail: left half + its left neighbour's right half, copy by copy
  T* row = a.partials + static_cast<long long>(blockIdx.x) * K * a.nbins;
  for (int o = threadIdx.x; o < a.nbins; o += kThreads) {
    const int prev = left_neighbour<KIND>(o, a.nx, a.nv);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T acc = T(0);
      for (int cp = 0; cp < copies; ++cp) {
        const T* g = grids + cp * gstride + c * 2LL * a.nbins;
        acc += g[o];
        if (prev >= 0) acc += g[a.nbins + prev];
      }
      row[c * a.nbins + o] = acc;
    }
  }
}

// out[o] = the sum of the `blocks` rows' value o, in block order.
template <typename T>
__global__ void __launch_bounds__(kThreads) hist_sum_kernel(const T* partials, int blocks,
                                                            int values, T* out) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= values) return;
  T acc = T(0);
  for (int b = 0; b < blocks; ++b) acc += partials[static_cast<long long>(b) * values + o];
  out[o] = acc;
}

template <typename T, int K, int KIND>
void* kernel_of() {
  return reinterpret_cast<void*>(&hist_kernel<T, K, KIND>);
}

template <typename T>
void* pick(int kind, int k) {
  if (kind == kXV)
    return k == 1 ? kernel_of<T, 1, kXV>() : k == 2 ? kernel_of<T, 2, kXV>()
                                           : kernel_of<T, 3, kXV>();
  return kind == kV ? kernel_of<T, 1, kV>() : kernel_of<T, 1, kX>();
}

bool valid_kind(int kind, int k) {
  return (kind == kXV && k >= 1 && k <= kMaxK) || ((kind == kV || kind == kX) && k == 1);
}

// Grids in shared memory: the most copies of 8, 4, 2, 1 whose grids and the
// warps' stages fit in kSmemMax; 0 copies (the device buffer, the stages
// alone in shared memory) where not even one does.
int plan_smem(int itemsize, int k, int nbins, int* copies) {
  const long long stage = static_cast<long long>(kWarps) * 64 * k * itemsize;
  for (int c = kWarps; c >= 1; c /= 2) {
    const long long bytes = static_cast<long long>(c) * 2 * k * nbins * itemsize + stage;
    if (bytes <= kSmemMax) {
      *copies = c;
      return static_cast<int>(bytes);
    }
  }
  *copies = 0;
  return static_cast<int>(stage);
}

// Check a launch and run both kernels: the deposit on `blocks` blocks of
// per_block markers each (none when there are no markers), then the sum of
// their rows into out.
template <typename T>
int launch(int kind, int k, const void* a, const void* b, const void* c, long long n,
           int ns, int nx, int nv, double lx, double v_max, void* grids, int blocks,
           long long per_block, void* partials, void* out, void* stream) {
  const long long total = n * ns;
  if (!valid_kind(kind, k) || ns < 1 || (kind == kXV && ns != 1) || nx < 1 || nv < 2 ||
      n < 0 || blocks < 0 || out == nullptr || !(lx > 0.0) || !(v_max > 0.0))
    return cudaErrorInvalidValue;
  const long long nbins = kind == kXV ? static_cast<long long>(nv) * nx
                          : kind == kV ? static_cast<long long>(ns) * nv : nx;
  if (nbins * 2 * k > (1LL << 31) - 1) return cudaErrorInvalidValue;
  if (total > 0 && (blocks < 1 || per_block < 1 || per_block % kThreads != 0 ||
                    (blocks - 1) * per_block >= total || blocks * per_block < total ||
                    partials == nullptr))
    return cudaErrorInvalidValue;
  int copies = 0;
  const int smem = plan_smem(static_cast<int>(sizeof(T)), k, static_cast<int>(nbins), &copies);
  if (total > 0 && copies == 0 && grids == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    Args<T> args{};
    args.a = static_cast<const T*>(a);
    args.b = static_cast<const T*>(b);
    args.c = c;
    args.n = total;
    args.n_species = n;
    args.per_block = per_block;
    args.nx = nx;
    args.nv = nv;
    args.nbins = static_cast<int>(nbins);
    args.x_scale = static_cast<T>(nx / lx);
    args.v_max = static_cast<T>(v_max);
    args.v_scale = static_cast<T>((nv - 1) / (2.0 * v_max));
    args.copies = copies;
    args.grids = static_cast<T*>(grids);
    args.partials = static_cast<T*>(partials);
    if (kind == kXV) {
      if (k == 1) hist_kernel<T, 1, kXV><<<blocks, kThreads, smem, st>>>(args);
      else if (k == 2) hist_kernel<T, 2, kXV><<<blocks, kThreads, smem, st>>>(args);
      else hist_kernel<T, 3, kXV><<<blocks, kThreads, smem, st>>>(args);
    } else if (kind == kV) {
      hist_kernel<T, 1, kV><<<blocks, kThreads, smem, st>>>(args);
    } else {
      hist_kernel<T, 1, kX><<<blocks, kThreads, smem, st>>>(args);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {
    blocks = 0;
  }
  const int values = static_cast<int>(k * nbins);
  hist_sum_kernel<T><<<(values + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const T*>(partials), blocks, values, static_cast<T*>(out));
  return cudaGetLastError();
}

// The shared memory and grid copies of a launch (plan_smem), its kernel
// opted in to that much shared memory on the current device where it needs
// more than 48 KB, and the blocks of it an SM holds (at most
// kMaxBlocksPerSm; 1 where the grids lie in the device buffer, whose size
// grows with the blocks).
template <typename T>
int configure(int kind, int k, int nbins, int* copies, int* smem, int* blocks_per_sm) {
  if (!valid_kind(kind, k) || nbins < 1 || static_cast<long long>(nbins) * 2 * k >
      (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  *smem = plan_smem(static_cast<int>(sizeof(T)), k, nbins, copies);
  const void* fn = pick<T>(kind, k);
  if (*smem > kSmemNoOptIn) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               *smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks_per_sm = *copies == 0 ? 1 : per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pic1dp_hist_threads() { return kThreads; }

int pic1dp_hist_smem_max() { return kSmemMax; }

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// configure() at itemsize 4 (float) or 8 (double).
int pic1dp_hist_configure(int itemsize, int kind, int k, int nbins, int* copies, int* smem,
                          int* blocks_per_sm) {
  if (itemsize == 4) return configure<float>(kind, k, nbins, copies, smem, blocks_per_sm);
  if (itemsize == 8) return configure<double>(kind, k, nbins, copies, smem, blocks_per_sm);
  return cudaErrorInvalidValue;
}

// One deposit and its sum (launch()); a, b, c as Args names them; n markers
// of each of ns species (kXV: ns = 1); grids: the device buffer of blocks x
// k x 2 nbins values where the grids do not fit in shared memory, else
// unused; partials: blocks x k x nbins values; out: k x nbins values.
int pic1dp_hist_f32(int kind, int k, const void* a, const void* b, const void* c, long long n,
                    int ns, int nx, int nv, double lx, double v_max, void* grids, int blocks,
                    long long per_block, void* partials, void* out, void* stream) {
  return launch<float>(kind, k, a, b, c, n, ns, nx, nv, lx, v_max, grids, blocks, per_block,
                       partials, out, stream);
}

int pic1dp_hist_f64(int kind, int k, const void* a, const void* b, const void* c, long long n,
                    int ns, int nx, int nv, double lx, double v_max, void* grids, int blocks,
                    long long per_block, void* partials, void* out, void* stream) {
  return launch<double>(kind, k, a, b, c, n, ns, nx, nv, lx, v_max, grids, blocks, per_block,
                        partials, out, stream);
}

}  // extern "C"
