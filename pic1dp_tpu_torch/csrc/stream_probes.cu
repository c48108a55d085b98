// Stream-only probe kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (pic1dp_tpu_torch/ops/stream_probes.py).
//
// They replace the TPU probe kernels that measure the streaming ceiling of
// the substep kernels' access patterns: stream_only in bench/kernel_probe.py
// (:140, body :143-158) and default_pipeline / manual_pipeline in
// bench/probe_pipeline.py (:78 and :104, body :70-76).  All three compute the
// same function of NR float streams:
//
//   acc   = in_0 + in_1 + ... + in_{NR-1}        (left to right, in float)
//   out_j = acc * (1 + 0.25 j)                    for j < NW
//   sum   = the sum of acc over every element     (the TPU's (8,128) tile)
//
// where each output either overwrites a named input (the TPU kernels'
// input_output_aliases) or goes to a fresh buffer; the wrapper passes the
// output pointers accordingly.
//
// What bounds them: nothing but memory traffic, (NR + NW) * 4 bytes per
// element against a few adds; their rate is the attainable ceiling for the
// pattern on this card.  Two designs, the two choices a substep kernel has:
//
//   stream_rw    direct loads.  A grid-stride loop in which each thread
//                loads one float4 of every input, sums it in registers and
//                stores one float4 of every output; a masked scalar tail
//                takes n % 4.  On the TPU, stream_only and default_pipeline
//                are the same kernel under the default grid pipeline, so
//                here they are one template.
//   stream_bulk  a manual pipeline (the counterpart of pltpu.emit_pipeline).
//                A persistent grid; each block owns a ring of `stages`
//                shared-memory slots, each holding one tile of every input.
//                One thread fills a slot with one cp.async.bulk (1D bulk
//                copy, no tensor map) per input, completing on the slot's
//                mbarrier with expect_tx; all threads wait on the barrier,
//                compute from shared memory and store float4 to global.  A
//                slot is refilled `stages` tiles ahead once every thread has
//                left it (__syncthreads, then fence.proxy.async before the
//                async proxy writes it again).  Elements past the last whole
//                tile are taken with plain loads.
//
// The element sum: Hopper blocks run in no order, so each block reduces its
// threads' sums (in double, each element added as its exact double value)
// with shuffles and shared memory in a fixed tree and writes one partial;
// the wrapper sums the partials.  No float atomics.
//
// In place: an output aliasing an input is written only at the elements the
// same thread (stream_rw) or block (stream_bulk, after the tile arrived in
// shared memory) has already read, so the pointers are not __restrict__.
//
// Compute units (stream_units, stream_bulk_units).  The TPU's make_call
// (bench/probe_compute.py:94), default_call and manual_call
// (bench/probe_overlap.py:72, :100) add to the 4r+3w body K copies of one
// unit applied to in_0:
//
//   out_j = acc * (1 + 0.25 j) + eps * extra,   extra = sum_{c<K} unit(in_0, c)
//
// with the units taken from substep_math.cuh.  trig is hat_trig, the
// per-marker trig chain the substep kernels ran before they gathered the
// grid angles from a table (hat_table): the probes time that older chain,
// not the production path.
//
//   trig  hat_trig for mode 1 (grid-angle sincospif after the integer
//         reduction, %, divide, hat fold) at x + 1e-6 c: C + S
//   poly  bare sincospif of the turn x / lx + 1e-6 c (mod 1): cos + sin
//   exp   minus_dlnf0_dv, the two-Gaussian ratio drive, at v + 1e-6 c
//   wrap  wrap of x + c
//
// Unit and K are template parameters, so the copies unroll as the TPU's
// Python loop does.  eps is a runtime argument: the compiler cannot drop a
// unit whose result reaches memory only through eps * extra, and a check can
// run at eps = 1 to see what the units compute.  K = 0 of every unit is the
// plain stream body above (unit kNone, extra = 0), instantiated as before.
//
// Carry layouts (stream_carry).  The TPU's flat_call and pingpong_call
// (bench/probe_pingpong.py:128, :167) run the 4r+3w body inside a scan under
// several carry layouts.  On the card a layout is only a choice of buffers:
// the wrapper picks the output pointers (in place, fresh, or the other of two
// buffer sets), and with a device pointer h each stream is a (2, n) buffer
// read at half *h and written at half 1 - *h, *h loaded by every block (the
// counterpart of scalar prefetch), so the caller flips h on the device with
// no host sync between steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "substep_math.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIn = 6;
constexpr int kMaxOut = 4;
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 8 * kMaxStages;  // the mbarriers, ahead of the ring

namespace {

struct Streams {
  const float* in[kMaxIn];
  float* out[kMaxOut];
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float c) {
  return make_float4(a.x * c, a.y * c, a.z * c, a.w * c);
}

__device__ __forceinline__ double hsum(float4 a) {
  return static_cast<double>(a.x) + static_cast<double>(a.y) +
         static_cast<double>(a.z) + static_cast<double>(a.w);
}

// 1 + 0.25 j, exact in float
__device__ __forceinline__ float factor(int j) { return 1.0f + 0.25f * j; }

enum Unit : int { kNone = 0, kTrig = 1, kPoly = 2, kExp = 3, kWrap = 4 };

// What the units read: the substep constants and the scale of their sum.
struct UnitArgs {
  Params<float> p;
  float eps;
};

// Copy c of unit U at x.  c is a constant after unrolling, so each copy's
// salt is folded, as the TPU probe's float(j) is.
template <int U>
__device__ __forceinline__ float unit(const Params<float>& p, float x, int c) {
  if constexpr (U == kTrig) {
    float C[1], S[1];
    hat_trig(p, x + static_cast<float>(1e-6 * c), C, S);
    return C[0] + S[0];
  } else if constexpr (U == kPoly) {
    // the turn with two roundings, as its plain version has it (a fused
    // multiply-add would move the turn by an ulp and the angle by 2 pi ulps)
    float t = __fadd_rn(__fmul_rn(x, p.inv_lx), static_cast<float>(1e-6 * c));
    t = t - floorf(t);
    float sn, cs;
    sincospi_t(2.0f * t, &sn, &cs);
    return cs + sn;
  } else if constexpr (U == kExp) {
    return minus_dlnf0_dv(p, x + static_cast<float>(1e-6 * c));
  } else {
    return wrap(p, x + static_cast<float>(c));
  }
}

template <int U, int K>
__device__ __forceinline__ float units(const Params<float>& p, float x) {
  float extra = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) extra += unit<U>(p, x, c);
  return extra;
}

template <int U, int K>
__device__ __forceinline__ float4 units4(const Params<float>& p, float4 x) {
  return make_float4(units<U, K>(p, x.x), units<U, K>(p, x.y), units<U, K>(p, x.z),
                     units<U, K>(p, x.w));
}

// Output j of four elements from their acc and their units' sum.
template <int U>
__device__ __forceinline__ float4 emit4(float4 a, int j, float eps, float4 e) {
  if constexpr (U == kNone) {
    return scale4(a, factor(j));
  } else {
    const float f = factor(j);
    return make_float4(a.x * f + eps * e.x, a.y * f + eps * e.y, a.z * f + eps * e.z,
                       a.w * f + eps * e.w);
  }
}

// One element by plain loads (the tails).
template <int NR, int NW, int U, int K>
__device__ __forceinline__ double one_element(const Streams& s, long long i,
                                              const UnitArgs& u) {
  const float x = s.in[0][i];
  float a = x;
#pragma unroll
  for (int r = 1; r < NR; ++r) a += s.in[r][i];
  if constexpr (U == kNone) {
#pragma unroll
    for (int j = 0; j < NW; ++j) s.out[j][i] = a * factor(j);
  } else {
    const float e = units<U, K>(u.p, x);
#pragma unroll
    for (int j = 0; j < NW; ++j) s.out[j][i] = a * factor(j) + u.eps * e;
  }
  return static_cast<double>(a);
}

// Deterministic block sum, written as this block's partial.  Every thread of
// the block must call it.
__device__ __forceinline__ void block_sum_store(double v, double* partials) {
  __shared__ double red[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    partials[blockIdx.x] = t;
  }
}

// The direct-load body: float4 loads over the first 4 * n4 elements, plain
// loads over the rest; returns this thread's sum of acc.
template <int NR, int NW, int U, int K>
__device__ __forceinline__ double rw_body(const Streams& s, long long n, long long n4,
                                          const UnitArgs& u) {
  double sum = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    const float4 x = reinterpret_cast<const float4*>(s.in[0])[i];
    float4 a = x;
#pragma unroll
    for (int r = 1; r < NR; ++r) a = add4(a, reinterpret_cast<const float4*>(s.in[r])[i]);
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (U != kNone) e = units4<U, K>(u.p, x);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      reinterpret_cast<float4*>(s.out[j])[i] = emit4<U>(a, j, u.eps, e);
    sum += hsum(a);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    sum += one_element<NR, NW, U, K>(s, i, u);
  return sum;
}

template <int NR, int NW, int U, int K>
__global__ void __launch_bounds__(kThreads)
stream_rw_kernel(const Streams s, long long n, const UnitArgs u,
                 double* __restrict__ partials) {
  block_sum_store(rw_body<NR, NW, U, K>(s, n, n / 4, u), partials);
}

// The carry probe: the plain 4r+3w body on the buffers the wrapper chose.
// With h, every stream is a (2, half) buffer: in_r is read at half *h and
// out_j written at half 1 - *h of the same allocation (disjoint addresses,
// so no __restrict__); halves that are not 16-byte aligned take plain loads.
__global__ void __launch_bounds__(kThreads)
stream_carry_kernel(const Streams s, long long n, long long half,
                    const int* __restrict__ h, double* __restrict__ partials) {
  Streams q = s;
  long long n4 = n / 4;
  if (h != nullptr) {
    const long long hv = *h;
#pragma unroll
    for (int r = 0; r < 4; ++r) q.in[r] = s.in[r] + hv * half;
#pragma unroll
    for (int j = 0; j < 3; ++j) q.out[j] = s.out[j] + (1 - hv) * half;
    if (half % 4) n4 = 0;
  }
  block_sum_store(rw_body<4, 3, kNone, 0>(q, n, n4, UnitArgs{}), partials);
}

// Fill ring slot `slot` with tile `tile_index` of every input.
template <int NR>
__device__ __forceinline__ void load_tile(const Streams& s, float* ring, uint64_t* bar,
                                          int slot, int tile, long long tile_index) {
  const uint32_t bytes = static_cast<uint32_t>(tile) * sizeof(float);
  mbar_arrive_expect_tx(&bar[slot], NR * bytes);
#pragma unroll
  for (int r = 0; r < NR; ++r)
    bulk_load(ring + (static_cast<long long>(slot) * NR + r) * tile,
              s.in[r] + tile_index * tile, bytes, &bar[slot]);
}

template <int NR, int NW, int U, int K>
__global__ void __launch_bounds__(kThreads)
stream_bulk_kernel(const Streams s, long long n, int tile, int stages, const UnitArgs u,
                   double* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const long long ntiles = n / tile;
  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bar[st], 1);
    fence_mbarrier_init();
    for (long long k = 0; k < stages && k < mine; ++k)
      load_tile<NR>(s, ring, bar, static_cast<int>(k), tile, blockIdx.x + k * gridDim.x);
  }
  __syncthreads();
  double sum = 0.0;
  for (long long k = 0; k < mine; ++k) {
    const int slot = static_cast<int>(k % stages);
    const uint32_t parity = static_cast<uint32_t>((k / stages) & 1);
    while (!mbar_try_wait(&bar[slot], parity)) {
    }
    const float4* t = reinterpret_cast<const float4*>(
        ring + static_cast<long long>(slot) * NR * tile);
    const long long base = (blockIdx.x + k * gridDim.x) * static_cast<long long>(tile);
    const int tile4 = tile / 4;
    for (int e = threadIdx.x; e < tile4; e += kThreads) {
      float4 a = t[e];
#pragma unroll
      for (int r = 1; r < NR; ++r) a = add4(a, t[r * tile4 + e]);
      float4 ex = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (U != kNone) ex = units4<U, K>(u.p, t[e]);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        reinterpret_cast<float4*>(s.out[j] + base)[e] = emit4<U>(a, j, u.eps, ex);
      sum += hsum(a);
    }
    __syncthreads();  // every thread has left this slot
    if (threadIdx.x == 0 && k + stages < mine) {
      fence_proxy_async();
      load_tile<NR>(s, ring, bar, slot, tile, blockIdx.x + (k + stages) * gridDim.x);
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = ntiles * tile + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    sum += one_element<NR, NW, U, K>(s, i, u);
  block_sum_store(sum, partials);
}

size_t bulk_smem_bytes(int nr, int tile, int stages) {
  return kBarBytes + static_cast<size_t>(stages) * nr * tile * sizeof(float);
}

template <int NR, int NW, int U = kNone, int K = 0>
cudaError_t launch_rw(const Streams& s, long long n, const UnitArgs& u, double* partials,
                      int grid, cudaStream_t st) {
  stream_rw_kernel<NR, NW, U, K><<<grid, kThreads, 0, st>>>(s, n, u, partials);
  return cudaGetLastError();
}

template <int NR, int NW, int U = kNone, int K = 0>
cudaError_t bulk_blocks_per_sm(int tile, int stages, int* per_sm) {
  const size_t smem = bulk_smem_bytes(NR, tile, stages);
  cudaError_t e = cudaFuncSetAttribute(stream_bulk_kernel<NR, NW, U, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stream_bulk_kernel<NR, NW, U, K>, kThreads, smem);
}

template <int NR, int NW, int U = kNone, int K = 0>
cudaError_t launch_bulk(const Streams& s, long long n, int tile, int stages,
                        const UnitArgs& u, double* partials, int grid, cudaStream_t st) {
  const size_t smem = bulk_smem_bytes(NR, tile, stages);
  cudaError_t e = cudaFuncSetAttribute(stream_bulk_kernel<NR, NW, U, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  stream_bulk_kernel<NR, NW, U, K><<<grid, kThreads, smem, st>>>(s, n, tile, stages, u,
                                                                 partials);
  return cudaGetLastError();
}

// The (reads, writes) patterns built: the TPU probes' 4r+1w, 4r+3w, 3r+1w and
// 4r+4w, and the port's own substep patterns 4r+2w and 6r+3w.
#define PIC1DP_PATTERNS(X) X(3, 1) X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(6, 3)

// The (unit, K) pairs built for K > 0, on the 4r+3w pattern only: the TPU
// probes' K in {1, 2, 4} on direct loads, and the K in {1, 4} the callers of
// the ring use.  K = 0 of any unit launches the kNone kernel.
#define PIC1DP_FOR_UNITS(X, K) X(kTrig, K) X(kPoly, K) X(kExp, K) X(kWrap, K)
#define PIC1DP_RW_UNITS(X) \
  PIC1DP_FOR_UNITS(X, 1) PIC1DP_FOR_UNITS(X, 2) PIC1DP_FOR_UNITS(X, 4)
#define PIC1DP_BULK_UNITS(X) PIC1DP_FOR_UNITS(X, 1) PIC1DP_FOR_UNITS(X, 4)

bool make_streams(int nr, int nw, const void* const* ins, void* const* outs,
                  Streams* s) {
  if (nr < 1 || nr > kMaxIn || nw < 1 || nw > kMaxOut) return false;
  for (int r = 0; r < kMaxIn; ++r) {
    s->in[r] = r < nr ? static_cast<const float*>(ins[r]) : nullptr;
    if (r < nr && reinterpret_cast<uintptr_t>(ins[r]) % 16) return false;
  }
  for (int j = 0; j < kMaxOut; ++j) {
    s->out[j] = j < nw ? static_cast<float*>(outs[j]) : nullptr;
    if (j < nw && reinterpret_cast<uintptr_t>(outs[j]) % 16) return false;
  }
  return true;
}

bool bulk_shape_ok(int tile, int stages) {
  return tile >= 4 && tile % 4 == 0 && stages >= 1 && stages <= kMaxStages;
}

}  // namespace

extern "C" {

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pic1dp_params_size() { return static_cast<int>(sizeof(HostParams)); }

int pic1dp_stream_rw(int nr, int nw, const void* const* ins, void* const* outs,
                     long long n, double* partials, int grid, void* stream) {
  Streams s;
  if (grid <= 0 || n < 0 || !make_streams(nr, nw, ins, outs, &s))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIC1DP_CASE(R, W) \
  if (nr == R && nw == W) return launch_rw<R, W>(s, n, UnitArgs{}, partials, grid, st);
  PIC1DP_PATTERNS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

// Blocks of stream_bulk that fit on one SM for this tile (floats per input
// and slot) and stage count; 0 when one block does not fit.
int pic1dp_stream_bulk_blocks_per_sm(int nr, int nw, int tile, int stages,
                                     int* per_sm) {
  *per_sm = 0;
  if (!bulk_shape_ok(tile, stages)) return cudaErrorInvalidValue;
#define PIC1DP_CASE(R, W) \
  if (nr == R && nw == W) return bulk_blocks_per_sm<R, W>(tile, stages, per_sm);
  PIC1DP_PATTERNS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

int pic1dp_stream_bulk(int nr, int nw, const void* const* ins, void* const* outs,
                       long long n, int tile, int stages, double* partials, int grid,
                       void* stream) {
  Streams s;
  if (grid <= 0 || n < 0 || !bulk_shape_ok(tile, stages) ||
      !make_streams(nr, nw, ins, outs, &s))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIC1DP_CASE(R, W)                                                        \
  if (nr == R && nw == W)                                                        \
    return launch_bulk<R, W>(s, n, tile, stages, UnitArgs{}, partials, grid, st);
  PIC1DP_PATTERNS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

// stream_rw on 4 reads and 3 writes with K copies of a compute unit (1 trig,
// 2 poly, 3 exp, 4 wrap) scaled by eps; h holds the units' constants.
int pic1dp_stream_units(int unit, int k, const void* const* ins, void* const* outs,
                        long long n, const HostParams* h, float eps, double* partials,
                        int grid, void* stream) {
  Streams s;
  if (grid <= 0 || n < 0 || !make_streams(4, 3, ins, outs, &s)) return cudaErrorInvalidValue;
  if (unit < kTrig || unit > kWrap) return cudaErrorInvalidValue;
  const UnitArgs u{to_params<float>(*h), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 0) return launch_rw<4, 3>(s, n, u, partials, grid, st);
#define PIC1DP_CASE(U, K) \
  if (unit == U && k == K) return launch_rw<4, 3, U, K>(s, n, u, partials, grid, st);
  PIC1DP_RW_UNITS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

int pic1dp_stream_bulk_units_blocks_per_sm(int unit, int k, int tile, int stages,
                                           int* per_sm) {
  *per_sm = 0;
  if (!bulk_shape_ok(tile, stages) || unit < kTrig || unit > kWrap)
    return cudaErrorInvalidValue;
  if (k == 0) return bulk_blocks_per_sm<4, 3>(tile, stages, per_sm);
#define PIC1DP_CASE(U, K) \
  if (unit == U && k == K) return bulk_blocks_per_sm<4, 3, U, K>(tile, stages, per_sm);
  PIC1DP_BULK_UNITS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

// stream_bulk on 4 reads and 3 writes with K copies of a compute unit.
int pic1dp_stream_bulk_units(int unit, int k, const void* const* ins, void* const* outs,
                             long long n, const HostParams* h, float eps, int tile,
                             int stages, double* partials, int grid, void* stream) {
  Streams s;
  if (grid <= 0 || n < 0 || !bulk_shape_ok(tile, stages) || unit < kTrig ||
      unit > kWrap || !make_streams(4, 3, ins, outs, &s))
    return cudaErrorInvalidValue;
  const UnitArgs u{to_params<float>(*h), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 0) return launch_bulk<4, 3>(s, n, tile, stages, u, partials, grid, st);
#define PIC1DP_CASE(U, K)                                                         \
  if (unit == U && k == K)                                                        \
    return launch_bulk<4, 3, U, K>(s, n, tile, stages, u, partials, grid, st);
  PIC1DP_BULK_UNITS(PIC1DP_CASE)
#undef PIC1DP_CASE
  return cudaErrorInvalidValue;
}

// The carry probe on 4 reads and 3 writes.  h is null (flat buffers of n) or
// a device int32 half index (buffers of 2 x half, n <= half).
int pic1dp_stream_carry(const void* const* ins, void* const* outs, long long n,
                        long long half, const int* h, double* partials, int grid,
                        void* stream) {
  Streams s;
  if (grid <= 0 || n < 0 || half < n || !make_streams(4, 3, ins, outs, &s))
    return cudaErrorInvalidValue;
  stream_carry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n, half, h, partials);
  return cudaGetLastError();
}

}  // extern "C"
