// Deterministic hat deposits onto small grids, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (pic1dp_tpu_torch/ops/hist_kernels.py).
//
// The JAX package computes these sums as one-hot contractions or segment
// sums, which repeat bit for bit on its device; they are not Pallas kernels.
// Three instantiations of one kernel family replace them (the `kind`):
//
//   kXV  the x-v snapshot histogram (pic1dp_tpu/core/diagnostics.py:78
//        deposit_xv): k value channels of one species onto the (nv, nx)
//        diagnostic grid, hat weights in x (periodic) and in v (inclusive
//        [-v_max, v_max], markers with |v| >= v_max skipped): four corners
//        a marker.  The channels are the k rows of a (k, n) array (kVals),
//        or the snapshot's three read from the state itself (kState): the
//        live byte, p (of T or bfloat16) and w, as 1, p and w where live
//        and 0 where dead.  Each block also sums v^2 value over all of its
//        markers, those with |v| >= v_max included (kState: the live ones),
//        its channel's moment: the energies' raw sums (diagnostics.py:57);
//   kV   the |delta f|(v) profile that drives merge/remove/split
//        (diagnostics.py:184 dist_pertb_abs_v): |w| of the live markers with
//        |v| < v_max onto nv points per species, (ns, n) -> (ns, nv);
//   kX   the grid charge (pic1dp_tpu/ops/deposit.py:46-140): val at x onto
//        the periodic (nx,) grid, (ns, n) -> (nx,), every species summed.
//
// Each marker's hat weights are those of ops/interp.py (hat_x, hat_v), at
// the arithmetic type T, with the host's scale factors rounded to T as
// PyTorch rounds a Python float in a T tensor's product; each term is the
// plain version's rounded product ((wv wx) val for kXV, w val for kV and
// kX), and no product is fused into a sum (mul_rn, add_rn).
//
// No float atomic anywhere, and the order of every sum is fixed by n, the
// kind, k, the grid, T and the card's SM count, so a launch repeats bit for
// bit, a replay from a CUDA graph included.  A block deposits one channel
// (kXV: channel blockIdx.x % k, so the k blocks that read one marker range
// run side by side and share its x and v through L2); its warps walk their
// own ranges of markers in rounds of 32 M, lane l taking M = kMarkers in a
// row (16-byte loads where every stream is aligned), the next round's loads
// issued before this round's deposits.  The block's grids take one of three
// forms (plan):
//
//   kLanes  (kV, kX on grids small enough that 32 copies a warp fit for at
//           least kLaneWarpsMin warps): every lane owns a copy of the nbins
//           values, laid out cell-major (cell c of lane l at 32 c + l, no
//           bank conflict), and adds its markers' two halves at their two
//           cells itself: no warp step at all.  The tail sums each cell's
//           32 lanes (each thread from its own lane on, so no bank
//           conflict), then the warps in warp order.
//   kWarps  a grid copy of 2 nbins values to each `share` warps (kShare for
//           kXV, one for the others), in shared memory: a marker deposits in
//           a warp step.  The lanes that share a cell are found by a claim
//           (kXV, lanes_of_cell) or __match_any_sync; the lowest of them
//           adds the others' terms to its own in lane order (shuffles) and
//           alone adds the sums to the copy, a (left, right) pair per cell:
//           the left half at cell ix0, the right half, which belongs to ix0
//           + 1, beside it.  kXV adds the v row iv0 at cell iv0 nx + ix0,
//           then, after a __syncwarp, row iv0 + 1 one row up: one warp step
//           serves all four corners.  The warps that share a copy take their
//           grid steps of a round in turn, between named barriers of their
//           own; no warp waits on the whole block inside the marker loop.
//           The tail folds each right half onto its neighbour (periodic in
//           x, none past the last v point) copy by copy.
//   kBuffer where not even one copy fits in shared memory: kWarps with one
//           warp a block, whose copy is its slice of a device buffer.
//
// Each block writes its part of a row of partials (G rows, one a marker
// range: k nbins values, then for kXV the k channels' moments); a second
// kernel sums the G rows of every output value: row group g of 16 sums
// rows g, g + 16, ... in order, the groups' sums added in group order
// (hist_sum_kernel).  A kXV block's moment is its lanes' own sums (each
// round's markers over a fixed tree, the rounds in order), added over a
// fixed tree of the warp's lanes, then warp by warp in warp order.  No counter, so nothing needs resetting between
// launches or graph replays.  Sums are taken at T, the output's type, as
// the plain versions' index_add_ takes them; only the order differs.
//
// What bounds them on this card: the bytes of the marker streams (x, v and
// k channels for kXV, or x, v, the live byte, p and w; v, w and the live
// byte for kV; x and val for kX) over HBM, and for kXV the warp steps: __match_any_sync costs the SM a step for
// about every distinct cell of a warp (hence the claim), and each warp's
// chain of claims, sums and shared-memory read-modify-writes waits on
// itself, so the SM needs as many warps as the copies allow (hence two a
// copy).

#include <cuda_runtime.h>
#include <stdint.h>

#include "substep_math.cuh"

namespace {

constexpr int kMaxCopies = 8;         // grid copies (kLanes: warps) a block at most
constexpr int kShare = 2;             // kXV: warps that share one grid copy
constexpr int kLaneWarpsMin = 4;      // kLanes where this many warps' lane copies fit
// markers a lane takes per round (multiples of 4), the fastest of 4 to 32
// timed on an H100 (PERF.md §6, the hist kernels' redesign): kXV, and kV and kX
constexpr int kMXV = 8;
constexpr int kMX = 16;
constexpr int kMaxK = 3;
// One block's dynamic shared memory at most with an opt-in (232,448 bytes
// on sm_90); the kernels use no static shared memory but the row sum's.
constexpr int kSmemMax = 232448;
constexpr int kSmemNoOptIn = 48 * 1024;
// blocks an SM at most: more rows of partials buy nothing once the SMs are
// full
constexpr int kMaxBlocksPerSm = 4;
// the row sum: a block of kSumValues output values x kSumGroups row groups
constexpr int kSumValues = 32;
constexpr int kSumGroups = 16;

enum Kind { kXV = 0, kV = 1, kX = 2 };
enum Form { kLanes = 0, kWarps = 1, kBuffer = 2 };
// where kXV's channels come from: the rows of c, or the state
enum Source { kVals = 0, kState = 1 };

template <int KIND>
constexpr int kMarkers = KIND == kXV ? kMXV : kMX;

// A warp's claim table (lanes_of_cell) for kXV: a byte a slot, the power of
// two of slots from 16 that holds nbins, at most kClaimMax (cell c claims
// slot c mod the size); none for the others, whose few cells nearly always
// put two lanes of a warp on one.
constexpr int kClaimMax = 2048;
__host__ __device__ constexpr int claim_bytes(int kind, int nbins) {
  int size = 16;
  while (size < nbins && size < kClaimMax) size *= 2;
  return kind == kXV ? size : 0;
}

// How a block holds its grids: the form, its copies (kLanes: warps of 32
// lane copies), its warps and its shared memory.
struct Plan {
  int form, copies, warps, smem;
};

Plan plan(int itemsize, int kind, int nbins) {
  const long long lanes = 32LL * nbins * itemsize;
  if (kind != kXV && kSmemMax / lanes >= kLaneWarpsMin) {
    const int w = static_cast<int>(kSmemMax / lanes < kMaxCopies ? kSmemMax / lanes : kMaxCopies);
    return {kLanes, w, w, static_cast<int>(w * lanes)};
  }
  const int share = kind == kXV ? kShare : 1;
  const long long claim = claim_bytes(kind, nbins);
  const long long copy = 2LL * nbins * itemsize + share * claim;
  if (kSmemMax / copy >= 1) {
    const int c = static_cast<int>(kSmemMax / copy < kMaxCopies ? kSmemMax / copy : kMaxCopies);
    return {kWarps, c, c * share, static_cast<int>(c * copy)};
  }
  return {kBuffer, 1, 1, static_cast<int>(claim)};
}

template <typename T>
struct Args {
  const T* a;                 // kXV, kX: x; kV: v
  const T* b;                 // kXV: v; kV: w; kX: val
  const void* c;              // kXV: the k channels (k, n), or (kState) p; kV: live (bool);
                              // kX: unused
  int source;                 // kXV: kVals or kState
  bool p_bf16;                // kState: p is bfloat16, else T
  const unsigned char* live;  // kState: the live mask (bool)
  const T* w;                 // kState: w
  long long n;                // markers (kV, kX: ns * n_species)
  long long n_species;        // kV: markers per species
  long long per_warp;         // markers per warp, a multiple of 32 kMarkers
  int nx, nv, nbins;          // nbins: cells of one channel's grid
  int k;                      // output channels (kXV), 1 otherwise
  int row;                    // values of a row of partials: k nbins, + k moments (kXV)
  T x_scale;                  // nx / lx
  T v_max, v_scale;           // v_max, (nv - 1) / (2 v_max)
  int form, copies, warps;    // the block's Plan
  bool vec;                   // every stream 16-byte aligned (live, a bfloat16 p: 4-byte)
  T* grids;                   // kBuffer: the device buffer, a copy a block
  T* partials;                // (G, row)
};

__device__ __forceinline__ double abs_t(double s) { return fabs(s); }
__device__ __forceinline__ float abs_t(float s) { return fabsf(s); }

// Rounded products, sums and differences that ptxas may not fuse into an
// FMA: each term is the plain version's rounded product, and each sum adds
// rounded terms, whatever the compiler schedules.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// hat_x: cell ix0 in [0, nx) and the fraction f of an x in [0, lx).
template <typename T>
__device__ __forceinline__ int hat_xcell(T x, T scale, int n, T* frac) {
  const T s = mul_rn(x, scale);
  const T fl = floor_t(s);
  *frac = sub_rn(s, fl);
  // the conversion saturates, so the clamp holds for any x
  return min(max(static_cast<int>(fl), 0), n - 1);
}

// hat_v: cell iv0 in [0, nv - 2] and the fraction f; *inside is |v| < v_max.
template <typename T>
__device__ __forceinline__ int hat_vcell(T v, T v_max, T scale, int nv, T* frac, bool* inside) {
  const T s = mul_rn(add_rn(v, v_max), scale);
  const T fl = floor_t(s);
  *frac = sub_rn(s, fl);
  *inside = abs_t(v) < v_max;
  if (!*inside) return 0;   // its cell is never read
  return min(max(static_cast<int>(fl), 0), nv - 2);
}

// The cell a marker's right half lands on (kLanes): the next, periodic in
// x (kX); the next v point of the same species (kV: iv0 <= nv - 2).
template <int KIND>
__device__ __forceinline__ int right_cell(int cell, int nx) {
  if constexpr (KIND == kX) return cell == nx - 1 ? 0 : cell + 1;
  return cell + 1;
}

// The grid value a right half at cell `o`'s left neighbour adds to output
// o (kWarps), or -1 where none does: x is periodic (kXV within a v row,
// kX); the v grid of kV has no point before the first of each species.
template <int KIND>
__device__ __forceinline__ int left_neighbour(int o, int nx, int nv) {
  if constexpr (KIND == kV) {
    return o % nv == 0 ? -1 : o - 1;
  } else {
    const int j = o % nx;
    return j == 0 ? o + nx - 1 : o - 1;
  }
}

// o[0..3] = p[0..3] in 16-byte loads (p 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}
__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 f = reinterpret_cast<const double2*>(p)[0];
  const double2 g = reinterpret_cast<const double2*>(p)[1];
  o[0] = f.x;
  o[1] = f.y;
  o[2] = g.x;
  o[3] = g.y;
}
__device__ __forceinline__ void load4(const unsigned char* p, unsigned char* o) {
  const uchar4 f = *reinterpret_cast<const uchar4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}

// A bfloat16's value at T, exactly (its bits are a float's upper half).
template <typename T>
__device__ __forceinline__ T bf16_value(unsigned bits) {
  return static_cast<T>(__uint_as_float(bits << 16));
}

// out[j] = p[i + j] for the `valid` of the M markers from i that exist, 0
// past them; vector loads where vec and all M exist (i is a multiple of M).
template <typename U, int M>
__device__ __forceinline__ void load_run(const U* p, long long i, int valid, bool vec,
                                         U (&out)[M]) {
  if (vec && valid == M) {
#pragma unroll
    for (int q = 0; q < M; q += 4) load4(p + i + q, out + q);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) out[j] = j < valid ? p[i + j] : U(0);
  }
}

// out[q] = the 4 / sizeof(U) values of p from i + q 4 / sizeof(U) as one
// word, the first in the low bits, 0 past the `valid` of the M markers from
// i; 4-byte loads where vec and all M exist (p + i 4-byte aligned).
template <int M, typename U>
__device__ __forceinline__ void load_words(const U* p, long long i, int valid, bool vec,
                                           unsigned (&out)[M * sizeof(U) / 4]) {
  constexpr int per = 4 / sizeof(U);
  if (vec && valid == M) {
#pragma unroll
    for (int q = 0; q < M / per; ++q) out[q] = reinterpret_cast<const unsigned*>(p + i)[q];
  } else {
#pragma unroll
    for (int q = 0; q < M / per; ++q) {
      unsigned word = 0u;
#pragma unroll
      for (int e = 0; e < per; ++e)
        if (q * per + e < valid)
          word |= static_cast<unsigned>(p[i + q * per + e]) << (8 * sizeof(U) * e);
      out[q] = word;
    }
  }
}

// One lane's kMarkers markers: the two streams a and b; for kXV the block's
// channel and which markers count in its moment (bit j for marker j), and
// from the state the live bytes and p's bfloat16 halves as loaded, four and
// two a word, which `settle` turns into the channel only when the round
// uses the batch (a use where it is loaded would wait there for the loads
// that should stay in flight); the live bytes for kV.
template <typename T, int KIND>
struct Batch {
  static constexpr int M = kMarkers<KIND>;
  T a[M], b[M];
  T c[KIND == kXV ? M : 1];
  unsigned char live[KIND == kV ? M : 1];
  unsigned live4[KIND == kXV ? M / 4 : 1];
  unsigned half2[KIND == kXV ? M / 2 : 1];
  unsigned counted;
};

template <typename T, int KIND>
__device__ __forceinline__ void load_batch(Batch<T, KIND>& m, const Args<T>& a, int ch,
                                           long long i, int valid) {
  load_run(a.a, i, valid, a.vec, m.a);
  load_run(a.b, i, valid, a.vec, m.b);
  if constexpr (KIND == kXV) {
    if (a.source == kVals) {
      load_run(static_cast<const T*>(a.c) + ch * a.n, i, valid, a.vec, m.c);
    } else {
      // channel 0 the live byte, 1 p, 2 w
      constexpr int M = kMarkers<KIND>;
      load_words<M>(a.live, i, valid, a.vec, m.live4);
      if (ch == 1 && a.p_bf16)
        load_words<M>(static_cast<const unsigned short*>(a.c), i, valid, a.vec, m.half2);
      else if (ch != 0)
        load_run(ch == 1 ? static_cast<const T*>(a.c) : a.w, i, valid, a.vec, m.c);
    }
  } else if constexpr (KIND == kV) {
    load_run(static_cast<const unsigned char*>(a.c), i, valid, a.vec, m.live);
  }
}

// kXV: a loaded batch's channel and the markers its moment counts: from the
// state 1, p (at T) or w where live and 0 where dead, the live ones; every
// marker of the rows of c.
template <typename T, int KIND>
__device__ __forceinline__ void settle(Batch<T, KIND>& m, const Args<T>& a, int ch) {
  constexpr int M = kMarkers<KIND>;
  if (a.source == kVals) {
    m.counted = ~0u;
    return;
  }
  m.counted = 0u;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const bool live = (m.live4[j / 4] >> (8 * (j % 4)) & 0xffu) != 0u;
    const T val = ch == 0 ? T(1)
                  : ch == 1 && a.p_bf16 ? bf16_value<T>(m.half2[j / 2] >> (16 * (j % 2)) & 0xffffu)
                                        : m.c[j];
    m.c[j] = live ? val : T(0);
    m.counted |= static_cast<unsigned>(live) << j;
  }
}

// Rows of a marker's terms: kXV's two v rows, one row for kV and kX.
template <int KIND>
constexpr int kRows = KIND == kXV ? 2 : 1;

// A lane's marker in a round: its cell (-1: it deposits nothing) and its
// terms, rows x (left half, right half).
template <typename T, int R>
struct Term {
  int cell;
  T v[R][2];
};

// Marker j of a lane's batch (index i, kept where j < valid): its cell
// and terms.
template <typename T, int KIND>
__device__ __forceinline__ void marker_terms(const Args<T>& a, const Batch<T, KIND>& m, int j,
                                             long long i, int valid,
                                             Term<T, kRows<KIND>>& t) {
  t.cell = -1;
  if constexpr (KIND == kXV) {
    T fx, fv;
    bool inside;
    const int ix0 = hat_xcell(m.a[j], a.x_scale, a.nx, &fx);
    const int iv0 = hat_vcell(m.b[j], a.v_max, a.v_scale, a.nv, &fv, &inside);
    const T wx0 = sub_rn(T(1), fx), wv0 = sub_rn(T(1), fv), val = m.c[j];
    t.v[0][0] = mul_rn(mul_rn(wv0, wx0), val);
    t.v[0][1] = mul_rn(mul_rn(wv0, fx), val);
    t.v[1][0] = mul_rn(mul_rn(fv, wx0), val);
    t.v[1][1] = mul_rn(mul_rn(fv, fx), val);
    if (inside && j < valid) t.cell = iv0 * a.nx + ix0;
  } else if constexpr (KIND == kV) {
    T fv;
    bool inside;
    const int iv0 = hat_vcell(m.a[j], a.v_max, a.v_scale, a.nv, &fv, &inside);
    const T val = abs_t(m.b[j]);
    t.v[0][0] = mul_rn(sub_rn(T(1), fv), val);
    t.v[0][1] = mul_rn(fv, val);
    if (inside && m.live[j] != 0 && j < valid)
      t.cell = static_cast<int>(i / a.n_species) * a.nv + iv0;
  } else {
    T fx;
    const int ix0 = hat_xcell(m.a[j], a.x_scale, a.nx, &fx);
    const T val = m.b[j];
    t.v[0][0] = mul_rn(sub_rn(T(1), fx), val);
    t.v[0][1] = mul_rn(fx, val);
    if (j < valid) t.cell = ix0;
  }
}

// The lanes that share this lane's cell: __match_any_sync's answer, which
// costs the SM a warp step for about every distinct cell in the warp.  Where
// cells are many (kXV), most warps have no two lanes on one cell, so a
// claim first: every lane writes its lane number at its cell's slot in the
// warp's claim table (claim_bytes), and where every lane reads its own
// number back, no two share a slot, so none share a cell, and each lane is
// alone; otherwise the match (two cells on one slot cost a match, never a
// wrong sum).  Which lane's byte lands does not matter: a lane that reads
// another's number means two lanes share a slot, whichever it is.  The
// table needs no reset (a lane reads only the slot it has just written).
template <int KIND>
__device__ __forceinline__ unsigned lanes_of_cell(unsigned char* claim, int slots, int cell) {
  const unsigned lane = threadIdx.x & 31u;
  if constexpr (KIND == kXV) {
    const int slot = cell & (slots - 1);
    if (cell >= 0) claim[slot] = static_cast<unsigned char>(lane);
    __syncwarp();
    const bool shared = cell >= 0 && claim[slot] != lane;
    __syncwarp();
    if (!__any_sync(0xffffffffu, shared)) return 1u << lane;
  }
  return __match_any_sync(0xffffffffu, cell);
}

// Given peers, the lanes that share this lane's cell: the lowest of them
// adds the others' terms to its own in lane order (shuffles); returns
// whether this lane adds the sums to the grid (the lowest of its cell,
// cell >= 0).  Every lane of the warp must call it.
template <typename T, int R>
__device__ __forceinline__ bool gather_peers(unsigned peers, Term<T, R>& t) {
  const unsigned lane = threadIdx.x & 31u;
  const bool lead = (peers & ((1u << lane) - 1u)) == 0u && t.cell >= 0;
  unsigned rest = lead ? peers & ~((2u << lane) - 1u) : 0u;
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int src = rest != 0u ? __ffs(rest) - 1 : static_cast<int>(lane);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T x = __shfl_sync(0xffffffffu, t.v[r][h], src);
        if (rest != 0u) t.v[r][h] = add_rn(t.v[r][h], x);
      }
    rest &= rest - 1u;
  }
  return lead;
}

// grid[2 j] += l and grid[2 j + 1] += r in one 8- or 16-byte access.
__device__ __forceinline__ void add_pair(float* g, int j, float l, float r) {
  float2* q = reinterpret_cast<float2*>(g) + j;
  float2 t = *q;
  t.x = add_rn(t.x, l);
  t.y = add_rn(t.y, r);
  *q = t;
}
__device__ __forceinline__ void add_pair(double* g, int j, double l, double r) {
  double2* q = reinterpret_cast<double2*>(g) + j;
  double2 t = *q;
  t.x = add_rn(t.x, l);
  t.y = add_rn(t.y, r);
  *q = t;
}

// grid pair (cell + r row) += (v[r][0], v[r][1]) on the leading lanes, row
// by row, each row ended by __syncwarp (row r + 1 of one cell may be row r
// of another).  Every lane of the warp must call it.
template <typename T, int R>
__device__ __forceinline__ void add_terms(T* grid, int row, bool lead, const Term<T, R>& t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lead) add_pair(grid, t.cell + r * row, t.v[r][0], t.v[r][1]);
    __syncwarp();
  }
}

// bar.sync on named barrier id (1 + a copy's index) for the nthreads of
// the warps that share the copy.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// The markers of a lane's run of M from i that exist before end, 0 to M.
template <int M>
__device__ __forceinline__ int valid_from(long long i, long long end) {
  return static_cast<int>(i >= end ? 0 : end - i < M ? end - i : M);
}

// One warp's markers [begin, end) onto its lane copies (kLanes; g: cell c
// of this warp's lane l at 32 c + l), in `rounds` rounds of 32 M, the
// next round's loads issued first: each lane adds its markers' halves at
// their two cells in marker order.
template <typename T, int KIND>
__device__ __forceinline__ void walk_lanes(const Args<T>& a, T* g, long long begin, long long end,
                                           long long rounds) {
  constexpr int M = kMarkers<KIND>;
  const int lane = threadIdx.x & 31;
  const long long lane_off = static_cast<long long>(lane) * M;
  T* mine = g + lane;
  Batch<T, KIND> cur, nxt;
  if (rounds > 0) load_batch(cur, a, 0, begin + lane_off, valid_from<M>(begin + lane_off, end));
  for (long long r = 0; r < rounds; ++r) {
    const long long base = begin + r * 32 * M, next = base + 32 * M + lane_off;
    if (r + 1 < rounds) load_batch(nxt, a, 0, next, valid_from<M>(next, end));
    const int valid = valid_from<M>(base + lane_off, end);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Term<T, 1> t;
      marker_terms(a, cur, j, base + lane_off + j, valid, t);
      if (t.cell >= 0) {
        T* left = mine + 32 * t.cell;
        T* right = mine + 32 * right_cell<KIND>(t.cell, a.nx);
        *left = add_rn(*left, t.v[0][0]);
        *right = add_rn(*right, t.v[0][1]);
      }
    }
    cur = nxt;
  }
}

// One warp's markers [begin, end) onto its grid copy (kWarps, kBuffer), in
// `rounds` rounds of 32 M (the same count for every warp, markers past end
// none): the next round's loads issued first; then every marker's terms,
// every marker's lanes of its cell and lanes' sums, and last the markers'
// grid steps one after another, so that only the grid steps wait on each
// other.  The `share` warps of one copy (member 0, 1, ... of copy `copy`)
// take the grid steps of a round in member order, between named barriers
// of their own.  Returns the lane's moment (kXV: v^2 value of its markers,
// kState: the live ones; each round's M summed over a fixed tree, the
// rounds in order), 0 for the others.
template <typename T, int KIND>
__device__ __forceinline__ T walk_warps(const Args<T>& a, T* grid, unsigned char* claim, int ch,
                                        long long begin, long long end, long long rounds,
                                        int share, int copy, int member) {
  constexpr int R = kRows<KIND>, M = kMarkers<KIND>;
  const int slots = claim_bytes(KIND, a.nbins);
  const long long lane_off = static_cast<long long>(threadIdx.x & 31) * M;
  Batch<T, KIND> cur, nxt;
  T moment = T(0);
  if (rounds > 0) load_batch(cur, a, ch, begin + lane_off, valid_from<M>(begin + lane_off, end));
  for (long long r = 0; r < rounds; ++r) {
    const long long base = begin + r * 32 * M, next = base + 32 * M + lane_off;
    if (r + 1 < rounds) load_batch(nxt, a, ch, next, valid_from<M>(next, end));
    const int valid = valid_from<M>(base + lane_off, end);
    if constexpr (KIND == kXV) settle(cur, a, ch);
    Term<T, R> t[M];
    unsigned peers[M];
    bool lead[M];
#pragma unroll
    for (int j = 0; j < M; ++j) marker_terms(a, cur, j, base + lane_off + j, valid, t[j]);
    if constexpr (KIND == kXV) {
      // the round's terms (0 where not counted) over a fixed tree, then onto
      // the lane's sum: a chain of one add a round, not one a marker
      T term[M];
#pragma unroll
      for (int j = 0; j < M; ++j)
        term[j] = j < valid && (cur.counted >> j & 1u) != 0u
                      ? mul_rn(mul_rn(cur.b[j], cur.b[j]), cur.c[j]) : T(0);
#pragma unroll
      for (int d = 1; d < M; d *= 2)
#pragma unroll
        for (int j = 0; j < M; j += 2 * d) term[j] = add_rn(term[j], term[j + d]);
      moment = add_rn(moment, term[0]);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) peers[j] = lanes_of_cell<KIND>(claim, slots, t[j].cell);
#pragma unroll
    for (int j = 0; j < M; ++j) lead[j] = gather_peers(peers[j], t[j]);
    for (int turn = 0; turn < share; ++turn) {
      if (member == turn) {
#pragma unroll
        for (int j = 0; j < M; ++j) add_terms(grid, a.nx, lead[j], t[j]);
      }
      if constexpr (KIND == kXV && kShare > 1) {
        if (share > 1) group_sync(1 + copy, 32 * share);
      }
    }
    cur = nxt;
  }
  return moment;
}

// The sum of the warp's 32 values, over a fixed tree (lane l adds lane l +
// d for d = 16, 8, 4, 2, 1), in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s = add_rn(s, __shfl_down_sync(0xffffffffu, s, d));
  return s;
}

// a block's threads at most: its copies' sharing warps
template <int KIND>
constexpr int kMaxThreads = kMaxCopies * (KIND == kXV ? kShare : 1) * 32;

template <typename T, int KIND>
__global__ void __launch_bounds__(kMaxThreads<KIND>) hist_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / a.k, ch = blockIdx.x % a.k;
  const int warp = threadIdx.x >> 5;
  const long long begin = (static_cast<long long>(b) * a.warps + warp) * a.per_warp;
  const long long end = begin + a.per_warp < a.n ? begin + a.per_warp : a.n;
  const long long rounds = a.per_warp / (32 * kMarkers<KIND>);
  T* row = a.partials + static_cast<long long>(b) * a.row + ch * a.nbins;

  if constexpr (KIND != kXV) {
    if (a.form == kLanes) {
      T* g = reinterpret_cast<T*>(smem_raw);       // [warp][cell][lane]
      const int cells = a.warps * a.nbins;
      for (int j = threadIdx.x; j < 32 * cells; j += blockDim.x) g[j] = T(0);
      __syncthreads();
      walk_lanes<T, KIND>(a, g + 32 * warp * a.nbins, begin, end, rounds);
      __syncthreads();
      // each warp's cell: its 32 lanes from lane q % 32 on, wrapping (so a
      // warp of threads reads 32 banks), into that lane's slot
      for (int q = threadIdx.x; q < cells; q += blockDim.x) {
        const int first = q & 31;
        T* cell = g + 32 * q;
        T acc = cell[first];
        for (int l = 1; l < 32; ++l) acc = add_rn(acc, cell[(first + l) & 31]);
        cell[first] = acc;
      }
      __syncthreads();
      for (int o = threadIdx.x; o < a.nbins; o += blockDim.x) {
        T acc = T(0);
        for (int w = 0; w < a.warps; ++w) {
          const int q = w * a.nbins + o;
          acc = add_rn(acc, g[32 * q + (q & 31)]);
        }
        row[o] = acc;
      }
      return;
    }
  }

  const int share = a.warps / a.copies, copy = warp / share, member = warp % share;
  const long long gstride = 2LL * a.nbins;   // one copy: nbins (left, right) pairs
  T* grids = a.form == kBuffer ? a.grids + static_cast<long long>(blockIdx.x) * gstride
                               : reinterpret_cast<T*>(smem_raw);
  // the warps' claim tables (kXV) after the copies in shared memory
  unsigned char* claim = smem_raw + (a.form == kBuffer ? 0 : a.copies * gstride * sizeof(T)) +
                         warp * claim_bytes(KIND, a.nbins);
  for (long long j = threadIdx.x; j < a.copies * gstride; j += blockDim.x) grids[j] = T(0);
  __syncthreads();
  // two calls, so that the shared-memory one addresses shared memory directly
  T moment;
  if (a.form == kBuffer)
    moment = walk_warps<T, KIND>(a, grids, claim, ch, begin, end, rounds, 1, 0, 0);
  else
    moment = walk_warps<T, KIND>(a, reinterpret_cast<T*>(smem_raw) + copy * gstride, claim, ch,
                                 begin, end, rounds, share, copy, member);
  if constexpr (KIND == kXV) {
    // the warp's moment at the start of its claim table, which the warp has
    // done with (8-byte aligned: the copies and the tables are multiples of 8)
    moment = warp_sum(moment);
    if ((threadIdx.x & 31) == 0) *reinterpret_cast<T*>(claim) = moment;
  }
  __syncthreads();
  if constexpr (KIND == kXV) {
    // the block's moment: the warps' in warp order (thread 0's table is warp 0's)
    if (threadIdx.x == 0) {
      const int table = claim_bytes(KIND, a.nbins);
      T acc = *reinterpret_cast<const T*>(claim);
      for (int w = 1; w < a.warps; ++w)
        acc = add_rn(acc, *reinterpret_cast<const T*>(claim + w * table));
      a.partials[static_cast<long long>(b) * a.row + a.k * a.nbins + ch] = acc;
    }
  }

  // the tail: left half + its left neighbour's right half, copy by copy
  for (int o = threadIdx.x; o < a.nbins; o += blockDim.x) {
    const int prev = left_neighbour<KIND>(o, a.nx, a.nv);
    T acc = T(0);
    for (int w = 0; w < a.copies; ++w) {
      const T* g = grids + w * gstride;
      acc = add_rn(acc, g[2 * o]);
      if (prev >= 0) acc = add_rn(acc, g[2 * prev + 1]);
    }
    row[o] = acc;
  }
}

// out[o] = the sum of the `rows` rows' value o: row group g sums rows g,
// g + kSumGroups, ... in order, and the groups' sums are added in group
// order.
template <typename T>
__global__ void __launch_bounds__(kSumValues * kSumGroups)
    hist_sum_kernel(const T* partials, int rows, int values, T* out) {
  __shared__ T part[kSumGroups][kSumValues];
  const int lane = threadIdx.x % kSumValues, g = threadIdx.x / kSumValues;
  const int o = blockIdx.x * kSumValues + lane;
  T acc = T(0);
  if (o < values) {
#pragma unroll 4
    for (int r = g; r < rows; r += kSumGroups)
      acc = add_rn(acc, partials[static_cast<long long>(r) * values + o]);
  }
  part[g][lane] = acc;
  __syncthreads();
  if (g == 0 && o < values) {
    T s = part[0][lane];
#pragma unroll
    for (int q = 1; q < kSumGroups; ++q) s = add_rn(s, part[q][lane]);
    out[o] = s;
  }
}

template <typename T>
const void* pick(int kind) {
  if (kind == kXV) return reinterpret_cast<const void*>(&hist_kernel<T, kXV>);
  if (kind == kV) return reinterpret_cast<const void*>(&hist_kernel<T, kV>);
  return reinterpret_cast<const void*>(&hist_kernel<T, kX>);
}

bool valid_kind(int kind, int k) {
  return (kind == kXV && k >= 1 && k <= kMaxK) || ((kind == kV || kind == kX) && k == 1);
}

uintptr_t misalign(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to;
}

// Check a launch and run both kernels: the deposit on `blocks` x k blocks
// of the plan's W warps, block b's warp w taking per_warp markers from
// (b W + w) per_warp (none when there are no markers), then the sum of the
// blocks' rows into out.  kXV takes its channels from the state where live
// is given (kState: k = 3, c = p of p_bytes, 2 for bfloat16, and w), else
// from c (kVals).
template <typename T>
int launch(int kind, int k, const void* a, const void* b, const void* c, const void* live,
           const void* w, int p_bytes, long long n, int ns, int nx, int nv, double lx,
           double v_max, void* grids, int blocks, long long per_warp, void* partials, void* out,
           void* stream) {
  const long long total = n * ns;
  const bool state = live != nullptr;
  if (!valid_kind(kind, k) || ns < 1 || (kind == kXV && ns != 1) || nx < 1 || nv < 2 ||
      n < 0 || blocks < 0 || out == nullptr || !(lx > 0.0) || !(v_max > 0.0))
    return cudaErrorInvalidValue;
  if (state ? kind != kXV || k != kMaxK || c == nullptr || w == nullptr ||
                  (p_bytes != 2 && p_bytes != static_cast<int>(sizeof(T)))
            : w != nullptr)
    return cudaErrorInvalidValue;
  const long long nbins = kind == kXV ? static_cast<long long>(nv) * nx
                          : kind == kV ? static_cast<long long>(ns) * nv : nx;
  if (nbins * 32 * k > (1LL << 31) - 1) return cudaErrorInvalidValue;
  const int row = static_cast<int>(k * nbins + (kind == kXV ? k : 0));
  const Plan p = plan(static_cast<int>(sizeof(T)), kind, static_cast<int>(nbins));
  const long long span = p.warps * per_warp;   // markers a block
  const int markers = kind == kXV ? kMXV : kMX;
  if (total > 0 && (blocks < 1 || per_warp < 1 || per_warp % (32 * markers) != 0 ||
                    (blocks - 1) * span >= total || blocks * span < total ||
                    static_cast<long long>(blocks) * k > (1LL << 31) - 1 ||
                    partials == nullptr || (p.form == kBuffer && grids == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    Args<T> args{};
    args.a = static_cast<const T*>(a);
    args.b = static_cast<const T*>(b);
    args.c = c;
    args.source = state ? kState : kVals;
    args.p_bf16 = state && p_bytes == 2;
    args.live = static_cast<const unsigned char*>(live);
    args.w = static_cast<const T*>(w);
    args.n = total;
    args.n_species = n;
    args.per_warp = per_warp;
    args.nx = nx;
    args.nv = nv;
    args.nbins = static_cast<int>(nbins);
    args.k = k;
    args.row = row;
    args.x_scale = static_cast<T>(nx / lx);
    args.v_max = static_cast<T>(v_max);
    args.v_scale = static_cast<T>((nv - 1) / (2.0 * v_max));
    args.form = p.form;
    args.copies = p.copies;
    args.warps = p.warps;
    args.vec = misalign(a, 16) == 0 && misalign(b, 16) == 0 &&
               (kind != kXV || state ||
                (misalign(c, 16) == 0 && (n * sizeof(T)) % 16 == 0)) &&
               (!state || (misalign(live, 4) == 0 && misalign(w, 16) == 0 &&
                           misalign(c, p_bytes == 2 ? 4 : 16) == 0)) &&
               (kind != kV || misalign(c, 4) == 0);
    args.grids = p.form == kBuffer ? static_cast<T*>(grids) : nullptr;
    args.partials = static_cast<T*>(partials);
    const dim3 grid(static_cast<unsigned>(blocks * k));
    const int threads = 32 * p.warps;
    if (kind == kXV) hist_kernel<T, kXV><<<grid, threads, p.smem, st>>>(args);
    else if (kind == kV) hist_kernel<T, kV><<<grid, threads, p.smem, st>>>(args);
    else hist_kernel<T, kX><<<grid, threads, p.smem, st>>>(args);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {
    blocks = 0;
  }
  hist_sum_kernel<T><<<(row + kSumValues - 1) / kSumValues, kSumValues * kSumGroups, 0, st>>>(
      static_cast<const T*>(partials), blocks, row, static_cast<T*>(out));
  return cudaGetLastError();
}

// The plan of a launch (its form, copies, warps and shared memory), its
// kernel opted in to the most shared memory on the current device where the
// plan needs more than 48 KB (a smaller opt-in would refuse a later launch
// on another grid that needs more), and the blocks of it an SM holds (at
// most kMaxBlocksPerSm; 1 for kBuffer, whose buffer grows with the blocks).
template <typename T>
int configure(int kind, int nbins, int* form, int* copies, int* warps, int* smem,
              int* blocks_per_sm) {
  if (!valid_kind(kind, 1) || nbins < 1 || static_cast<long long>(nbins) * 32 > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const Plan p = plan(static_cast<int>(sizeof(T)), kind, nbins);
  *form = p.form;
  *copies = p.copies;
  *warps = p.warps;
  *smem = p.smem;
  const void* fn = pick<T>(kind);
  if (p.smem > kSmemNoOptIn) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * p.warps, p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks_per_sm = p.form == kBuffer ? 1 : per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The constants the host mirrors (ops/hist_kernels.py), in one array:
// kMaxCopies, kShare, kLaneWarpsMin, kMXV, kMX, kSmemMax, kSumGroups,
// kClaimMax.
void pic1dp_hist_constants(int* out) {
  const int c[] = {kMaxCopies, kShare, kLaneWarpsMin, kMXV, kMX, kSmemMax, kSumGroups, kClaimMax};
  for (int i = 0; i < 8; ++i) out[i] = c[i];
}

const char* pic1dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// configure() at itemsize 4 (float) or 8 (double).
int pic1dp_hist_configure(int itemsize, int kind, int nbins, int* form, int* copies, int* warps,
                          int* smem, int* blocks_per_sm) {
  if (itemsize == 4) return configure<float>(kind, nbins, form, copies, warps, smem, blocks_per_sm);
  if (itemsize == 8)
    return configure<double>(kind, nbins, form, copies, warps, smem, blocks_per_sm);
  return cudaErrorInvalidValue;
}

// One deposit and its sum (launch()); a, b, c as Args names them, and for
// kXV from the state live, w and p's bytes (else null, null, 0); n markers
// of each of ns species (kXV: ns = 1); k output channels; grids: the device
// buffer of blocks x k x 2 nbins values where the plan is kBuffer, else
// unused; partials: blocks rows of k nbins values, + k moments for kXV;
// out: one such row.
int pic1dp_hist_f32(int kind, int k, const void* a, const void* b, const void* c,
                    const void* live, const void* w, int p_bytes, long long n, int ns, int nx,
                    int nv, double lx, double v_max, void* grids, int blocks, long long per_warp,
                    void* partials, void* out, void* stream) {
  return launch<float>(kind, k, a, b, c, live, w, p_bytes, n, ns, nx, nv, lx, v_max, grids,
                       blocks, per_warp, partials, out, stream);
}

int pic1dp_hist_f64(int kind, int k, const void* a, const void* b, const void* c,
                    const void* live, const void* w, int p_bytes, long long n, int ns, int nx,
                    int nv, double lx, double v_max, void* grids, int blocks, long long per_warp,
                    void* partials, void* out, void* stream) {
  return launch<double>(kind, k, a, b, c, live, w, p_bytes, n, ns, nx, nv, lx, v_max, grids,
                        blocks, per_warp, partials, out, stream);
}

}  // extern "C"
