"""Deterministic hat deposits onto small grids: the x-v snapshot histogram,
the |delta f|(v) profile and the grid charge.

The JAX package sums these as one-hot contractions or segment sums
(pic1dp_tpu/core/diagnostics.py:78 deposit_xv, :184 dist_pertb_abs_v;
pic1dp_tpu/ops/deposit.py:133 deposit), which repeat bit for bit on its
device.  Their plain PyTorch versions here are one index_add_ each, which
on CUDA adds with float atomics, so a sum's last bits would change from run
to run.  On a CUDA tensor each function below launches instead a kernel of
csrc/hist_kernels.cu (built by nvcc at first use, bound through ctypes),
whose every sum runs in an order the code fixes: no float atomic, so a
launch repeats bit for bit, from a CUDA graph too.

  * hist_xv (kernel HIST_XV): vals (k, n) of one species at (x, v) onto the
    (nv, nx) grid, four hat corners a marker, |v| >= v_max skipped;
  * xv_pass (HIST_XV, reading its channels from the state): a snapshot's
    one pass over a species' markers, the x-v histograms of live, p and w
    (xv_channels) and the energies' raw sums, v^2 times each channel
    summed over every marker, |v| >= v_max included (the moments);
  * profile (HIST_V): |w| of the live markers with |v| < v_max, v, w, live
    (ns, n), onto nv points per species;
  * grid_charge (GRID_CHARGE): val at x, both (ns, n), onto the periodic
    (nx,) grid, every species summed.

The plain versions hist_xv_plain, profile_plain and grid_charge_plain are
one index_add_ of the terms *_terms forms, summed in the output's dtype as
the kernels do; on the CPU index_add_ runs serially, so they are
deterministic there.  xv_pass_plain is hist_xv_plain of xv_channels and
the moments as torch sums.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pic1dp_tpu_torch.ops.interp import hat_v, hat_x
from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

SOURCE = "hist_kernels"
_SRC = f"pic1dp_tpu_torch/csrc/{SOURCE}.cu"

HIST_XV = CudaKernel("hist_xv", _SRC, "pic1dp_tpu/core/diagnostics.py:78")
HIST_V = CudaKernel("hist_v", _SRC, "pic1dp_tpu/core/diagnostics.py:184")
GRID_CHARGE = CudaKernel("grid_charge", _SRC, "pic1dp_tpu/ops/deposit.py:133")
KERNELS = (HIST_XV, HIST_V, GRID_CHARGE)

# enum Kind and enum Form in csrc/hist_kernels.cu
XV, V, X = 0, 1, 2
LANES, WARPS, BUFFER = 0, 1, 2
MAX_K = 3                 # value channels of hist_xv
# the source's constants (pic1dp_hist_constants, in its order)
MAX_COPIES = 8            # kMaxCopies: grid copies (LANES: warps) a block at most
SHARE = 2                 # kShare: warps of the x-v histogram that share a grid copy
LANE_WARPS_MIN = 4        # kLaneWarpsMin: LANES where this many warps' lane copies fit
MARKERS_XV = 8            # kMXV: markers a lane takes per round, x-v histogram
MARKERS_X = 16            # kMX: the same, profile and grid charge
SMEM_MAX = 232_448        # kSmemMax: one block's shared memory with an opt-in
SUM_GROUPS = 16           # kSumGroups: row groups of the row sum
CLAIM_MAX = 2048          # kClaimMax: slots of a claim table at most


# ---- the plain versions ----

def xv_channels(live, p, w, dtype) -> torch.Tensor:
    """The snapshot's three channels of one species (3, n) at dtype: 1, p
    and w where live, 0 where dead (p converted exactly, bfloat16 too)."""
    return torch.stack([
        live.to(dtype),
        torch.where(live, p, 0.0).to(dtype),
        torch.where(live, w, 0.0),
    ])


def hist_xv_terms(x, v, vals, lx: float, v_max: float, nx: int, nv: int):
    """hist_xv_plain's scatter: the flat bins iv * nx + ix of the four hat
    corners of every marker (4n,) and their terms (4n, k), markers with
    |v| >= v_max weighted 0."""
    ix0, ix1, wx0, wx1 = hat_x(x, lx, nx)
    iv0, iv1, wv0, wv1, inside = hat_v(v, v_max, nv)
    wv0 = torch.where(inside, wv0, 0.0)
    wv1 = torch.where(inside, wv1, 0.0)
    bins = torch.cat([iv0 * nx + ix0, iv0 * nx + ix1, iv1 * nx + ix0, iv1 * nx + ix1])
    weights = torch.cat([wv0 * wx0, wv0 * wx1, wv1 * wx0, wv1 * wx1])
    return bins, weights[:, None] * vals.T.repeat(4, 1)


def hist_xv_plain(x, v, vals, lx: float, v_max: float, nx: int, nv: int) -> torch.Tensor:
    """vals (k, n) over the (nv, nx) grid with hat weights in both
    coordinates, markers with |v| >= v_max skipped (reference
    src/pic1dp_output.F90:239-315): (k, nv, nx), one index_add_ of
    hist_xv_terms."""
    k = vals.shape[0]
    bins, terms = hist_xv_terms(x, v, vals, lx, v_max, nx, nv)
    hist = torch.zeros((nv * nx, k), dtype=vals.dtype, device=vals.device)
    hist.index_add_(0, bins, terms)
    return hist.T.reshape(k, nv, nx)


def xv_pass_plain(x, v, live, p, w, lx: float, v_max: float, nx: int, nv: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """xv_pass's (hist (3, nv, nx), moments (3,)): hist_xv_plain of
    xv_channels, and v^2 times each channel summed over every marker."""
    vals = xv_channels(live, p, w, x.dtype)
    return (hist_xv_plain(x, v, vals, lx, v_max, nx, nv),
            torch.sum(torch.where(live, v * v, 0.0) * vals, dim=1))


def profile_terms(v, w, live, v_max: float, nv: int):
    """profile_plain's scatter: the flat bins species * nv + iv of both hat
    halves of every marker (2 ns n,) and their terms, |w| of the live markers
    with |v| < v_max, 0 for the others."""
    ns = v.shape[0]
    iv0, iv1, wv0, wv1, inside = hat_v(v, v_max, nv)
    val = torch.where(live & inside, torch.abs(w), 0.0)
    row = torch.arange(ns, device=v.device)[:, None] * nv
    return (torch.cat([(row + iv0).reshape(-1), (row + iv1).reshape(-1)]),
            torch.cat([(wv0 * val).reshape(-1), (wv1 * val).reshape(-1)]))


def profile_plain(v, w, live, v_max: float, nv: int) -> torch.Tensor:
    """|w| of the live markers with |v| < v_max deposited on the nv-point
    velocity grid, per species (reference particle_compute_dist_pertb_abs_v,
    src/pic1dp_particle.F90:356-403): v, w, live (ns, n) -> (ns, nv), one
    index_add_ of profile_terms."""
    ns = v.shape[0]
    bins, terms = profile_terms(v, w, live, v_max, nv)
    prof = torch.zeros(ns * nv, dtype=w.dtype, device=w.device)
    prof.index_add_(0, bins, terms)
    return prof.reshape(ns, nv)


def grid_charge_terms(x, val, lx: float, nx: int):
    """grid_charge_plain's scatter: the cells of both hat halves of every
    marker and their terms."""
    ix0, ix1, w0, w1 = hat_x(x, lx, nx)
    return (torch.cat([ix0.reshape(-1), ix1.reshape(-1)]),
            torch.cat([(w0 * val).reshape(-1), (w1 * val).reshape(-1)]))


def grid_charge_plain(x, val, lx: float, nx: int) -> torch.Tensor:
    """Hat-weighted sum of val at x (any shape, like x; x in [0, lx)) onto
    the periodic (nx,) grid (reference src/pic1dp_interaction.F90:96-115):
    one index_add_ of grid_charge_terms."""
    bins, terms = grid_charge_terms(x, val, lx, nx)
    grid = torch.zeros(nx, dtype=val.dtype, device=val.device)
    grid.index_add_(0, bins, terms)
    return grid


# ---- the kernels ----

def hist_xv(x, v, vals, lx: float, v_max: float, nx: int, nv: int) -> torch.Tensor:
    """hist_xv_plain's (k, nv, nx) histogram; on CUDA the HIST_XV kernel."""
    if x.device.type == "cpu":
        return hist_xv_plain(x, v, vals, lx, v_max, nx, nv)
    if vals.dim() != 2 or not 1 <= vals.shape[0] <= MAX_K:
        raise NotImplementedError(f"hist_xv takes 1 to {MAX_K} value channels (k, n), "
                                  f"got vals of shape {tuple(vals.shape)}")
    n, k = x.numel(), vals.shape[0]
    _check("hist_xv", (x, v, vals), (n, n, k * n), x.dtype)
    if x.dim() != 1 or v.shape != x.shape or vals.shape[1] != n:
        raise ValueError("hist_xv takes x and v of shape (n,) and vals of shape (k, n)")
    out = _launch(HIST_XV, XV, k, x, v, vals, n, 1, nx, nv, lx, v_max, nv * nx)
    return out[:k * nv * nx].view(k, nv, nx)


def xv_pass(x, v, live, p, w, lx: float, v_max: float, nx: int, nv: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """xv_pass_plain's (hist (3, nv, nx), moments (3,)) of one species'
    x, v, live, p and w (n,); on CUDA the HIST_XV kernel, which reads live,
    p (of x's dtype or bfloat16) and w itself, one launch and one row sum."""
    if x.device.type == "cpu":
        return xv_pass_plain(x, v, live, p, w, lx, v_max, nx, nv)
    n = x.numel()
    if x.dim() != 1 or any(t.shape != x.shape for t in (v, live, p, w)):
        raise ValueError("xv_pass takes x, v, live, p and w of one shape (n,)")
    if p.dtype not in (x.dtype, torch.bfloat16) or p.device != x.device \
            or not p.is_contiguous():
        raise ValueError(f"xv_pass takes a contiguous p of {x.dtype} or bfloat16 beside x, "
                         f"got {p.dtype} on {p.device}")
    _check("xv_pass", (x, v, w), (n, n, n), x.dtype, live)
    out = _launch(HIST_XV, XV, MAX_K, x, v, p, n, 1, nx, nv, lx, v_max, nv * nx, live, w)
    return out[:MAX_K * nv * nx].view(MAX_K, nv, nx), out[MAX_K * nv * nx:]


def profile(v, w, live, v_max: float, nv: int) -> torch.Tensor:
    """profile_plain's (ns, nv) profile; on CUDA the HIST_V kernel."""
    if v.device.type == "cpu":
        return profile_plain(v, w, live, v_max, nv)
    _check("profile", (v, w), (v.numel(), v.numel()), v.dtype, live)
    if v.dim() != 2 or w.shape != v.shape or live.shape != v.shape:
        raise ValueError("profile takes v, w and live of one shape (ns, n)")
    ns, n = v.shape
    return _launch(HIST_V, V, 1, v, w, live, n, ns, 1, nv, 1.0, v_max,
                   ns * nv).reshape(ns, nv)


def grid_charge(x, val, lx: float, nx: int) -> torch.Tensor:
    """grid_charge_plain's (nx,) grid; on CUDA the GRID_CHARGE kernel."""
    if x.device.type == "cpu":
        return grid_charge_plain(x, val, lx, nx)
    _check("grid_charge", (x, val), (x.numel(), x.numel()), x.dtype)
    if val.shape != x.shape:
        raise ValueError("grid_charge takes x and val of one shape")
    return _launch(GRID_CHARGE, X, 1, x, val, None, x.numel(), 1, nx, 2, lx, 1.0, nx)


def _check(name: str, tensors, numels, dtype, live=None) -> None:
    """What the kernels take: contiguous CUDA tensors on one device, the
    float ones of one dtype, float32 or float64, and a bool live mask; all
    checked before the card is asked."""
    x = tensors[0]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64 tensors, got {dtype}")
    for t, numel in zip(tensors, numels):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} takes its float tensors on one device and of one "
                             f"dtype, got {t.dtype} on {t.device} beside {dtype} on "
                             f"{x.device}")
        if not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"{name} takes contiguous tensors of matching sizes")
    if live is not None and (live.device != x.device or live.dtype != torch.bool
                             or not live.is_contiguous()):
        raise ValueError(f"{name} takes a contiguous bool live mask on the device of v")
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")


def markers(kind: int) -> int:
    """Markers a lane takes per round (kMarkers in the source)."""
    return MARKERS_XV if kind == XV else MARKERS_X


def blocks(n: int, m: int, warps: int, blocks_per_sm: int, sms: int, k: int = 1
           ) -> tuple[int, int]:
    """The deposit's marker ranges for n markers, m a lane a round: (G,
    markers per warp).  Block b's warp w takes per_warp markers from (b
    warps + w) per_warp, per_warp a whole number of rounds of 32 m; G blocks
    for each of the k channels, at most blocks_per_sm * sms of them in all,
    and no block without markers; (0, 0) for none.  Fixed by n, the plan and
    the card, so is every sum's order."""
    if n == 0:
        return 0, 0
    chunk = 32 * m
    g = max(1, min(blocks_per_sm * sms // k, -(-n // (warps * chunk))))
    per_warp = -(-(-(-n // (g * warps))) // chunk) * chunk
    return -(-n // (warps * per_warp)), per_warp


def claim_bytes(kind: int, nbins: int) -> int:
    """A warp's claim table (claim_bytes in the source) for the x-v
    histogram: a byte a slot, the power of two of slots from 16 that holds
    nbins, at most CLAIM_MAX; none for the others."""
    size = 16
    while size < nbins and size < CLAIM_MAX:
        size *= 2
    return size if kind == XV else 0


class Plan(NamedTuple):
    """How a block holds its grids (plan in the source)."""

    form: int       # LANES, WARPS or BUFFER
    copies: int     # grid copies (LANES: warps of 32 lane copies)
    warps: int
    smem: int       # bytes of shared memory


def plan(itemsize: int, kind: int, nbins: int) -> Plan:
    """LANES for the profile and the grid charge where 32 lane copies of
    nbins values fit for at least LANE_WARPS_MIN warps (the most of
    MAX_COPIES); else WARPS: copies of 2 nbins values, each with the claim
    tables of the SHARE warps that share it for the x-v histogram (one warp
    a copy for the others), the most of MAX_COPIES that fit in SMEM_MAX;
    else BUFFER: one warp a block, its copy in the device buffer, its claim
    table alone in shared memory."""
    lanes = 32 * nbins * itemsize
    if kind != XV and SMEM_MAX // lanes >= LANE_WARPS_MIN:
        w = min(MAX_COPIES, SMEM_MAX // lanes)
        return Plan(LANES, w, w, w * lanes)
    share = SHARE if kind == XV else 1
    claim = claim_bytes(kind, nbins)
    copy = 2 * nbins * itemsize + share * claim
    if SMEM_MAX // copy:
        c = min(MAX_COPIES, SMEM_MAX // copy)
        return Plan(WARPS, c, c * share, c * copy)
    return Plan(BUFFER, 1, 1, claim)


def _launch(kernel: CudaKernel, kind: int, k: int, a, b, c, n: int, ns: int, nx: int,
            nv: int, lx: float, v_max: float, nbins: int, live=None, w=None) -> torch.Tensor:
    """One launch of `kernel` and its row sum into one row of k nbins
    values, then for the x-v histogram the k channels' moments; live and w
    given, the x-v histogram reads its channels from the state (c = p)."""
    lib = library().lib
    dev = a.device
    p, per_sm = _configure(kind, nbins, a.element_size(),
                           dev.index if dev.index is not None else torch.cuda.current_device())
    g, per_warp = blocks(n * ns, markers(kind), p.warps, per_sm, nvcc.sm_count(dev), k)
    row = k * nbins + (k if kind == XV else 0)
    partials = torch.empty(g * row, dtype=a.dtype, device=dev)
    grids = (torch.empty(g * k * 2 * nbins, dtype=a.dtype, device=dev)
             if p.form == BUFFER and g else None)
    out = torch.empty(row, dtype=a.dtype, device=dev)
    entry = lib.pic1dp_hist_f32 if a.dtype == torch.float32 else lib.pic1dp_hist_f64
    state = live is not None
    rc = entry(kind, k, a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
               live.data_ptr() if state else None, w.data_ptr() if state else None,
               c.element_size() if state else 0, n, ns, nx, nv, lx, v_max,
               None if grids is None else grids.data_ptr(), g, per_warp, partials.data_ptr(),
               out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernel.launched(rc, lib)
    return out


@functools.lru_cache(maxsize=None)
def _configure(kind: int, nbins: int, itemsize: int, device: int) -> tuple[Plan, int]:
    """(plan, blocks an SM) of a launch: the kernel opted in to its shared
    memory on the device and the occupancy query, once per kernel, grid and
    device (the first call is made outside any graph capture)."""
    lib = library().lib
    out = [ctypes.c_int(0) for _ in range(5)]
    with torch.cuda.device(device):
        rc = lib.pic1dp_hist_configure(itemsize, kind, nbins, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise RuntimeError(f"hist kernel setup failed: "
                           f"{lib.pic1dp_error_string(rc).decode()} ({rc})")
    got = Plan(*(o.value for o in out[:4]))
    if got != plan(itemsize, kind, nbins):
        raise RuntimeError(f"plan does not match {_SRC}'s: {got}")
    return got, out[4].value


_lib: nvcc.Library | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Check a build of csrc/hist_kernels.cu against this module's mirrors
    of its constants and declare its C signatures."""
    ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    consts = (i32 * 8)()
    lib.pic1dp_hist_constants.argtypes = [ctypes.POINTER(i32)]
    lib.pic1dp_hist_constants(consts)
    want = (MAX_COPIES, SHARE, LANE_WARPS_MIN, MARKERS_XV, MARKERS_X, SMEM_MAX, SUM_GROUPS,
            CLAIM_MAX)
    if tuple(consts) != want:
        raise RuntimeError(f"the constants of {_SRC} {tuple(consts)} are not this module's {want}")
    for entry in (lib.pic1dp_hist_f32, lib.pic1dp_hist_f64):
        entry.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, f64, f64,
                          ptr, i32, i64, ptr, ptr, ptr]
    lib.pic1dp_hist_configure.argtypes = [i32, i32, i32] + [ctypes.POINTER(i32)] * 5
    lib.pic1dp_error_string.argtypes = [i32]
    lib.pic1dp_error_string.restype = ctypes.c_char_p
    return lib


def library() -> nvcc.Library:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        built = nvcc.load(SOURCE)
        bind(built.lib)
        _lib = built
    return _lib
