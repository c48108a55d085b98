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
  * profile (HIST_V): |w| of the live markers with |v| < v_max, v, w, live
    (ns, n), onto nv points per species;
  * grid_charge (GRID_CHARGE): val at x, both (ns, n), onto the periodic
    (nx,) grid, every species summed.

The plain versions hist_xv_plain, profile_plain and grid_charge_plain are
one index_add_ of the terms *_terms forms, summed in the output's dtype as
the kernels do; on the CPU index_add_ runs serially, so they are
deterministic there.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

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

# enum Kind in csrc/hist_kernels.cu
XV, V, X = 0, 1, 2
MAX_K = 3                 # value channels of hist_xv
THREADS = 256             # kThreads
SMEM_MAX = 232_448        # kSmemMax: one block's shared memory with an opt-in


# ---- the plain versions ----

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
    n = x.numel()
    _check("hist_xv", (x, v, vals), (n, n, vals.shape[0] * n), x.dtype)
    if x.dim() != 1 or v.shape != x.shape or vals.shape[1] != n:
        raise ValueError("hist_xv takes x and v of shape (n,) and vals of shape (k, n)")
    return _launch(HIST_XV, XV, vals.shape[0], x, v, vals, n, 1, nx, nv, lx, v_max,
                   nv * nx).reshape(vals.shape[0], nv, nx)


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


def blocks(n: int, blocks_per_sm: int, sms: int) -> tuple[int, int]:
    """The deposit's grid for n markers: (G, markers per block), each block
    a whole number of THREADS-marker rounds and none without markers; (0, 0)
    for none.  Fixed by n and the card, so is every sum's order."""
    if n == 0:
        return 0, 0
    g = min(blocks_per_sm * sms, -(-n // THREADS))
    per_block = -(-(-(-n // g)) // THREADS) * THREADS
    return -(-n // per_block), per_block


def plan_smem(itemsize: int, k: int, nbins: int) -> tuple[int, int]:
    """(shared memory bytes, grid copies) of a block (plan_smem in the
    source): the most copies of 8, 4, 2, 1 grids of k channels x 2 nbins
    values, beside the warps' stages of 64 k values, within SMEM_MAX; the
    stages alone and 0 copies (the device buffer) where none fits."""
    stage = 8 * 64 * k * itemsize
    for c in (8, 4, 2, 1):
        if c * 2 * k * nbins * itemsize + stage <= SMEM_MAX:
            return c * 2 * k * nbins * itemsize + stage, c
    return stage, 0


def _launch(kernel: CudaKernel, kind: int, k: int, a, b, c, n: int, ns: int, nx: int,
            nv: int, lx: float, v_max: float, nbins: int) -> torch.Tensor:
    lib = library().lib
    dev = a.device
    copies, per_sm = _configure(kind, k, nbins, a.element_size(),
                                dev.index if dev.index is not None
                                else torch.cuda.current_device())
    g, per_block = blocks(n * ns, per_sm, nvcc.sm_count(dev))
    partials = torch.empty(g * k * nbins, dtype=a.dtype, device=dev)
    grids = (torch.empty(g * k * 2 * nbins, dtype=a.dtype, device=dev)
             if copies == 0 and g else None)
    out = torch.empty(k * nbins, dtype=a.dtype, device=dev)
    entry = lib.pic1dp_hist_f32 if a.dtype == torch.float32 else lib.pic1dp_hist_f64
    rc = entry(kind, k, a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(), n,
               ns, nx, nv, lx, v_max, None if grids is None else grids.data_ptr(), g,
               per_block, partials.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    kernel.launched(rc, lib)
    return out


@functools.lru_cache(maxsize=None)
def _configure(kind: int, k: int, nbins: int, itemsize: int, device: int) -> tuple[int, int]:
    """(grid copies in shared memory, blocks an SM) of a launch: the kernel
    opted in to its shared memory on the device and the occupancy query,
    once per kernel, grid and device (the first call is made outside any
    graph capture)."""
    lib = library().lib
    copies, smem, per_sm = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.pic1dp_hist_configure(itemsize, kind, k, nbins, ctypes.byref(copies),
                                       ctypes.byref(smem), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"hist kernel setup failed: "
                           f"{lib.pic1dp_error_string(rc).decode()} ({rc})")
    if (smem.value, copies.value) != plan_smem(itemsize, k, nbins):
        raise RuntimeError(f"plan_smem does not match {_SRC}'s")
    return copies.value, per_sm.value


_lib: nvcc.Library | None = None


def library() -> nvcc.Library:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        built = nvcc.load(SOURCE)
        lib = built.lib
        if lib.pic1dp_hist_threads() != THREADS or lib.pic1dp_hist_smem_max() != SMEM_MAX:
            raise RuntimeError(f"THREADS or SMEM_MAX do not match {_SRC}")
        ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        for entry in (lib.pic1dp_hist_f32, lib.pic1dp_hist_f64):
            entry.argtypes = [i32, i32, ptr, ptr, ptr, i64, i32, i32, i32, f64, f64, ptr, i32,
                              i64, ptr, ptr, ptr]
        lib.pic1dp_hist_configure.argtypes = [i32, i32, i32, i32] + [ctypes.POINTER(i32)] * 3
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        _lib = built
    return _lib
