"""Stream probe kernels: the streaming ceiling of an access pattern, with
and without compute, under several carry layouts.

Port of the TPU probe kernels stream_only (bench/kernel_probe.py:140, body
:143-158), default_pipeline (bench/probe_pipeline.py:78) and manual_pipeline
(:104).  Each reads NR float32 streams and writes NW:

    acc   = in_0 + ... + in_{NR-1}
    out_j = acc * (1 + 0.25 j)          j < NW
    total = sum of acc over every element

`alias` maps an input index to the output index that overwrites it (the
TPU kernels' input_output_aliases, e.g. {0: 0, 1: 1, 3: 2} for the
substep-2 pattern); an output no input maps to goes to a fresh buffer.

The compute probes make_call (bench/probe_compute.py:94), default_call and
manual_call (bench/probe_overlap.py:72, :100) add, on 4 reads and 3 writes,
K copies of one compute unit of the substep kernels applied to in_0:

    out_j = acc * (1 + 0.25 j) + eps * extra,   extra = sum_{c<K} unit(in_0, c)

and the carry probes flat_call and pingpong_call (bench/probe_pingpong.py
:128, :167) run the plain 4r+3w body under a choice of output buffers, or
on (2, n) buffers read at half h and written at half 1 - h.

This module holds, for the kernels of csrc/stream_probes.cu (built by nvcc
at first use, bound through ctypes), each with its launch counter:

  * stream_rw, direct float4 loads (stream_only and default_pipeline);
  * stream_bulk, a shared-memory ring filled by cp.async.bulk from one
    producer warp and emptied by consumer warps (manual_pipeline);
  * stream_units, stream_rw with K units (make_call, default_call);
  * stream_bulk_units, stream_bulk with K units (manual_call);
  * stream_carry, the carry layouts (flat_call, pingpong_call);

and their plain PyTorch versions stream_plain (stream_rw, stream_bulk),
stream_units_plain (both unit kernels) and stream_carry_plain.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.  Every call returns (outputs, total) with total
a float64 0-d tensor on the streams' device, summed in float64.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from pic1dp_tpu_torch.ops.substep_kernels import SubstepParams
from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

SOURCE = "stream_probes"
_SRC = f"pic1dp_tpu_torch/csrc/{SOURCE}.cu"

STREAM_RW = CudaKernel("stream_rw", _SRC, "bench/kernel_probe.py:140")
STREAM_BULK = CudaKernel("stream_bulk", _SRC, "bench/probe_pipeline.py:104")
STREAM_UNITS = CudaKernel("stream_units", _SRC,
                          "bench/probe_compute.py:94, bench/probe_overlap.py:72")
STREAM_BULK_UNITS = CudaKernel("stream_bulk_units", _SRC, "bench/probe_overlap.py:100")
STREAM_CARRY = CudaKernel("stream_carry", _SRC,
                          "bench/probe_pingpong.py:128, bench/probe_pingpong.py:167")
KERNELS = (STREAM_RW, STREAM_BULK, STREAM_UNITS, STREAM_BULK_UNITS, STREAM_CARRY)

# (reads, writes) built: PIC1DP_PATTERNS in csrc/stream_probes.cu
PATTERNS = frozenset({(3, 1), (4, 1), (4, 2), (4, 3), (4, 4), (6, 3)})
MAX_IN, MAX_OUT = 6, 4
MAX_STAGES = 16
# the ring's block: one producer warp and 1 to MAX_CONSUMER_WARPS consumer
# warps (ring_consumers picks the count), at most MAX_BULK_THREADS threads;
# its shared memory, bulk_smem_bytes, is the full and empty mbarriers of
# MAX_STAGES slots ahead of the ring, plus the block sum's BLOCK_SUM_BYTES,
# within the SMEM_PER_BLOCK one block may opt in to on sm_90 (227 KB).  The
# library is checked against these sizes at load.
MAX_BULK_THREADS = 1024
MAX_CONSUMER_WARPS = MAX_BULK_THREADS // 32 - 1
BAR_BYTES = 2 * 8 * MAX_STAGES
BLOCK_SUM_BYTES = 8 * MAX_BULK_THREADS // 32
SMEM_PER_BLOCK = 232_448
# the unit and carry kernels' pattern: the substep-2 stream roles
N_READ, N_WRITE = 4, 3
ALIAS = {0: 0, 1: 1, 3: 2}
# compute units (enum Unit in csrc/stream_probes.cu) and the K built for
# each on direct loads and on the ring (PIC1DP_RW_UNITS, PIC1DP_BULK_UNITS)
UNITS = {"trig": 1, "poly": 2, "exp": 3, "wrap": 4}
UNIT_KS = (0, 1, 2, 4)
BULK_UNIT_KS = (0, 1, 4)
# the carry kernel's grid
CARRY_BLOCKS_PER_SM = 4
EPS = 1e-12                          # the TPU probes' scale of extra
ULP1 = float(np.spacing(np.float32(1.0)))   # one float32 ulp at 1
# the TPU probes' box and grid (bench/probe_compute.py:62), and the ratio
# drive's constants (:81-86: density .9, T2/T .25, v0 4.5)
LX, NX = 2.0 * math.pi / 0.36, 1024
EXP_V0, EXP_IV, EXP_IVB, EXP_HALF_IV, EXP_HALF_IVB, EXP_LOG_RATIO = \
    4.5, 1.0, 4.0, 0.5, 2.0, -1.0


def outputs(ins, n_write: int, alias: dict[int, int], dest=None) -> list[torch.Tensor]:
    """The output buffers: the aliased input for an aliased output; for the
    others dest[j] where given, else a fresh tensor."""
    _check_alias(len(ins), n_write, alias)
    by_out = {j: i for i, j in alias.items()}
    return [ins[by_out[j]] if j in by_out
            else dest[j] if dest is not None else torch.empty_like(ins[0])
            for j in range(n_write)]


def stream_plain(ins, n_write: int, alias: dict[int, int], dest=None):
    """The plain PyTorch version of stream_rw and stream_bulk, on any
    device."""
    outs = outputs(ins, n_write, alias, dest)
    acc = ins[0]
    for t in ins[1:]:
        acc = acc + t
    for j, o in enumerate(outs):
        o.copy_(acc * (1.0 + 0.25 * j))
    return outs, acc.sum(dtype=torch.float64)


# ---- compute units ----

def _f32(v: float) -> float:
    """v rounded to float32, as the kernels' Params<float> holds it."""
    return float(np.float32(v))


def unit_params(n: int) -> SubstepParams:
    """The units' constants in the substep kernels' own HostParams: mode 1
    on nx 1024 over lx 2 pi / 0.36, and the ratio drive of
    bench/probe_compute.py:81-86 (kform 1)."""
    prm = SubstepParams()
    prm.n, prm.nmode, prm.nx, prm.modes[0] = n, 1, NX, 1
    step = 2.0 * math.pi / NX
    prm.cdm1[0], prm.sd[0] = math.cos(step) - 1.0, math.sin(step)
    prm.lx, prm.inv_lx, prm.nx_over_lx = LX, 1.0 / LX, NX / LX
    prm.nspecies, prm.sp_kform[0] = 1, 1
    prm.sp_k_v0[0], prm.sp_k_iv[0], prm.sp_k_ivb[0] = EXP_V0, EXP_IV, EXP_IVB
    prm.sp_k_half_iv[0], prm.sp_k_half_ivb[0] = EXP_HALF_IV, EXP_HALF_IVB
    prm.sp_k_log_ratio[0] = EXP_LOG_RATIO
    return prm


def _const(v: float, dtype: torch.dtype) -> float:
    return _f32(v) if dtype == torch.float32 else v


def _sincospi(t: torch.Tensor):
    """(sin, cos) of pi t, evaluated in float64 and rounded to t's dtype:
    the value sincospi approximates within one ulp."""
    th = math.pi * t.double()
    return torch.sin(th).to(t.dtype), torch.cos(th).to(t.dtype)


def unit_plain(unit: str, x: torch.Tensor, c: int) -> torch.Tensor:
    """Copy c of a compute unit at x, at x's dtype: the plain version of
    unit<U> in csrc/stream_probes.cu (hat_trig, the bare sincospi of the
    turn, minus_dlnf0_dv and wrap of csrc/substep_math.cuh)."""
    dt = x.dtype
    if unit == "trig":
        s = (x + _const(1e-6 * c, dt)) * _const(NX / LX, dt)
        fl = torch.floor(s)
        f = s - fl
        ix0 = fl.clamp(0, NX - 1).to(torch.int64)
        k = ix0 % NX                                   # mode 1
        kk = torch.where(2 * k > NX, k - NX, k)
        sn, cs = _sincospi((2 * kk).to(dt) / NX)
        step = 2.0 * math.pi / NX
        a = 1.0 + f * _const(math.cos(step) - 1.0, dt)
        b = f * _const(math.sin(step), dt)
        return (cs * a - sn * b) + (sn * a + cs * b)
    if unit == "poly":
        t = x * _const(1.0 / LX, dt) + _const(1e-6 * c, dt)
        sn, cs = _sincospi(2.0 * (t - torch.floor(t)))
        return cs + sn
    if unit == "exp":
        v = x + _const(1e-6 * c, dt)
        dv = v - EXP_V0
        arg = (v * v * EXP_HALF_IV - dv * dv * EXP_HALF_IVB + EXP_LOG_RATIO).clamp(-60.0, 60.0)
        r = torch.exp(arg)
        return (v * EXP_IV + r * (dv * EXP_IVB)) / (1.0 + r)
    if unit == "wrap":
        lx = _const(LX, dt)
        y = (x + float(c)) - lx * torch.floor((x + float(c)) * _const(1.0 / LX, dt))
        return torch.where(y >= lx, y - lx, torch.where(y < 0.0, y + lx, y))
    raise ValueError(f"unknown unit {unit!r} (units: {sorted(UNITS)})")


def units_plain(unit: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """extra: the sum of k copies of a unit at x, added in order from 0."""
    extra = torch.zeros_like(x)
    for c in range(k):
        extra = extra + unit_plain(unit, x, c)
    return extra


def units_tolerance(unit: str, k: int, extra: torch.Tensor) -> torch.Tensor:
    """Per-element bound on the difference of two float32 evaluations of
    extra (k copies of a unit; `extra` is one of them).  trig and poly: 3
    ulp at 1 per copy (each of cos and sin within an ulp at 1 of the
    other evaluation's, and one ulp of their sum, up to sqrt 2), plus one
    ulp of |extra| for each of the k - 1 additions of the running sum,
    whose roundings need not agree (the copies differ only by their 1e-6
    salts, so their errors add up).  exp: 1e-6 of max|extra|.  wrap: one
    ulp of lx (both wrap the same float)."""
    a = extra.abs().float()
    if unit in ("trig", "poly"):
        ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
        return 3.0 * ULP1 * k + max(k - 1, 0) * ulp
    if unit == "exp":
        return torch.full_like(a, 1e-6 * float(a.max()) if a.numel() else 0.0)
    return torch.full_like(a, float(np.spacing(np.float32(LX))))


def stream_units_plain(ins, alias: dict[int, int], unit: str, k: int, eps: float = EPS):
    """The plain PyTorch version of stream_units and stream_bulk_units, on
    any device and for any k."""
    if unit not in UNITS:
        raise ValueError(f"unknown unit {unit!r} (units: {sorted(UNITS)})")
    outs = outputs(ins, N_WRITE, alias)
    extra = units_plain(unit, ins[0], k)
    acc = ins[0]
    for t in ins[1:]:
        acc = acc + t
    for j, o in enumerate(outs):
        o.copy_(acc * (1.0 + 0.25 * j) + _f32(eps) * extra)
    return outs, acc.sum(dtype=torch.float64)


def stream_units(ins, alias: dict[int, int], unit: str, k: int, eps: float = EPS,
                 blocks_per_sm: int = 4):
    """stream_rw on 4 reads and 3 writes with k copies of a unit (direct
    loads, a grid-stride loop of blocks_per_sm blocks per SM)."""
    if ins[0].device.type == "cpu":
        return stream_units_plain(ins, alias, unit, k, eps)
    _check_units(ins, unit, k, UNIT_KS)
    lib = library().lib
    grid = blocks_per_sm * nvcc.sm_count(ins[0].device)
    outs = outputs(ins, N_WRITE, alias)
    partials = torch.empty(grid, dtype=torch.float64, device=ins[0].device)
    rc = lib.pic1dp_stream_units(UNITS[unit], k, _ptrs(ins, N_READ), _ptrs(outs, N_WRITE),
                                 ins[0].numel(), ctypes.byref(unit_params(ins[0].numel())),
                                 eps, partials.data_ptr(), grid, _stream(ins[0]))
    STREAM_UNITS.launched(rc, lib)
    return outs, partials.sum()


def stream_bulk_units(ins, alias: dict[int, int], unit: str, k: int, eps: float = EPS,
                      tile_bytes: int = 8192, stages: int = 4,
                      consumer_warps: int | None = None):
    """stream_bulk on 4 reads and 3 writes with k copies of a unit;
    consumer_warps overrides ring_consumers' count (overlap_probe's
    sweep)."""
    if ins[0].device.type == "cpu":
        return stream_units_plain(ins, alias, unit, k, eps)
    _check_units(ins, unit, k, BULK_UNIT_KS)
    ring = bulk_units_ring(unit, k, tile_bytes, stages, consumer_warps)
    grid = ring.blocks_per_sm * nvcc.sm_count(ins[0].device)
    lib = library().lib
    outs = outputs(ins, N_WRITE, alias)
    partials = torch.empty(grid, dtype=torch.float64, device=ins[0].device)
    rc = lib.pic1dp_stream_bulk_units(
        UNITS[unit], k, _ptrs(ins, N_READ), _ptrs(outs, N_WRITE), ins[0].numel(),
        ctypes.byref(unit_params(ins[0].numel())), eps, tile_bytes // 4, stages,
        ring.consumers, partials.data_ptr(), grid, _stream(ins[0]))
    STREAM_BULK_UNITS.launched(rc, lib)
    return outs, partials.sum()


# ---- carry layouts ----

def stream_carry_plain(ins, alias: dict[int, int], dest=None, h=None):
    """The plain PyTorch version of stream_carry, on any device.  With h
    it reads and writes through device-side indexing: no host sync."""
    if h is None:
        return stream_plain(ins, N_WRITE, alias, dest)
    outs = outputs(ins, N_WRITE, alias, dest)
    hi = h.to(torch.int64)
    acc = ins[0].index_select(0, hi)[0]
    for t in ins[1:]:
        acc = acc + t.index_select(0, hi)[0]
    for j, o in enumerate(outs):
        o.index_copy_(0, 1 - hi, (acc * (1.0 + 0.25 * j)).unsqueeze(0))
    return outs, acc.sum(dtype=torch.float64)


def stream_carry(ins, alias: dict[int, int], dest=None, h=None):
    """One step of the carry probe on 4 reads and 3 writes (direct loads,
    CARRY_BLOCKS_PER_SM blocks per SM): the plain stream body with each
    output in its aliased input, in dest[j] or fresh.  With
    h, an int32 (1,) tensor on the device, every stream is a (2, n) buffer
    read at half h and written at half 1 - h; the caller flips h."""
    if ins[0].device.type == "cpu":
        return stream_carry_plain(ins, alias, dest, h)
    outs = outputs(ins, N_WRITE, alias, dest)
    _check_fixed(ins, "carry")
    _check(ins, N_WRITE, outs)
    x = ins[0]
    if h is None:
        n = half = x.numel()
    else:
        if x.dim() != 2 or x.shape[0] != 2 or h.device != x.device \
                or h.dtype != torch.int32 or h.numel() != 1:
            raise ValueError("stream_carry with h takes (2, n) streams and an int32 (1,) "
                             "tensor h on their device")
        n = half = x.shape[1]
    lib = library().lib
    grid = CARRY_BLOCKS_PER_SM * nvcc.sm_count(x.device)
    partials = torch.empty(grid, dtype=torch.float64, device=x.device)
    rc = lib.pic1dp_stream_carry(_ptrs(ins, N_READ), _ptrs(outs, N_WRITE), n, half,
                                 None if h is None else h.data_ptr(), partials.data_ptr(),
                                 grid, _stream(x))
    STREAM_CARRY.launched(rc, lib)
    return outs, partials.sum()


def stream_rw(ins, n_write: int, alias: dict[int, int], blocks_per_sm: int = 4):
    """Direct loads, a grid-stride loop of blocks_per_sm blocks per SM."""
    if ins[0].device.type == "cpu":
        return stream_plain(ins, n_write, alias)
    _check(ins, n_write)
    lib = library().lib
    grid = blocks_per_sm * nvcc.sm_count(ins[0].device)
    outs = outputs(ins, n_write, alias)
    partials = torch.empty(grid, dtype=torch.float64, device=ins[0].device)
    rc = lib.pic1dp_stream_rw(len(ins), n_write, _ptrs(ins, MAX_IN), _ptrs(outs, MAX_OUT),
                              ins[0].numel(), partials.data_ptr(), grid, _stream(ins[0]))
    STREAM_RW.launched(rc, lib)
    return outs, partials.sum()


def stream_bulk(ins, n_write: int, alias: dict[int, int], tile_bytes: int = 8192,
                stages: int = 4):
    """The manual pipeline: a persistent grid, each block with a ring of
    `stages` slots of tile_bytes per input stream, filled by one producer
    warp and emptied by the consumer warps ring_consumers picks."""
    if ins[0].device.type == "cpu":
        return stream_plain(ins, n_write, alias)
    _check(ins, n_write)
    ring = bulk_ring(len(ins), n_write, tile_bytes, stages)
    grid = ring.blocks_per_sm * nvcc.sm_count(ins[0].device)
    lib = library().lib
    outs = outputs(ins, n_write, alias)
    partials = torch.empty(grid, dtype=torch.float64, device=ins[0].device)
    rc = lib.pic1dp_stream_bulk(len(ins), n_write, _ptrs(ins, MAX_IN),
                                _ptrs(outs, MAX_OUT), ins[0].numel(), tile_bytes // 4,
                                stages, ring.consumers, partials.data_ptr(), grid,
                                _stream(ins[0]))
    STREAM_BULK.launched(rc, lib)
    return outs, partials.sum()


def bulk_smem_bytes(n_read: int, tile_bytes: int, stages: int) -> int:
    """Dynamic shared memory of one ring block (bulk_smem_bytes in
    csrc/stream_probes.cu): the mbarriers, then `stages` slots of one tile
    per input."""
    return BAR_BYTES + stages * n_read * tile_bytes


class Ring(NamedTuple):
    """A ring block's consumer warps and the blocks of it an SM holds."""
    consumers: int
    blocks_per_sm: int


def ring_consumers(per_sm: dict[int, int], compute: bool) -> int:
    """The consumer warps of a ring block, from the blocks an SM holds at
    each count (per_sm[c], the occupancy query's).  With compute units the
    units' instructions set the pace, so the most consumer warps a block
    of which one fits; without, the bytes in flight do, so the most
    blocks, then the most consumer warps at that many blocks (the sweep in
    PERF.md section 6).  A ring that fits at no count keeps 0 blocks, which
    the wrapper refuses."""
    if compute:
        return max(per_sm, key=lambda c: (per_sm[c] > 0, c))
    return max(per_sm, key=lambda c: (per_sm[c], c))


def bulk_ring(n_read: int, n_write: int, tile_bytes: int, stages: int) -> Ring:
    """stream_bulk's block on this ring (raises if none fits an SM)."""
    _check_ring(n_read, tile_bytes, stages)
    return _ring("pic1dp_stream_bulk_blocks_per_sm", n_read, n_write, n_read, tile_bytes,
                 stages, None, False, torch.cuda.current_device())


def bulk_units_ring(unit: str, k: int, tile_bytes: int, stages: int,
                    consumer_warps: int | None = None) -> Ring:
    """stream_bulk_units' block for this unit, K and ring (the units'
    registers count as well as the ring), at consumer_warps where given."""
    _check_ring(N_READ, tile_bytes, stages, consumer_warps)
    return _ring("pic1dp_stream_bulk_units_blocks_per_sm", UNITS[unit], k, N_READ,
                 tile_bytes, stages, consumer_warps, k > 0, torch.cuda.current_device())


def _check_ring(n_read: int, tile_bytes: int, stages: int,
                consumer_warps: int | None = None) -> None:
    """What the ring takes, checked before the card is asked."""
    if tile_bytes < 16 or tile_bytes % 16 or not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stream_bulk takes tiles of a multiple of 16 bytes and 1 to "
                         f"{MAX_STAGES} stages, got {tile_bytes} bytes x {stages}")
    if consumer_warps is not None and not 1 <= consumer_warps <= MAX_CONSUMER_WARPS:
        raise ValueError(f"stream_bulk takes 1 to {MAX_CONSUMER_WARPS} consumer warps, "
                         f"got {consumer_warps}")
    smem = bulk_smem_bytes(n_read, tile_bytes, stages)
    if smem + BLOCK_SUM_BYTES > SMEM_PER_BLOCK:
        raise ValueError(f"a ring of {stages} stages x {n_read} inputs x {tile_bytes} bytes "
                         f"needs {smem + BLOCK_SUM_BYTES} bytes of shared memory, more than "
                         f"the {SMEM_PER_BLOCK} bytes one block of an SM may have")


@functools.lru_cache(maxsize=None)
def _ring(entry: str, a: int, b: int, n_read: int, tile_bytes: int, stages: int,
          consumer_warps: int | None, compute: bool, device: int) -> Ring:
    """The occupancy query at every consumer count (or at consumer_warps),
    and ring_consumers' pick; once per ring, kernel and device."""
    lib = library().lib

    def per_sm(c: int) -> int:
        out = ctypes.c_int(0)
        rc = getattr(lib, entry)(a, b, tile_bytes // 4, stages, c, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"stream_bulk setup failed: "
                               f"{lib.pic1dp_error_string(rc).decode()} ({rc})")
        return out.value

    counts = range(1, MAX_CONSUMER_WARPS + 1) if consumer_warps is None else (consumer_warps,)
    blocks = {c: per_sm(c) for c in counts}
    c = ring_consumers(blocks, compute)
    if blocks[c] < 1:
        raise ValueError(f"a ring of {stages} stages x {n_read} inputs x {tile_bytes} bytes "
                         f"with {c} consumer warps does not fit on one SM")
    return Ring(c, blocks[c])


_lib: nvcc.Library | None = None


def library() -> nvcc.Library:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        built = nvcc.load(SOURCE)
        lib = built.lib
        if lib.pic1dp_params_size() != ctypes.sizeof(SubstepParams):
            raise RuntimeError("SubstepParams does not match HostParams in "
                               "csrc/substep_math.cuh")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        prm = ctypes.POINTER(SubstepParams)
        lib.pic1dp_stream_rw.argtypes = [i32, i32, ptr, ptr, i64, ptr, i32, ptr]
        lib.pic1dp_stream_bulk.argtypes = [i32, i32, ptr, ptr, i64, i32, i32, i32, ptr, i32,
                                           ptr]
        for entry in ("pic1dp_stream_bulk_blocks_per_sm",
                      "pic1dp_stream_bulk_units_blocks_per_sm"):
            getattr(lib, entry).argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
        lib.pic1dp_stream_units.argtypes = [i32, i32, ptr, ptr, i64, prm, f32, ptr, i32, ptr]
        lib.pic1dp_stream_bulk_units.argtypes = [i32, i32, ptr, ptr, i64, prm, f32, i32, i32,
                                                 i32, ptr, i32, ptr]
        lib.pic1dp_stream_carry.argtypes = [ptr, ptr, i64, i64, ptr, ptr, i32, ptr]
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        lib.pic1dp_stream_bulk_smem.argtypes = [i32, i32, i32]
        lib.pic1dp_stream_bulk_smem.restype = i64
        limits = [ctypes.c_int(0) for _ in range(3)]
        rc = lib.pic1dp_stream_bulk_limits(*(ctypes.byref(v) for v in limits))
        if rc != 0:
            raise RuntimeError(f"stream_bulk setup failed: "
                               f"{lib.pic1dp_error_string(rc).decode()} ({rc})")
        if [v.value for v in limits] != [BLOCK_SUM_BYTES, SMEM_PER_BLOCK, MAX_BULK_THREADS] \
                or any(lib.pic1dp_stream_bulk_smem(nr, tb // 4, st) != bulk_smem_bytes(nr, tb, st)
                       for nr in (3, 4, 6) for tb in (16, 4096, 8192, 16384)
                       for st in (1, 3, 4, MAX_STAGES)):
            raise RuntimeError("the ring's sizes (BLOCK_SUM_BYTES, SMEM_PER_BLOCK, "
                               "MAX_BULK_THREADS, bulk_smem_bytes) do not match "
                               "csrc/stream_probes.cu and the card")
        _lib = built
    return _lib


def _check_alias(n_read: int, n_write: int, alias: dict[int, int]) -> None:
    if any(not 0 <= i < n_read for i in alias) or \
            any(not 0 <= j < n_write for j in alias.values()) or \
            len(set(alias.values())) != len(alias):
        raise ValueError(f"alias {alias} must map distinct inputs (< {n_read}) to "
                         f"distinct outputs (< {n_write})")


def _check(ins, n_write: int, outs=()) -> None:
    """What the kernels take: a built (reads, writes) pattern of contiguous
    float32 CUDA tensors of one length, each 16-byte aligned; output
    buffers the caller chose (`outs`) are held to the same."""
    x = ins[0]
    if (len(ins), n_write) not in PATTERNS:
        raise NotImplementedError(f"no stream kernel for {len(ins)} reads and {n_write} "
                                  f"writes (built: {sorted(PATTERNS)})")
    for t in list(ins) + list(outs):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != x.numel() or t.data_ptr() % 16:
            raise ValueError("stream kernel inputs must be contiguous, 16-byte aligned "
                             "float32 tensors of one length on one device")
    if x.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {x.device}")


def _check_units(ins, unit: str, k: int, ks: tuple[int, ...]) -> None:
    """A built (unit, K), K in ks, on 4 streams, then what _check asks."""
    if unit not in UNITS or k not in ks:
        raise NotImplementedError(f"no unit kernel for unit {unit!r} x {k} (built: units "
                                  f"{sorted(UNITS)}, K in {ks})")
    _check_fixed(ins, "unit")
    _check(ins, N_WRITE)


def _check_fixed(ins, what: str) -> None:
    """The unit and carry kernels are built for 4 reads and 3 writes only."""
    if len(ins) != N_READ:
        raise NotImplementedError(f"the {what} kernels take {N_READ} reads and {N_WRITE} "
                                  f"writes, got {len(ins)} reads")


def _ptrs(tensors, size: int):
    return (ctypes.c_void_p * size)(*(t.data_ptr() for t in tensors))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
