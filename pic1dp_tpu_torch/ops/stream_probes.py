"""Stream-only probe kernels: the streaming ceiling of an access pattern.

Port of the TPU probe kernels stream_only (bench/kernel_probe.py:140, body
:143-158), default_pipeline (bench/probe_pipeline.py:78) and manual_pipeline
(:104).  Each reads NR float32 streams and writes NW:

    acc   = in_0 + ... + in_{NR-1}
    out_j = acc * (1 + 0.25 j)          j < NW
    total = sum of acc over every element

`alias` maps an input index to the output index that overwrites it (the
TPU kernels' input_output_aliases, e.g. {0: 0, 1: 1, 3: 2} for the
substep-2 pattern); an output no input maps to goes to a fresh buffer.

This module holds, for both kernels of csrc/stream_probes.cu (built by nvcc
at first use, bound through ctypes):

  * stream_rw, direct float4 loads (stream_only and default_pipeline), with
    its launch counter STREAM_RW;
  * stream_bulk, a shared-memory ring filled by cp.async.bulk
    (manual_pipeline), with its launch counter STREAM_BULK;
  * stream_plain, the plain PyTorch version of both.

A CPU tensor takes stream_plain; a CUDA tensor launches the kernel or
raises.  Nothing falls back.  Every call returns (outputs, total) with total
a float64 0-d tensor on the streams' device, summed in float64.
"""

from __future__ import annotations

import ctypes

import torch

from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

SOURCE = "stream_probes"
_SRC = f"pic1dp_tpu_torch/csrc/{SOURCE}.cu"

STREAM_RW = CudaKernel("stream_rw", _SRC, "bench/kernel_probe.py:140")
STREAM_BULK = CudaKernel("stream_bulk", _SRC, "bench/probe_pipeline.py:104")
KERNELS = (STREAM_RW, STREAM_BULK)

# (reads, writes) built: PIC1DP_PATTERNS in csrc/stream_probes.cu
PATTERNS = frozenset({(3, 1), (4, 1), (4, 2), (4, 3), (4, 4), (6, 3)})
MAX_IN, MAX_OUT = 6, 4
MAX_STAGES = 16


def outputs(ins, n_write: int, alias: dict[int, int]) -> list[torch.Tensor]:
    """The output buffers: the aliased input for an aliased output, a fresh
    tensor for the others."""
    _check_alias(len(ins), n_write, alias)
    by_out = {j: i for i, j in alias.items()}
    return [ins[by_out[j]] if j in by_out else torch.empty_like(ins[0])
            for j in range(n_write)]


def stream_plain(ins, n_write: int, alias: dict[int, int]):
    """The plain PyTorch version of both kernels, on any device."""
    outs = outputs(ins, n_write, alias)
    acc = ins[0]
    for t in ins[1:]:
        acc = acc + t
    for j, o in enumerate(outs):
        o.copy_(acc * (1.0 + 0.25 * j))
    return outs, acc.sum(dtype=torch.float64)


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
    `stages` slots of tile_bytes per input stream."""
    if ins[0].device.type == "cpu":
        return stream_plain(ins, n_write, alias)
    _check(ins, n_write)
    grid = bulk_blocks_per_sm(len(ins), n_write, tile_bytes, stages) \
        * nvcc.sm_count(ins[0].device)
    lib = library().lib
    outs = outputs(ins, n_write, alias)
    partials = torch.empty(grid, dtype=torch.float64, device=ins[0].device)
    rc = lib.pic1dp_stream_bulk(len(ins), n_write, _ptrs(ins, MAX_IN),
                                _ptrs(outs, MAX_OUT), ins[0].numel(), tile_bytes // 4,
                                stages, partials.data_ptr(), grid, _stream(ins[0]))
    STREAM_BULK.launched(rc, lib)
    return outs, partials.sum()


def bulk_blocks_per_sm(n_read: int, n_write: int, tile_bytes: int, stages: int) -> int:
    """Blocks of stream_bulk resident per SM for this ring (raises if none
    fits in shared memory)."""
    if tile_bytes < 16 or tile_bytes % 16 or not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stream_bulk takes tiles of a multiple of 16 bytes and 1 to "
                         f"{MAX_STAGES} stages, got {tile_bytes} bytes x {stages}")
    lib = library().lib
    per_sm = ctypes.c_int(0)
    rc = lib.pic1dp_stream_bulk_blocks_per_sm(n_read, n_write, tile_bytes // 4, stages,
                                              ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"stream_bulk setup failed: "
                           f"{lib.pic1dp_error_string(rc).decode()} ({rc})")
    if per_sm.value < 1:
        raise ValueError(f"a ring of {stages} x {n_read} x {tile_bytes} bytes does not "
                         "fit in one SM's shared memory")
    return per_sm.value


_lib: nvcc.Library | None = None


def library() -> nvcc.Library:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        built = nvcc.load(SOURCE)
        lib = built.lib
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pic1dp_stream_rw.argtypes = [i32, i32, ptr, ptr, i64, ptr, i32, ptr]
        lib.pic1dp_stream_bulk.argtypes = [i32, i32, ptr, ptr, i64, i32, i32, ptr, i32, ptr]
        lib.pic1dp_stream_bulk_blocks_per_sm.argtypes = [i32, i32, i32, i32,
                                                         ctypes.POINTER(i32)]
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        _lib = built
    return _lib


def _check_alias(n_read: int, n_write: int, alias: dict[int, int]) -> None:
    if any(not 0 <= i < n_read for i in alias) or \
            any(not 0 <= j < n_write for j in alias.values()) or \
            len(set(alias.values())) != len(alias):
        raise ValueError(f"alias {alias} must map distinct inputs (< {n_read}) to "
                         f"distinct outputs (< {n_write})")


def _check(ins, n_write: int) -> None:
    """What the kernels take: a built (reads, writes) pattern of contiguous
    float32 CUDA tensors of one length, each 16-byte aligned."""
    x = ins[0]
    if (len(ins), n_write) not in PATTERNS:
        raise NotImplementedError(f"no stream kernel for {len(ins)} reads and {n_write} "
                                  f"writes (built: {sorted(PATTERNS)})")
    for t in ins:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != x.numel() or t.data_ptr() % 16:
            raise ValueError("stream kernel inputs must be contiguous, 16-byte aligned "
                             "float32 tensors of one length on one device")
    if x.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {x.device}")


def _ptrs(tensors, size: int):
    return (ctypes.c_void_p * size)(*(t.data_ptr() for t in tensors))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
