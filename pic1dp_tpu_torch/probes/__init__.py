"""Measurement probes of the port's kernels (ports of bench/kernel_probe.py,
bench/probe_pipeline.py, bench/probe_compute.py, bench/probe_overlap.py and
bench/probe_pingpong.py), run as

    python -m pic1dp_tpu_torch.probes.kernel_probe   [n_log2=26] [--device cuda|cpu]
    python -m pic1dp_tpu_torch.probes.pipeline_probe [n_log2=26] [--device cuda|cpu]
    python -m pic1dp_tpu_torch.probes.compute_probe  [n_log2=26] [--device cuda|cpu]
    python -m pic1dp_tpu_torch.probes.overlap_probe  [n_log2=26] [--device cuda|cpu]
    python -m pic1dp_tpu_torch.probes.pingpong_probe [n_log2=26] [--device cuda|cpu]

On cuda they time the kernels with CUDA events after a warm-up; on cpu they
run the plain versions at the size given, with the host clock, which is no
device time.  Helpers shared by all of them live here.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import subprocess
import time

import torch

HBM_TBS = 3.35          # H100 SXM HBM3, NVIDIA's data sheet
# timed calls per line, after WARMUP warm-up calls; an aliased pattern
# multiplies its data by at most 5.5 per call, which stays finite over 22 calls
REPS, WARMUP = 20, 2


@dataclasses.dataclass
class Row:
    """One timed line: ms per call and the bytes one call moves."""

    label: str
    ms: float
    bytes: int

    @property
    def gbs(self) -> float:
        return self.bytes / (self.ms * 1e-3) / 1e9


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("n_log2", nargs="?", type=int, default=26,
                    help="elements (markers) per stream, as a power of 2 (default 26)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def device_from_arg(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {name!r} requested but torch sees no CUDA device; "
                         "pass --device cpu to run the plain versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"the probes run on cuda or cpu, not {name!r}")
    return device


def describe(device: torch.device, n: int) -> str:
    """The device line every probe prints first."""
    if device.type != "cuda":
        return (f"device: cpu (plain versions, host clock: no device time)  "
                f"n=2^{n.bit_length() - 1}")
    smi = ""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return (f"device: {torch.cuda.get_device_name(device)} [{smi}]  "
            f"n=2^{n.bit_length() - 1}")


def time_ms(fn, device: torch.device) -> float:
    """ms per call of fn: CUDA events around REPS calls after WARMUP calls
    on cuda, the host clock on cpu."""
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / REPS


def graph_ms(fn, device: torch.device) -> float:
    """ms per call of fn without the host's launch gaps: REPS calls
    captured in one CUDA graph and replayed, timed with CUDA events after
    a warm-up replay (for short calls, which time_ms would time at the
    host's launch rate).  fn must not grow its data: the replays repeat it.
    On cpu the host clock, as time_ms."""
    if device.type != "cuda":
        return time_ms(fn, device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def fresh_streams(k: int, n: int, device: torch.device, seed: int) -> list[torch.Tensor]:
    """k float32 streams of n values in [0, 1), made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand(n, generator=gen, dtype=torch.float32, device=device)
            for _ in range(k)]


def line(row: Row, device: torch.device, width: int = 34) -> str:
    """A row as printed: on cpu the host time only, no rate."""
    if device.type != "cuda":
        return f"{row.label:<{width}} {row.ms:9.4f} ms host clock"
    return (f"{row.label:<{width}} {row.ms:9.4f} ms  {row.gbs:8.1f} GB/s"
            f"  ({100.0 * row.gbs / (HBM_TBS * 1e3):5.1f}% of {HBM_TBS} TB/s)")
