"""Marginal cost of each compute unit of the substep kernels inside the
substep-2 stream.

Port of bench/probe_compute.py.  It times the 4-read + 3-write stream
(ops/stream_probes.stream_units, direct float4 loads, 4 blocks/SM) with K
copies of one unit added per element, the units being the substep kernels'
own device functions (csrc/substep_math.cuh):

  trig  hat_trig for one mode: the grid-angle sincospif after the integer
        reduction, the %, the divide and the hat fold; each substep runs it
        twice (gather at x, deposit at the pushed x);
  poly  the bare sincospif of the turn x / lx: trig without its index math;
  exp   minus_dlnf0_dv, the bump-on-tail two-Gaussian ratio drive;
  wrap  the periodic position wrap;

and prints the marginal ms per unit, (t_K - t_0) / K.  The TPU probe writes
in place (aliased {0:0, 1:1, 3:2}); here the outputs are fresh, since in
place the positions stream x grows with every call and leaves [0, lx),
while on the card a fresh output streams at the in-place rate (see
pingpong_probe).  So every timed call reads x in [0, lx).  A unit's
marginal in HBM is what it costs beyond what the traffic hides, so it also
prints each unit's compute: the same marginal with the streams in L2 (2^20
elements, 28 MB) and the launches replayed from one CUDA graph, scaled to
n.  The last line sets f32 substep 1's overhang (kernel ms
minus its bytes at the ceiling rate of its own pattern, as kernel_probe
prints it) against what its units (two trig, one exp, one wrap) cost in
this probe.

    python -m pic1dp_tpu_torch.probes.compute_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops.stream_probes import LX, N_READ, N_WRITE, stream_units
from pic1dp_tpu_torch.probes import (Row, describe, device_from_arg, fresh_streams,
                                     graph_ms, kernel_probe, line, parser, time_ms)

UNIT_ORDER = ("poly", "trig", "exp", "wrap")
KS = (1, 2, 4)
BASELINE = "baseline (streams only)"
L2_LOG2 = 20                          # 7 streams of 2^20 floats: 28 MB, in L2
# f32 substep 1 runs each of these units per marker this many times
SUBSTEP1_UNITS = {"trig": 2, "exp": 1, "wrap": 1}


def unit_inputs(n: int, device: torch.device, seed: int) -> list[torch.Tensor]:
    """Four streams in [0, 1), the first scaled to [0, lx): it plays x, so
    the units see positions of the production range."""
    ins = fresh_streams(N_READ, n, device, seed)
    ins[0].mul_(LX)
    return ins


def unit_row(label: str, unit: str, k: int, n: int, device: torch.device, seed: int,
             kernel=stream_units, **kw) -> Row:
    """A unit kernel with fresh outputs: every timed call reads the same
    inputs."""
    ins = unit_inputs(n, device, seed)
    ms = time_ms(lambda: kernel(ins, {}, unit, k, **kw), device)
    return Row(label, ms, (N_READ + N_WRITE) * 4 * n)


def compute_ms(unit: str, k: int, n: int, device: torch.device, seed: int,
               kernel=stream_units, **kw) -> float:
    """ms of compute of k copies of a unit at n elements: t_k - t_0 with
    the streams in L2 and fresh outputs (the difference cancels each
    call's fixed cost), timed from a CUDA graph and scaled from 2^L2_LOG2
    elements to n."""
    m = min(n, 2**L2_LOG2)
    ins = unit_inputs(m, device, seed)
    t0, tk = (graph_ms(lambda: kernel(ins, {}, unit, kk, **kw), device) for kk in (0, k))
    return (tk - t0) * n / m


def overhang(n: int, device: torch.device) -> tuple[Row, Row, float]:
    """f32 substep 1, the ceiling of its pattern (4r+2w, fresh outputs) and
    the kernel's ms beyond its bytes at that rate."""
    ss1, _ = kernel_probe.substep_rows(n, device, bf16=False)
    ceiling = kernel_probe.stream_row("port ss1 pattern 4r+2w", 4, 2, {}, n, device, seed=5)
    return ss1, ceiling, ss1.ms - ss1.bytes / (ceiling.gbs * 1e6)


def run(n: int, device: torch.device, say=print) -> dict[str, Row]:
    say(describe(device, n))
    say(f"-- {N_READ}r+{N_WRITE}w, fresh outputs, + K units per element (stream_units, "
        f"4 blocks/SM) --")
    rows = {BASELINE: unit_row(BASELINE, "trig", 0, n, device, seed=0)}
    base = rows[BASELINE].ms
    say(line(rows[BASELINE], device))
    marginal = {}
    for u, unit in enumerate(UNIT_ORDER):
        for k in KS:
            label = f"{unit} x{k}"
            rows[label] = unit_row(label, unit, k, n, device, seed=10 * u + k)
            marginal[unit] = (rows[label].ms - base) / k
            say(line(rows[label], device) + f"  marginal {marginal[unit]:+.4f} ms/unit")
    say(f"-- compute per unit: x4 marginal from L2 (n=2^{min(n, 2**L2_LOG2).bit_length() - 1},"
        f" launches replayed from a CUDA graph), scaled to n --")
    compute = {}
    for u, unit in enumerate(UNIT_ORDER):
        compute[unit] = compute_ms(unit, 4, n, device, seed=100 + u) / 4
        rows[f"{unit} compute"] = Row(f"{unit} compute", compute[unit], 0)
        say(f"{unit + ' compute':<34} {compute[unit]:9.4f} ms/unit"
            + ("" if device.type == "cuda" else " host clock"))
    ss1, ceiling, over = overhang(n, device)
    rows[ss1.label], rows[ceiling.label] = ss1, ceiling
    say(line(ss1, device))
    say(line(ceiling, device))
    traffic = ss1.bytes / (ceiling.gbs * 1e6)

    def split(per_unit: dict) -> str:
        parts = [c * per_unit[u] for u, c in SUBSTEP1_UNITS.items()]
        share = 100.0 * sum(parts) / over if over > 0 else float("nan")
        return (" + ".join(f"{c} {u} {p:.4f}" for (u, c), p in zip(SUBSTEP1_UNITS.items(), parts))
                + f" = {sum(parts):.4f} ms ({share:.0f}% of the overhang)")

    x1 = {u: rows[f"{u} x1"].ms - base for u in UNIT_ORDER}
    x4 = {u: (rows[f"{u} x4"].ms - base) / 4 for u in UNIT_ORDER}
    clock = "" if device.type == "cuda" else "  [host clock]"
    say(f"f32 substep1: {ss1.ms:.4f} ms, its bytes at the ceiling {traffic:.4f} ms, overhang "
        f"{over:+.4f} ms{clock}")
    say(f"  its units at their x1 marginals: {split(x1)}")
    say(f"  its units at their x4 marginals: {split(x4)}")
    say(f"  its units' compute (from L2):    {split(compute)}")
    return rows


def main(argv=None) -> dict[str, Row]:
    args = parser("marginal cost of the substep kernels' compute units").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
