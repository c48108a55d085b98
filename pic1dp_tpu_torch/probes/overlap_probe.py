"""Does the card hide the substep kernels' compute under their memory
traffic?

Port of bench/probe_overlap.py, which times the 4-read + 3-write in-place
aliased stream with K = 0 and 4 trig units per element under the TPU's
default grid pipeline and under emit_pipeline, at block rows 128/256/512.
On Hopper the two pipelines are direct float4 loads (stream_units) at 2, 4
and 8 blocks per SM, standing for the three row counts, and the
cp.async.bulk ring (stream_bulk_units) at 4, 8 and 16 KB tiles; the
outputs are fresh, as in compute_probe, so x stays in [0, lx).

For each row it prints trig x0 (the stream alone), trig x4, and the compute
of the four trig units: trig x4 minus trig x0 with the streams in L2 (2^20
elements, 28 MB against the 50 MB L2, fresh outputs), the launches replayed
from one CUDA graph so that the host's launch rate does not bound them,
scaled to n.  If compute overlaps the traffic, trig x4 is near
max(stream, compute); if it does not, near their sum.

Then the ring's consumer-warp sweep: each ring at trig x0 and x4 with 1
producer warp and SWEEP_WARPS consumer warps (stream_bulk_units'
consumer_warps; without it stream_probes.ring_consumers picks the count
from the blocks an SM holds, printed beside each ring's rows above), with
the blocks per SM the card runs of each.  Last, on the card, the
static SASS instructions of one copy of each unit (unit_sass: cuobjdump
-sass of the built stream library), and the time trig x4's unit
instructions alone take at the card's issue rate, beside the bytes bound.

    python -m pic1dp_tpu_torch.probes.overlap_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import torch

from pic1dp_tpu_torch.ops.stream_probes import (N_READ, N_WRITE, bulk_units_ring,
                                                stream_bulk_units, stream_units)
from pic1dp_tpu_torch.probes import HBM_TBS, Row, describe, device_from_arg, line, parser
from pic1dp_tpu_torch.probes.compute_probe import L2_LOG2, compute_ms, unit_row
from pic1dp_tpu_torch.utils import nvcc

K_TRIG = 4
ISSUE_PER_CLOCK = 4 * 32     # an SM's four schedulers, one warp instruction each a clock
SWEEP_WARPS = (4, 6, 8, 11, 13, 16, 20, 24, 31)
# (label, kernel, keyword arguments)
CASES = (
    ("direct 2 blocks/SM", stream_units, dict(blocks_per_sm=2)),
    ("direct 4 blocks/SM", stream_units, dict(blocks_per_sm=4)),
    ("direct 8 blocks/SM", stream_units, dict(blocks_per_sm=8)),
    ("bulk 4 KB x 4", stream_bulk_units, dict(tile_bytes=4096, stages=4)),
    ("bulk 8 KB x 4", stream_bulk_units, dict(tile_bytes=8192, stages=4)),
    ("bulk 16 KB x 3", stream_bulk_units, dict(tile_bytes=16384, stages=3)),
)


def verdict(stream: float, trig4: float, compute: float) -> str:
    """Where trig x4 lies between max(stream, compute) (0%: fully hidden)
    and stream + compute (100%: serialized)."""
    lo, hi = max(stream, compute), stream + compute
    share = 100.0 * (trig4 - lo) / (hi - lo)
    return (f"max {lo:.4f}, sum {hi:.4f}: nearer the "
            f"{'max (overlapped)' if trig4 - lo < hi - trig4 else 'sum (serialized)'}, "
            f"{share:.0f}% of the way from max to sum")


def run(n: int, device: torch.device, say=print) -> dict[str, Row]:
    say(describe(device, n))
    n_l2 = min(n, 2 ** L2_LOG2)
    say(f"-- {N_READ}r+{N_WRITE}w, fresh outputs, trig x0 and x{K_TRIG}; compute = "
        f"trig x{K_TRIG} - trig x0 at n=2^{n_l2.bit_length() - 1} from L2 (CUDA graph), "
        f"scaled to n --")
    rows: dict[str, Row] = {}
    for c, (label, kernel, kw) in enumerate(CASES):
        for k in (0, K_TRIG):
            name = f"{label} trig x{k}"
            rows[name] = unit_row(name, "trig", k, n, device, 200 + 10 * k + c, kernel, **kw)
        t0, t4 = rows[f"{label} trig x0"].ms, rows[f"{label} trig x{K_TRIG}"].ms
        comp = compute_ms("trig", K_TRIG, n, device, 220 + c, kernel, **kw)
        rows[f"{label} compute"] = Row(f"{label} compute", comp, (N_READ + N_WRITE) * 4 * n)
        extra = ""
        if kernel is stream_bulk_units and device.type == "cuda":
            extra = "  (" + " / ".join(
                f"x{k}: {r.consumers} consumer warps, {r.blocks_per_sm} blocks/SM"
                for k in (0, K_TRIG) for r in [bulk_units_ring("trig", k, **kw)]) + ")"
        say(line(rows[f"{label} trig x0"], device) + extra)
        say(line(rows[f"{label} trig x{K_TRIG}"], device))
        if device.type == "cuda":
            say(f"{label:<34} compute {comp:.4f} ms; trig x{K_TRIG} {t4:.4f} ms against "
                + verdict(t0, t4, comp))
        else:
            say(f"{label:<34} compute {comp:.4f} ms host clock (no device time: no verdict)")
    say(f"-- the rings' consumer-warp sweep: trig x0 and x{K_TRIG}, 1 producer warp + "
        "c consumer warps a block --")
    for c, (label, kernel, kw) in enumerate(CASES):
        if kernel is not stream_bulk_units:
            continue
        for w in SWEEP_WARPS:
            for k in (0, K_TRIG):
                name = f"{label} {w} consumer warps trig x{k}"
                rows[name] = unit_row(name, "trig", k, n, device, 300 + 10 * k + c, kernel,
                                      consumer_warps=w, **kw)
                extra = ""
                if device.type == "cuda":
                    ring = bulk_units_ring("trig", k, consumer_warps=w, **kw)
                    extra = f"  ({ring.blocks_per_sm} blocks/SM)"
                say(line(rows[name], device, width=44) + extra)
    if device.type == "cuda":
        sass = unit_sass()
        for kern, per_unit in sass.items():
            say(f"SASS instructions per unit copy, {kern}<4, 3, U, K>: "
                + ", ".join(f"{u} {v:.1f}" for u, v in per_unit.items()))
        per_elem = K_TRIG * sass["stream_bulk_kernel"]["trig"]
        sms, mhz = nvcc.sm_count(device), max_sm_mhz()
        issue = n * per_elem / (sms * ISSUE_PER_CLOCK * mhz * 1e6) * 1e3
        say(f"trig x{K_TRIG}: {per_elem:.0f} SASS instructions an element for the units "
            f"alone; at one warp instruction per scheduler and clock ({sms} SMs x "
            f"{ISSUE_PER_CLOCK} lanes x {mhz} MHz, clocks.max.sm) that is {issue:.4f} ms, "
            f"against the bytes bound {N_READ + N_WRITE} x 4 B x n / {HBM_TBS} TB/s "
            f"{(N_READ + N_WRITE) * 4 * n / (HBM_TBS * 1e9):.4f} ms")
    return rows


def max_sm_mhz() -> int:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return int(out.split()[0])


def unit_sass() -> dict[str, dict[str, float]]:
    """Static SASS instructions of one copy of each unit, from cuobjdump
    -sass of the built stream library: for stream_rw_kernel and
    stream_bulk_kernel, (instructions at K = 4 - at K = 1) / 15, since the
    float4 body evaluates 4 copies for each of its 4 elements and the
    scalar tail 1 for its one (K unrolled, no loop over copies)."""
    from pic1dp_tpu_torch.ops.stream_probes import UNITS, library

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library().path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            counts[name] += 1
    out = {}
    for kern in ("stream_rw_kernel", "stream_bulk_kernel"):
        per = {}
        for unit, u in UNITS.items():
            n = {k: next(v for f, v in counts.items()
                         if re.search(f"{kern}ILi4ELi3ELi{u}ELi{k}E", f)) for k in (1, 4)}
            per[unit] = (n[4] - n[1]) / 15
        out[kern] = per
    return out


def main(argv=None) -> dict[str, Row]:
    args = parser("does compute overlap the stream traffic").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
