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

    python -m pic1dp_tpu_torch.probes.overlap_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops.stream_probes import (N_READ, N_WRITE, bulk_units_blocks_per_sm,
                                                stream_bulk_units, stream_units)
from pic1dp_tpu_torch.probes import Row, describe, device_from_arg, line, parser
from pic1dp_tpu_torch.probes.compute_probe import L2_LOG2, compute_ms, unit_row

K_TRIG = 4
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
            extra = (f"  ({bulk_units_blocks_per_sm('trig', 0, **kw)} / "
                     f"{bulk_units_blocks_per_sm('trig', K_TRIG, **kw)} blocks/SM)")
        say(line(rows[f"{label} trig x0"], device) + extra)
        say(line(rows[f"{label} trig x{K_TRIG}"], device))
        if device.type == "cuda":
            say(f"{label:<34} compute {comp:.4f} ms; trig x{K_TRIG} {t4:.4f} ms against "
                + verdict(t0, t4, comp))
        else:
            say(f"{label:<34} compute {comp:.4f} ms host clock (no device time: no verdict)")
    return rows


def main(argv=None) -> dict[str, Row]:
    args = parser("does compute overlap the stream traffic").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
