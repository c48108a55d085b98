"""Direct loads against a shared-memory bulk-copy pipeline, for the
substep-2 stream pattern.

Port of bench/probe_pipeline.py:150-156, which times the TPU's default grid
pipeline against Mosaic's multi-buffered manual pipeline
(pltpu.emit_pipeline) for 4 reads and 3 writes, aliased and not.  On Hopper
the same choice is plain loads (ops/stream_probes.stream_rw) against
cp.async.bulk into a ring of shared-memory tiles (stream_bulk); the TPU's
block-row sweep becomes a sweep of tile bytes and stage counts, and of the
blocks per SM for the direct loads.

    python -m pic1dp_tpu_torch.probes.pipeline_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops.stream_probes import bulk_blocks_per_sm, stream_bulk, stream_rw
from pic1dp_tpu_torch.probes import (Row, describe, device_from_arg, fresh_streams,
                                     line, parser, time_ms)

N_READ, N_WRITE = 4, 3
ALIAS = {0: 0, 1: 1, 3: 2}
# (label, kernel, keyword arguments, alias)
CASES = (
    ("default 4 blocks/SM aliased", stream_rw, dict(blocks_per_sm=4), ALIAS),
    ("default 4 blocks/SM no-alias", stream_rw, dict(blocks_per_sm=4), {}),
    ("default 8 blocks/SM aliased", stream_rw, dict(blocks_per_sm=8), ALIAS),
    ("bulk 8 KB x 4 aliased", stream_bulk, dict(tile_bytes=8192, stages=4), ALIAS),
    ("bulk 8 KB x 4 no-alias", stream_bulk, dict(tile_bytes=8192, stages=4), {}),
    ("bulk 4 KB x 2 aliased", stream_bulk, dict(tile_bytes=4096, stages=2), ALIAS),
    ("bulk 4 KB x 8 aliased", stream_bulk, dict(tile_bytes=4096, stages=8), ALIAS),
    ("bulk 16 KB x 3 aliased", stream_bulk, dict(tile_bytes=16384, stages=3), ALIAS),
)


def run(n: int, device: torch.device, say=print) -> dict[str, Row]:
    say(describe(device, n))
    say(f"-- {N_READ}r+{N_WRITE}w, aliased = {ALIAS} (GB/s of the streams) --")
    rows: dict[str, Row] = {}
    for k, (label, kernel, kw, alias) in enumerate(CASES):
        ins = fresh_streams(N_READ, n, device, seed=100 + k)
        ms = time_ms(lambda: kernel(ins, N_WRITE, alias, **kw), device)
        rows[label] = Row(label, ms, (N_READ + N_WRITE) * 4 * n)
        extra = ""
        if kernel is stream_bulk and device.type == "cuda":
            extra = f"  ({bulk_blocks_per_sm(N_READ, N_WRITE, **kw)} blocks/SM)"
        say(line(rows[label], device) + extra)
        del ins
    return rows


def main(argv=None) -> dict[str, Row]:
    args = parser("direct loads against a bulk-copy pipeline").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
