"""Is each substep kernel at the streaming ceiling of its access pattern?

Port of bench/kernel_probe.py.  It times

  1. the real substep kernels, f32 and bf16_weights (separate bf16 p and w1
     streams), per call, with v1 streamed from substep 1 to substep 2 and
     without (the recompute layout: substep 2 rebuilds v1);
  2. stream-only kernels (ops/stream_probes.stream_rw: the same direct-load
     access, trivial compute) for the TPU probe's patterns, 4r+1w (substep 1
     without v1) and 4r+3w (substep 2) aliased, 4r+3w not aliased, 3r+1w
     and 4r+4w (bench/kernel_probe.py:206-215), and for the port's own
     substep patterns, 4r+2w (substep 1 writes w1 and v1 to fresh buffers)
     and 6r+3w with x, v, w overwritten;
  3. the compute overhang: kernel time minus the time its bytes take at the
     ceiling rate of its pattern (:217-220);
  4. on cuda, the substep kernels of the layout the config takes
     (substep_kernels.layout) again with their grid capped at each of
     SWEEP_BLOCKS_PER_SM blocks per SM (the sweep that chose
     substep_kernels.BLOCKS_PER_SM).

GB/s counts the streams' bytes only, (reads + writes) * bytes * n.  Timing
is CUDA events after a warm-up (the TPU probe's scan-slope method existed
for its remote connection).

    python -m pic1dp_tpu_torch.probes.kernel_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import bump_on_tail_default
from pic1dp_tpu_torch.ops.stream_probes import stream_rw
from pic1dp_tpu_torch.ops.substep_kernels import NONLINEAR, FusedSubsteps
from pic1dp_tpu_torch.probes import (Row, describe, device_from_arg, fresh_streams,
                                     line, parser, time_ms)

# (label, reads, writes, alias)
TPU_PATTERNS = (
    ("ss1 pattern 4r+1w aliased", 4, 1, {3: 0}),
    ("ss2 pattern 4r+3w aliased", 4, 3, {0: 0, 1: 1, 3: 2}),
    ("ss2 pattern 4r+3w no-alias", 4, 3, {}),
    ("3r+1w aliased", 3, 1, {2: 0}),
    ("4r+4w aliased", 4, 4, {0: 0, 1: 1, 2: 2, 3: 3}),
)
PORT_PATTERNS = (
    ("port ss1 pattern 4r+2w", 4, 2, {}),
    ("port ss2 pattern 6r+3w aliased", 6, 3, {0: 0, 1: 1, 3: 2}),
)
# bytes per marker of one call: substep 1 reads x v p w, writes w1 v1;
# substep 2 reads x v p w w1 v1, writes x v w.  bf16_weights narrows p, w1;
# the recompute layout drops the v1 stream (substep 1 writes w1 only,
# substep 2 reads x v p w w1)
SUBSTEP_BYTES = {("f32", "nonlinear"): (24, 36), ("bf16", "nonlinear"): (20, 32),
                 ("f32", "recompute"): (20, 32), ("bf16", "recompute"): (16, 28)}
SWEEP_BLOCKS_PER_SM = (2, 4, 8, 16)


def substep_rows(n: int, device: torch.device, bf16: bool,
                 blocks_per_sm: int | None = None,
                 stream_v1: bool | None = None) -> tuple[Row, Row]:
    """ms per call of both substeps at n markers, nx 1024, one mode (with
    the grid capped at blocks_per_sm blocks per SM where given), with v1
    streamed or rebuilt (by default as the config's layout)."""
    cfg = bump_on_tail_default(nx=1024, nparticle_max=n, dtype="float32",
                               bf16_weights=bf16, verbosity=0)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, n), generator=gen, device=device) * cfg.lx
    v = torch.randn((1, n), generator=gen, device=device) * 2.0
    p = (torch.randn((1, n), generator=gen, device=device).abs() * 1e-4).to(
        getattr(torch, cfg.p_dtype))
    w = torch.randn((1, n), generator=gen, device=device) * 1e-6
    mre = torch.tensor([1e-4], device=device)
    mim = torch.tensor([5e-5], device=device)
    subs = FusedSubsteps(cfg, dist.SpeciesParams.from_config(cfg, torch.float32, device),
                         stream_v1=stream_v1)
    if blocks_per_sm is not None:
        subs.blocks_per_sm = blocks_per_sm
    w1, v1, _ = subs.substep1(x, v, p, w, mre, mim)
    t1 = time_ms(lambda: subs.substep1(x, v, p, w, mre, mim), device)
    t2 = time_ms(lambda: subs.substep2(x, v, p, w, w1, v1, mre, mim, mre, mim), device)
    name = "bf16" if bf16 else "f32"
    tag = ("" if subs.layout == NONLINEAR else f" {subs.layout}") + (
        "" if blocks_per_sm is None else f" B={blocks_per_sm}")
    b1, b2 = SUBSTEP_BYTES[name, subs.layout]
    return (Row(f"{name} substep1{tag}", t1, b1 * n),
            Row(f"{name} substep2{tag}", t2, b2 * n))


def stream_row(label: str, n_read: int, n_write: int, alias, n: int,
               device: torch.device, seed: int) -> Row:
    """stream_rw on fresh inputs."""
    ins = fresh_streams(n_read, n, device, seed)
    ms = time_ms(lambda: stream_rw(ins, n_write, alias), device)
    return Row(label, ms, (n_read + n_write) * 4 * n)


def run(n: int, device: torch.device, say=print) -> dict[str, Row]:
    say(describe(device, n))
    rows: dict[str, Row] = {}
    say("-- real kernels (per call; GB/s of the streams) --")
    for bf16 in (False, True):
        for stream_v1 in (True, False):
            for row in substep_rows(n, device, bf16, stream_v1=stream_v1):
                rows[row.label] = row
                say(line(row, device))
    say("packed p||w1: not ported (pallas_kernels.py:185-248 avoids a Mosaic penalty; "
        "the bf16 rows above are separate bf16 streams)")
    say("-- stream-only ceilings (stream_rw, direct float4 loads, 4 blocks/SM) --")
    for k, (label, nr, nw, alias) in enumerate(TPU_PATTERNS + PORT_PATTERNS):
        rows[label] = stream_row(label, nr, nw, alias, n, device, seed=k)
        say(line(rows[label], device) + f"  alias={alias}")
    say("-- compute overhang (kernel ms - its bytes at its pattern's ceiling rate) --")
    for name in ("f32", "bf16"):
        parts = []
        for ss, pattern in ((1, "port ss1 pattern 4r+2w"),
                            (2, "port ss2 pattern 6r+3w aliased")):
            k, c = rows[f"{name} substep{ss}"], rows[pattern]
            parts.append(f"ss{ss}: {k.ms - k.bytes / (c.gbs * 1e6):+.4f} ms")
        say(f"{name:<5} " + "   ".join(parts))
    if device.type != "cuda":
        return rows          # the plain versions have no grid
    say("-- substep kernels with the grid capped at B blocks per SM --")
    for bf16 in (False, True):
        for b in SWEEP_BLOCKS_PER_SM:
            for row in substep_rows(n, device, bf16, b):
                rows[row.label] = row
                say(line(row, device))
    return rows


def main(argv=None) -> dict[str, Row]:
    args = parser("substep kernels against stream-only ceilings").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
