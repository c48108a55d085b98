"""What a carry layout costs the substep-2 stream over a loop of steps.

Port of bench/probe_pingpong.py, which runs the 4-read + 3-write stream body
inside a k-step lax.scan under the TPU's carry layouts.  The stream roles
are substep 2's: reads (x, v, pw, w), writes (x2, v2, w2) into the slots of
x, v and w; pw is read only.  On the card a layout is a choice of buffers
(ops/stream_probes.stream_carry), and the loop is a Python loop:

  inplace   outputs over their inputs, one buffer per stream;
  noalias   fresh outputs every step (torch's caching allocator hands back
            the buffers freed by the step before);
  pingpong  one (2, n) buffer per stream, read at half h and written at half
            1 - h; h is an int32 on the device, flipped by a device op after
            each launch (no host sync);
  pp2       two buffer sets: each step writes into the other set's buffers.

The TPU's pp2-free (the same two-step body with no aliasing hints) measured
XLA's buffer assignment and has no counterpart here; it is printed as such
and maps to noalias.  Each layout is timed with CUDA events over 20 steps
after 2 warm-up steps, from fresh inputs, in ms per step and GB/s of the 7
streams.

    python -m pic1dp_tpu_torch.probes.pingpong_probe [n_log2=26] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses

import torch

from pic1dp_tpu_torch.ops.stream_probes import ALIAS, N_READ, N_WRITE, stream_carry
from pic1dp_tpu_torch.probes import (Row, describe, device_from_arg, fresh_streams, line,
                                     parser, time_ms)

LAYOUTS = ("inplace", "noalias", "pingpong", "pp2")


@dataclasses.dataclass
class Carry:
    """The loop's carry under one layout: the stream slots (x, v, pw, w),
    pingpong's half index h and pp2's three spare buffers."""

    layout: str
    bufs: list
    h: torch.Tensor | None = None
    spare: list | None = None


def carry(layout: str, ins) -> Carry:
    """The carry of `layout` made from four (n,) streams (kept by the flat
    layouts, copied into both halves by pingpong)."""
    if layout == "pingpong":
        return Carry(layout, [torch.stack([a, a]) for a in ins],
                     h=torch.zeros(1, dtype=torch.int32, device=ins[0].device))
    if layout == "pp2":
        return Carry(layout, list(ins), spare=[torch.zeros_like(ins[0]) for _ in range(3)])
    if layout in ("inplace", "noalias"):
        return Carry(layout, list(ins))
    raise ValueError(f"unknown layout {layout!r} (layouts: {LAYOUTS})")


def step(c: Carry, kernel=stream_carry) -> torch.Tensor:
    """One step: the kernel (stream_carry or stream_carry_plain) on the
    carry, whose slots then hold (x2, v2, pw, w2); returns its total."""
    b = c.bufs
    if c.layout == "pingpong":
        (o0, o1, o2), total = kernel(b, ALIAS, h=c.h)
        c.h.bitwise_xor_(1)
    elif c.layout == "pp2":
        (o0, o1, o2), total = kernel(b, {}, dest=c.spare)
        c.spare = [b[0], b[1], b[3]]
    else:
        (o0, o1, o2), total = kernel(b, ALIAS if c.layout == "inplace" else {})
    c.bufs = [o0, o1, b[2], o2]
    return total


def run(n: int, device: torch.device, say=print) -> dict[str, Row]:
    say(describe(device, n))
    say(f"-- {N_READ}r+{N_WRITE}w stream body per step (stream_carry, 4 blocks/SM), "
        f"slots x<-o0 v<-o1 pw kept w<-o2 --")
    rows: dict[str, Row] = {}
    for k, layout in enumerate(LAYOUTS):
        c = carry(layout, fresh_streams(N_READ, n, device, seed=300 + k))
        rows[layout] = Row(layout, time_ms(lambda: step(c, stream_carry), device),
                           (N_READ + N_WRITE) * 4 * n)
        say(line(rows[layout], device) + "  per step")
        del c
    say("pp2-free: no counterpart on the card (it measured XLA's buffer assignment "
        "without hints); see noalias")
    return rows


def main(argv=None) -> dict[str, Row]:
    args = parser("carry layouts of the substep-2 stream").parse_args(argv)
    return run(2 ** args.n_log2, device_from_arg(args.device))


if __name__ == "__main__":
    main()
