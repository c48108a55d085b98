"""The comparison that decides `correct`: what the window's runs produced
against the plain reference.

A run of these cells is chaotic over its thousands of steps, so the
reference follows the program interval by interval: from the state the
program held at one snapshot (or from the initial markers, which the
benchmark made) it takes the interval's steps in float64 and is compared
with the program's state at the next snapshot and with that snapshot's
record in pic1dp.out.  Each checked record is also compared with the
reference's diagnostics of the program's own state there.  The numbers,
each with a limit in cells/<cell>.json:

  state_rel   the program's x, v and w after an interval against the
              reference's: the largest of max |x - x_ref| / lx (periodic) and,
              species by species, max |v - v_ref| / max |v_ref| and
              max |w - w_ref| / max |w_ref| over that species' markers (each
              species on its own scale: ions' v is some twenty times smaller
              than electrons')
  record_rel  a record of pic1dp.out against the reference's: the largest of
              the modes (as complex numbers), E and rho, each over its own
              largest value; each energy over its scale (itself, and for the
              perturbed energy sum v^2 |w|); each x-v histogram and v profile
              over its largest value, the perturbed ones over the largest of
              the same histogram of |w|
  bad_records records whose time is not their snapshot's, and complete runs
              whose file does not hold every record (an exact count: limit 0)

The scales of the perturbed quantities are sums of absolute values because
their sums cancel: a float32 sum is good to its terms' size, not its own.

Every process calls these functions together: the reference's sums and
the numbers' maxima go over all of them; only rank 0 holds the files.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.outfile import OutFile

NUMBERS = ("state_rel", "record_rel", "bad_records")
F64 = torch.float64


@dataclasses.dataclass
class Records:
    """What the check reads of one run's pic1dp.out: its count of whole
    records, the records it compares and the times of the sampled ones."""

    count: int
    records: dict           # record index -> record
    times: dict             # record index -> time


@dataclasses.dataclass
class RunOutput:
    """What one run of the window left for the check: what it needs of its
    pic1dp.out (rank 0), the snapshots it completed, whether it ran to its
    end, and the program's x, v, w at the captured snapshots."""

    out: Records | None
    snapshots: int
    complete: bool
    captured: dict          # snapshot index -> (x, v, w)
    pairs: list             # (a, b) snapshot pairs to check


def harvest(out: OutFile, snapshots: int, pairs: list, first: bool) -> Records:
    """Read what the check needs of a run's pic1dp.out once the run has
    ended: record 0 of the first run, the record at the end of each pair,
    and the times of the sampled records."""
    have = out.count()
    wanted = {b for _, b in pairs} | ({0} if first else set())
    return Records(count=have, records={j: out.read(j) for j in sorted(wanted) if j < have},
                   times={j: out.time(j) for j in _sample(min(have, snapshots))})


class Numbers:
    """The running maxima of the compared numbers on this process."""

    def __init__(self):
        self.values = dict.fromkeys(NUMBERS, 0.0)

    def update(self, name: str, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self.values[name] = max(self.values[name], value)


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    den = float(ref.abs().max())
    num = float((a - ref).abs().max())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _modes_rel(re, im, ref_re, ref_im) -> float:
    diff = torch.sqrt((re - ref_re) ** 2 + (im - ref_im) ** 2).max()
    den = torch.sqrt(ref_re ** 2 + ref_im ** 2).max()
    return float(diff / den) if den > 0 else (0.0 if diff == 0 else math.inf)


def compare_record(numbers: Numbers, rec: dict, ref: dict, device) -> None:
    """A record of pic1dp.out against the reference's (ref's energies,
    modes, E and rho may be None: not compared)."""
    t = {k: torch.as_tensor(rec[k], dtype=F64, device=device)
         for k in ("energies", "mode_re", "mode_im", "electric", "rho", "xv", "v")}
    worst = max(_modes_rel(t["mode_re"], t["mode_im"], ref["mode_re"], ref["mode_im"]),
                _rel(t["electric"], ref["electric"]), _rel(t["rho"], ref["rho"]))
    if ref.get("energies") is not None:
        e, e_ref = t["energies"], ref["energies"]
        worst = max(worst, float(((e - e_ref).abs() / ref["energy_scales"]).max()))
        for name in ("xv", "v"):
            for s in range(t[name].shape[1]):
                for k in range(3):
                    scale = ref[name][3 if k == 2 else k, s].abs().max()
                    diff = (t[name][k, s] - ref[name][k, s]).abs().max()
                    worst = max(worst, float(diff / scale) if scale > 0 else
                                (0.0 if diff == 0 else math.inf))
    numbers.update("record_rel", worst)


def _state_errors(numbers: Numbers, physics, state: dict, ref: dict, reduce_max) -> None:
    """x, v, w of the program (state, f32) against the reference's (f64),
    (nspecies, n) each: v and w species by species, each species' numerator
    and denominator maximized over the processes before the division."""
    dx = (state["x"].to(F64) - ref["x"]).abs()
    dx = torch.minimum(dx, physics.lx - dx)
    parts = [(dx.max() / physics.lx).view(1)]
    for k in ("v", "w"):
        parts += [(state[k].to(F64) - ref[k]).abs().amax(dim=1), ref[k].abs().amax(dim=1)]
    maxima = reduce_max(torch.cat(parts))
    dv, vmax, dw, wmax = maxima[1:].view(4, -1).tolist()
    rels = [num / den if den > 0 else math.inf
            for nums, dens in ((dv, vmax), (dw, wmax)) for num, den in zip(nums, dens)]
    numbers.update("state_rel", max(float(maxima[0]), *rels))


def check_runs(physics, markers, runs: list[RunOutput], interval: float, dt: float,
               rank: int, reduce, reduce_max) -> dict:
    """The numbers of every checked pair of snapshots of the window's runs,
    the same on every process."""
    numbers = Numbers()
    device = markers.x.device
    p64 = markers.p.to(F64)
    steps_per_interval = int(round(interval / dt))
    bad = 0
    # the runs' start: record 0 of the first run against the reference's
    # diagnostics of the markers the benchmark made
    proj0 = physics.projections(markers.x, markers.w, reduce)
    ref0 = physics.record(0.0, physics.solve(proj0), proj0, markers.x, markers.v,
                          markers.p, markers.w, markers.live, reduce)
    if rank == 0:
        compare_record(numbers, _record(runs[0].out, 0), ref0, device)
    for run in runs:
        out = run.out
        if rank == 0:
            have = out.count
            if have < run.snapshots or (run.complete and have != run.snapshots):
                bad += 1
            bad += sum(1 for j, t in out.times.items()
                       if abs(t - j * interval) > 1e-6 * max(1.0, j * interval))
        for a, b in run.pairs:
            start = (markers.x, markers.v, markers.w) if a == 0 else run.captured[a]
            st = {k: t.to(F64) for k, t in zip(("x", "v", "w"), start)}
            st["p"] = p64
            modes = physics.solve(physics.projections(start[0], start[2], reduce))
            for _ in range((b - a) * steps_per_interval):
                modes, proj = physics.step(st, modes, reduce)
            x, v, w = run.captured[b]
            _state_errors(numbers, physics, {"x": x, "v": v, "w": w}, st, reduce_max)
            del st
            e_ref, rho_ref = physics.grids(modes, proj)
            # the record against the reference's diagnostics of the
            # program's own state there (every process takes part in the sums)
            proj_b = physics.projections(x, w, reduce)
            ref_b = physics.record(b * interval, physics.solve(proj_b), proj_b, x, v,
                                   markers.p, w, markers.live, reduce)
            if rank == 0:
                rec = _record(out, b)
                compare_record(numbers, rec, ref_b, device)
                compare_record(numbers, rec, {"mode_re": modes[0], "mode_im": modes[1],
                                              "electric": e_ref, "rho": rho_ref}, device)
    numbers.update("bad_records", bad)
    vals = reduce_max(torch.tensor([numbers.values[k] for k in NUMBERS], dtype=F64,
                                   device=device)).tolist()
    return dict(zip(NUMBERS, vals))


def _record(out: Records, j: int) -> dict:
    if j not in out.records:
        raise IndexError(f"pic1dp.out has {out.count} records, not {j + 1}")
    return out.records[j]


def _sample(n: int):
    """The records whose time is checked: the first, the last and every
    hundredth."""
    return sorted({0, n - 1, *range(0, n, 100)} & set(range(n)))


def judge(numbers: dict, limits: dict) -> tuple[bool, list[list]]:
    """(correct, [[name, number, limit], ...]): correct when every number is
    at or below its limit."""
    rows = [[k, numbers[k], limits[k]] for k in NUMBERS]
    ok = all(np.isfinite(n) and n <= lim for _, n, lim in rows)
    return ok, rows
