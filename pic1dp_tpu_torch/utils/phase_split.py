"""Per-phase timing of the RK2 step (port of pic1dp_tpu/utils/phase_split.py).

The reference answers "where did the time go?" with a cumulative wall-clock
table printed at exit (src/wtimer.F90:40-44, report
src/pic1dp_output.F90:576-627): push, shape, collect charge, field solve.
The port's step fuses them into two substep kernels, so per-phase numbers
cannot be read off the production step.  This module runs each phase as
its own loop and times it with the two-point slope method: the time of 3k
iterations less that of k, over 2k, each side the least of three runs, so
that what a run costs once (a launch, a host wait) cancels.

On a CUDA device each loop is captured in a CUDA graph and replayed, timed
with CUDA events; the full-step row times Stepper.graph_steps, the
production path.  On the CPU each loop runs eagerly on the host clock, and
the substep rows time the kernels' plain versions (what a CPU Stepper
runs).  One device only: the JAX package's mesh branch (loops under
shard_map, psums included) has no counterpart until multi-device runs are
ported.

Attribution caveats, as in the JAX package:
  * each phase loop re-reads its inputs from memory, while the fused step
    keeps them in registers, so the phase sum exceeds the fused step time;
    both are reported, and the difference is the measured fusion gain;
  * "shape + gather E" and "collect charge" each include the mode_trig
    evaluation the fused step shares between them;
  * the substep-2 loop updates a copy of x, v and w in place, as the
    kernel does, so its markers move from one iteration to the next.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from pic1dp_tpu_torch.ops import spectral as spectral_ops

TRIES = 3          # runs of each side of a slope; the least counts


def _seconds(run, device: torch.device) -> float:
    """Seconds of one run(): CUDA events on a CUDA device, else the host
    clock."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _slope(loop, k: int, device: torch.device, capture: bool = True) -> float:
    """Seconds per iteration of loop(n), which runs n iterations of a
    phase, by the two-point slope.  On a CUDA device each side runs once
    eagerly and is then captured in a CUDA graph (capture=False: loop is
    replayed as it is, for a loop that replays graphs itself)."""
    from pic1dp_tpu_torch.core.step import CountedGraph

    runs = {}
    for n in (k, 3 * k):
        if device.type == "cuda" and capture:
            loop(n)
            torch.cuda.synchronize(device)
            graph = CountedGraph(lambda n=n: loop(n))
            graph.replay()
            runs[n] = graph.replay
        else:
            loop(n)
            runs[n] = lambda n=n: loop(n)
    times = {n: [] for n in runs}
    for _ in range(TRIES):
        for n, run in runs.items():
            times[n].append(_seconds(run, device))
    return max((min(times[3 * k]) - min(times[k])) / (2 * k), 0.0)


def measure_phase_split(stepper, state, steps: int = 10) -> "OrderedDict[str, float]":
    """Per-phase seconds-per-step table of a matrix-free Stepper on one
    device, from `state` (left as it is: the loops run on copies).  Phases
    run twice per step (two RK substeps) are already doubled.  The keys are
    the JAX package's on its fused path, in its order: the reference's
    wtimer slots (push / shape / collect / field), each substep kernel, the
    sum of the four phases and the measured full step."""
    cfg = stepper.cfg
    device = state.x.device
    dt = cfg.dt
    x, v, p, w, live = state.x, state.v, state.p, state.w, state.live
    mre, mim = state.mode_re, state.mode_im

    def trig(xx):
        return spectral_ops.mode_trig(xx, cfg.lx, cfg.nx, cfg.modes)

    def deposit_val():
        val = w if cfg.deltaf else p.to(stepper.dtype)
        return torch.where(live, val, 0.0) * stepper.sp.charge

    def repeat(body):
        def loop(n):
            for _ in range(n):
                body()
        return loop

    # shape + gather E: mode_trig + efield_at
    def gather():
        spectral_ops.efield_at(trig(x), mre, mim)

    # push: the x/w/v update given the gathered field (reference
    # interaction_push_particle body, src/pic1dp_interaction.F90:260-338)
    e_p = spectral_ops.efield_at(trig(x), mre, mim)

    def push():
        stepper._push_math(e_p, x, v, p, w, x, v, w, dt)

    # collect charge: mode_trig + the mode projections
    def collect():
        spectral_ops.project_modes(trig(x), deposit_val())

    # field solve: projections -> mode components -> grid E, as standalone
    # torch ops (the price of the unfused phase: the production step solves
    # the modes in the substep kernels' last block and forms E once a
    # multi_step call, not once a step)
    pc0, ps0 = spectral_ops.project_modes(trig(x), deposit_val())

    def solve():
        mre2, mim2 = spectral_ops.solve_modes_from_projections(
            pc0, ps0, stepper.spectral.grad_inv, cfg.lx)
        stepper.spectral.e_grid(mre2, mim2)

    table: "OrderedDict[str, float]" = OrderedDict()
    table["push particle"] = 2.0 * _slope(repeat(push), steps, device)
    table["shape + gather E"] = 2.0 * _slope(repeat(gather), steps, device)
    table["collect charge"] = 2.0 * _slope(repeat(collect), steps, device)
    table["field solve"] = 2.0 * _slope(repeat(solve), 64 * steps, device)

    # the two substep kernels (the plain versions on the CPU) in the layout
    # the Stepper chose, solving the modes where its steps do; substep 2
    # updates its copies of x, v and w in place
    solves = stepper.kernel_solves
    w1, v1 = stepper._substep1(x, v, p, w, mre, mim, solve=solves)[:2]
    x2, v2, w2 = x.clone(), v.clone(), w.clone()

    def substep1():
        stepper._substep1(x, v, p, w, mre, mim, solve=solves)

    def substep2():
        stepper._substep2(x2, v2, p, w2, w1, v1, mre, mim, mre, mim, solve=solves)

    table["substep-1 kernel (fused)"] = _slope(repeat(substep1), steps, device)
    table["substep-2 kernel (fused)"] = _slope(repeat(substep2), steps, device)
    table["sum of phases (unfused)"] = (
        table["push particle"] + table["shape + gather E"]
        + table["collect charge"] + table["field solve"])

    # the production step: graph replays on a CUDA device, steps on the CPU
    box = [stepper.step(state.clone())]
    if device.type == "cuda":
        def steps_loop(n):
            box[0] = stepper.graph_steps(box[0], n)
    else:
        def steps_loop(n):
            box[0] = stepper.multi_step(box[0], n)
    table["full step (measured)"] = _slope(steps_loop, steps, device, capture=False)
    return table


def format_phase_table(table: "OrderedDict[str, float]") -> str:
    """Render the per-phase table (reference output_wtimer,
    src/pic1dp_output.F90:576-627 layout: name, time, % of total); the JAX
    package's text, line for line."""
    total = table.get("full step (measured)", 0.0)
    # sub-microsecond totals mean the slope was lost in host noise (tiny CPU
    # cases); print absolute times and skip the meaningless percentages
    denom = total if total > 1e-6 else float("inf")
    lines = ["Info: per-phase step decomposition (scan-slope method):",
             f"{'phase':>26} {'ms/step':>10} {'% of step':>10}"]
    for name, sec in table.items():
        lines.append(f"{name:>26} {sec * 1e3:10.4f} "
                     f"{100.0 * sec / denom:9.1f}%")
    gain = table.get("sum of phases (unfused)", 0.0) - total
    lines.append(f"{'fusion gain':>26} {gain * 1e3:10.4f} "
                 f"{100.0 * gain / denom:9.1f}%")
    return "\n".join(lines)
