"""End-to-end simulation driver (port of pic1dp_tpu/core/simulation.py).

Reference equivalent: program pic1dp (src/pic1dp.F90:20-126): initialize,
load, initial field solve, RK2 main loop with interval-based output, finalize
with a timer report.

The driver is host-side Python.  Steps between output events are queued on
the device back to back; the host waits for the device only at a snapshot,
at most once per `output_interval`.  Not ported yet: particle optimization
(merge/remove/split), checkpoints, and multi-device runs.
"""

from __future__ import annotations

import math
import sys
from typing import Callable

import numpy as np
import torch

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.diagnostics import Energies
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.io.writer import SnapshotWriter
from pic1dp_tpu_torch.utils.timers import PhaseTimers

_EPS = math.sqrt(np.finfo(np.float64).eps)  # PETSC_SQRT_MACHINE_EPSILON


def _to_host(tree):
    """A NamedTuple of tensors as the same NamedTuple of numpy arrays."""
    return type(tree)(*(t.detach().cpu().numpy() for t in tree))


class Simulation:
    def __init__(self, cfg: Config, out_path: str | None = None,
                 device: torch.device | str = "cuda"):
        opt = cfg.optimization
        if opt.tmerge or opt.tremove or opt.tsplit:
            raise NotImplementedError(
                "particle optimization (merge/remove/split) is not ported to "
                "pic1dp_tpu_torch yet")
        self.cfg = cfg.validate()
        self.device = torch.device(device)
        self.timers = PhaseTimers()
        with self.timers.phase("initialize"):
            self.stepper = Stepper(cfg, self.device)
        self.writer = SnapshotWriter(cfg, out_path) if out_path is not None else None
        self.state: SimState | None = None
        self.itime = 0
        self.time = 0.0

    # ---- lifecycle ----

    def load(self) -> SimState:
        """Load markers and solve the initial field
        (reference src/pic1dp.F90:63-72)."""
        with self.timers.phase("particle load"):
            state = load_particles(self.cfg, self.device)
            state = self.stepper.initial_field(state)
            self._sync()
        self.state = state
        self.itime = 0
        self.time = 0.0
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_termination(self) -> bool:
        """reference check_termination (src/pic1dp.F90:133-148)."""
        return (self.itime >= self.cfg.ntime_max
                or self.time + _EPS >= self.cfg.time_max)

    def _output_due(self) -> bool:
        """Time just crossed a full output interval
        (reference src/pic1dp.F90:98-106)."""
        interval = self.cfg.output_interval
        return math.fmod(self.time + _EPS, interval) < \
            math.fmod(self.time + _EPS - self.cfg.dt, interval)

    def output_snapshot(self) -> dict:
        """Compute + (optionally) write one snapshot; returns the scalars."""
        assert self.state is not None
        with self.timers.phase("output"):
            eng = _to_host(self.stepper.energies(self.state))
            ptcl = _to_host(self.stepper.ptcldist(self.state))
            mode_re, mode_im, electric, rho = (
                t.cpu().numpy() for t in (self.state.mode_re, self.state.mode_im,
                                          self.state.electric, self.state.rho))
            nlive = (self.state.nparticles().cpu().numpy()
                     if self.cfg.verbosity >= 3 else None)
            if self.writer is not None:
                self.writer.write_snapshot(self.time, eng, mode_re, mode_im,
                                           electric, rho, ptcl)
        if self.cfg.verbosity >= 1:
            self._print_progress(eng, mode_re, mode_im, nlive)
        if not np.isfinite(eng.field):
            raise FloatingPointError(
                f"non-finite field energy at t = {self.time:.4f} "
                f"(itime = {self.itime}); the run has diverged — reduce dt "
                "or check the configuration.")
        return {"time": self.time, "field_energy": float(eng.field),
                "marker": eng.marker, "total": eng.total, "pertb": eng.pertb,
                "mode_re": mode_re, "mode_im": mode_im}

    def _plain_steps_ahead(self, limit: int = 4096) -> tuple[int, int, float]:
        """Number of upcoming steps with no output or termination event, by
        walking the schedule arithmetic forward in host time (exactly
        mirrors the per-step advance and _output_due)."""
        k = 0
        itime, time = self.itime, self.time
        while k < limit:
            t_next = time + self.cfg.dt
            itime, time = itime + 1, t_next
            interval = self.cfg.output_interval
            due = math.fmod(time + _EPS, interval) < \
                math.fmod(time + _EPS - self.cfg.dt, interval)
            done = (itime >= self.cfg.ntime_max
                    or time + _EPS >= self.cfg.time_max)
            k += 1
            if due or done:
                break
        # (itime, time) walked with the same repeated addition as a per-step
        # run, so chunked and per-step runs see identical schedule arithmetic
        return k, itime, time

    def run(self, snapshot_callback: Callable[[dict], None] | None = None) -> None:
        """Main loop (reference src/pic1dp.F90:77-109)."""
        if self.cfg.verbosity >= 1:
            # reference src/pic1dp.F90:54-55
            from pic1dp_tpu_torch import __version__

            self._print(f"pic1dp_tpu_torch version {__version__}")
        if self.state is None:
            self.load()
        if self.cfg.verbosity == 1:
            # header belongs to the compact format only (reference
            # src/pic1dp_output.F90:524-526 vs :537)
            self._print("progress:\nprogrss  itime     time  int E^2 dx")
        snap = self.output_snapshot()  # t = 0 snapshot (reference :74)
        if snapshot_callback:
            snapshot_callback(snap)
        while not self._check_termination():
            k, itime_k, time_k = self._plain_steps_ahead()
            with self.timers.phase("step"):
                self.state = self.stepper.multi_step(self.state, k)
                self.itime, self.time = itime_k, time_k
            if self._output_due() or self._check_termination():
                self._sync()
                snap = self.output_snapshot()
                if snapshot_callback:
                    snapshot_callback(snap)
        if self.writer is not None:
            self.writer.close()
        if self.cfg.verbosity >= 1:
            self._print(self.timers.report())

    # ---- logging (reference output_progress, src/pic1dp_output.F90:483-548) ----

    def _print(self, msg: str) -> None:
        print(msg, file=sys.stderr)

    def _progress_pct(self, itime: int, time: float) -> tuple[str, float]:
        pi = 100.0 * itime / self.cfg.ntime_max
        pt = 100.0 * time / self.cfg.time_max
        return ("i", pi) if pi >= pt else ("t", pt)

    def _print_progress(self, eng: Energies, mode_re, mode_im, nlive=None) -> None:
        """Reference output_progress levels (src/pic1dp_output.F90:483-548
        and src/pic1dp_input.F90:240-246): 1 = compact percent line;
        2 = per-event "finished itime" lines; 3 adds a diagnostic dump of
        the snapshot's variables.  All arguments are host values."""
        if self.cfg.verbosity == 1:
            tag, pct = self._progress_pct(self.itime, self.time)
            self._print(f"{tag}{pct:5.1f}% {self.itime:7d} {self.time:9.3f} "
                        f"{float(eng.field):12.3e}")
        elif self.cfg.verbosity >= 2:
            self._print(f"Info: finished itime = {self.itime:7d}, "
                        f"time = {self.time:9.3f}")
        if self.cfg.verbosity >= 3:
            self._print(
                "Info: diagnostics: "
                f"int E^2 dx = {float(eng.field):.6e}; "
                f"marker KE = {np.array2string(np.asarray(eng.marker), precision=6)}; "
                f"total KE = {np.array2string(np.asarray(eng.total), precision=6)}; "
                f"pertb KE = {np.array2string(np.asarray(eng.pertb), precision=6)}; "
                f"live markers = {np.asarray(nlive).tolist()}; "
                f"mode_re = {np.array2string(np.asarray(mode_re), precision=6)}; "
                f"mode_im = {np.array2string(np.asarray(mode_im), precision=6)}")

