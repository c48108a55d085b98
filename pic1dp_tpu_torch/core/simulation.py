"""End-to-end simulation driver (port of pic1dp_tpu/core/simulation.py).

Reference equivalent: program pic1dp (src/pic1dp.F90:20-126): initialize,
load, initial field solve, RK2 main loop with scheduled particle optimization
and interval-based output, finalize with a timer report.

The main loop is host-side Python.  Steps between events are queued on the
device back to back; the host waits for the device only at a snapshot, at
most once per `output_interval`, at a step with a scheduled optimization
(merge/remove/split), and at a checkpoint.  One process, one device:
multi-device runs and the per-process sharded checkpoint are not ported.

Checkpoints are the JAX package's .npz files, key for key, so either package
resumes the other's (same config JSON, same arrays, bfloat16 p stored
widened to float32).  Two keys differ in meaning:

  * `key`: the JAX package keeps its jax.random key there.  This package
    has none.  A file it writes carries np.array([0, seed], uint32), which
    is what jax.random.PRNGKey(seed) holds for seed < 2**32; a key it read
    from a file is kept and written back unchanged.
  * `torch_generator_state` / `torch_generator_device`: this package's own
    generator (the loader's and the optimization dice's), which the JAX
    package never reads (it reads keys by name).  A file without it (one the
    JAX package wrote), or with the state of a generator on another kind of
    device, resumes with a generator seeded from cfg.rng.seed and the step
    count, so that the dice after the resume do not repeat the loader's
    numbers.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
from typing import Callable

import numpy as np
import torch

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.diagnostics import Energies
from pic1dp_tpu_torch.core.loading import PertbShape, load_particles
from pic1dp_tpu_torch.core.state import FIELDS, SimState, torch_dtype
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.io.writer import SnapshotWriter
from pic1dp_tpu_torch.utils.timers import PhaseTimers

_EPS = math.sqrt(np.finfo(np.float64).eps)  # PETSC_SQRT_MACHINE_EPSILON


def _to_host(tree):
    """A NamedTuple of tensors as the same NamedTuple of numpy arrays."""
    return type(tree)(*(t.detach().cpu().numpy() for t in tree))


# config fields that may differ between a checkpoint and the run resuming
# it: they affect neither the saved state nor its physics
_RUN_ONLY = {"time_max", "ntime_max", "output_interval", "verbosity", "deposit_method",
             "deposit_chunk", "diag_full_rho", "nx_opd", "nv_opd"}


class Simulation:
    def __init__(self, cfg: Config, pertb_shape: PertbShape | None = None,
                 out_path: str | None = None, emulate_ranks: int = 1,
                 checkpoint_interval: float | None = None,
                 checkpoint_path: str | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg.validate()
        self.device = torch.device(device)
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_path = checkpoint_path or "."
        self._last_checkpoint_time = 0.0
        self.timers = PhaseTimers()
        with self.timers.phase("initialize"):
            self.stepper = Stepper(cfg, self.device)
        self.pertb_shape = pertb_shape
        self.emulate_ranks = emulate_ranks
        self.writer = SnapshotWriter(cfg, out_path) if out_path is not None else None
        self.state: SimState | None = None
        self.itime = 0
        self.time = 0.0
        # the loader's numbers and the optimization dice (see the module
        # docstring for `key`)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.rng.seed)
        self.key = np.array([0, cfg.rng.seed & 0xFFFFFFFF], dtype=np.uint32)
        # optimization schedule cursors (reference particle_imerge/iremove/
        # isplit, src/pic1dp_particle.F90:26, :73-87)
        self._imerge = 0
        self._iremove = 0
        self._isplit = 0

    # ---- lifecycle ----

    def load(self) -> SimState:
        """Load markers and solve the initial field
        (reference src/pic1dp.F90:63-72)."""
        with self.timers.phase("particle load"):
            state = load_particles(self.cfg, self.device, self.generator,
                                   self.pertb_shape, self.emulate_ranks)
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

    def _events_due(self, t_next: float) -> tuple[bool, bool, bool]:
        """Whether merge, remove, split are scheduled for the step that ends
        at t_next, given the cursors (delta-f only, reference :762)."""
        opt = self.cfg.optimization
        if not self.cfg.deltaf:
            return False, False, False
        return (self._imerge < len(opt.tmerge) and t_next >= opt.tmerge[self._imerge],
                self._iremove < len(opt.tremove) and t_next >= opt.tremove[self._iremove],
                self._isplit < len(opt.tsplit) and t_next >= opt.tsplit[self._isplit])

    def _optimization_due(self) -> tuple[float | None, float | None, float | None]:
        """Thresholds for merge/remove/split if scheduled for this step
        (reference particle_optimize, src/pic1dp_particle.F90:752-813)."""
        opt = self.cfg.optimization
        merge, remove, split = self._events_due(self.time + self.cfg.dt)
        return (opt.thshmerge[self._imerge] if merge else None,
                (opt.thshremove[self._iremove]
                 if opt.typeremove == 1 and opt.thshremove else 0.0) if remove else None,
                opt.thshsplit[self._isplit] if split else None)

    def step_once(self) -> None:
        """Advance one full RK2 step, applying scheduled optimization."""
        assert self.state is not None, "call load() first"
        merge, remove, split = self._optimization_due()
        if merge is None and remove is None and split is None:
            self.state = self.stepper.step(self.state)
        else:
            # sub-phase timers nest inside run()'s "step" phase, mirroring
            # the reference's overlapping wtimer slots (push/optimize/collect
            # inside total, src/pic1dp_global.F90:38-50)
            with self.timers.phase("step: push pair"):
                state = self.stepper.push_pair(self.state)
            with self.timers.phase("optimize particle"):
                state = self.stepper.apply_optimizations(
                    state, self.generator, merge=merge, remove=remove, split=split)
            if merge is not None:
                self._imerge += 1
            if remove is not None:
                self._iremove += 1
            if split is not None:
                self._isplit += 1
            with self.timers.phase("step: collect + solve"):
                self.state = self.stepper.collect_and_solve(state)
            if self.cfg.verbosity >= 1:
                n = int(torch.sum(self.state.nparticles()))
                # reference output_progress(2), src/pic1dp_output.F90:528-532
                # (level 1: progress-prefixed line) / :544-546 (level >= 2)
                if self.cfg.verbosity == 1:
                    tag, pct = self._progress_pct(
                        self.itime + 1, self.time + self.cfg.dt)
                    self._print(
                        f"{tag}{pct:5.1f}% {self.itime + 1:7d} "
                        f"{self.time + self.cfg.dt:9.3f} : optimization "
                        f"performed, current # of particles {n}")
                else:
                    self._print("Info: particle_optimize performed, "
                                f"current # of particles: {n}")
        self.itime += 1
        self.time += self.cfg.dt

    def output_snapshot(self) -> dict:
        """Compute + (optionally) write one snapshot; returns the scalars."""
        assert self.state is not None
        with self.timers.phase("output"):
            eng = _to_host(self.stepper.energies(self.state))
            ptcl = _to_host(self.stepper.ptcldist(self.state))
            rho = self.state.rho
            if self.cfg.diag_full_rho and self.writer is not None:
                # exact full-spectrum grid charge for the diagnostic stream
                # (reference writes the deposited rho, all modes)
                rho = self.stepper.full_rho(self.state)
            mode_re, mode_im, electric, rho = (
                t.cpu().numpy() for t in (self.state.mode_re, self.state.mode_im,
                                          self.state.electric, rho))
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
                "or check the configuration. Last checkpoint (if enabled) "
                f"is in {self.checkpoint_path!r}.")
        return {"time": self.time, "field_energy": float(eng.field),
                "marker": eng.marker, "total": eng.total, "pertb": eng.pertb,
                "mode_re": mode_re, "mode_im": mode_im}

    def _plain_steps_ahead(self, limit: int = 4096) -> tuple[int, int, float]:
        """Number of upcoming steps with no output, optimization, or
        termination event, by walking the schedule arithmetic forward in
        host time (exactly mirrors step_once/_output_due); 0 when the next
        step is an optimization step."""
        k = 0
        itime, time = self.itime, self.time
        while k < limit:
            t_next = time + self.cfg.dt
            if any(self._events_due(t_next)):
                break  # optimization event: must run the slow path
            itime, time = itime + 1, t_next
            interval = self.cfg.output_interval
            due = math.fmod(time + _EPS, interval) < \
                math.fmod(time + _EPS - self.cfg.dt, interval)
            done = (itime >= self.cfg.ntime_max
                    or time + _EPS >= self.cfg.time_max)
            k += 1
            if due or done:
                break
        # (itime, time) walked with the same repeated addition as step_once,
        # so chunked and per-step runs see identical schedule arithmetic
        return k, itime, time

    def run(self, snapshot_callback: Callable[[dict], None] | None = None) -> None:
        """Main loop (reference src/pic1dp.F90:77-109).  Steps between
        events go to the device in one multi_step call; a step with
        scheduled particle optimization takes the per-step path."""
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
                if k > 0:
                    self.state = self.stepper.multi_step(self.state, k)
                    self.itime, self.time = itime_k, time_k
                else:
                    self.step_once()
            if self._output_due() or self._check_termination():
                self._sync()
                snap = self.output_snapshot()
                if snapshot_callback:
                    snapshot_callback(snap)
            self._maybe_checkpoint()
        if self.writer is not None:
            self.writer.close()
        if self.cfg.verbosity >= 1:
            self._print(self.timers.report())

    # ---- checkpoint / resume (no reference equivalent: the reference
    # restarts from t = 0 on any failure) ----

    def save_checkpoint(self, path: str | None = None) -> str:
        """Write full restart state (particle arrays, field, time counters,
        RNG key and generator state, optimization-schedule cursors) as an
        .npz; atomic rename so a crash mid-write never corrupts the previous
        checkpoint.  The keys are the JAX package's (module docstring)."""
        assert self.state is not None, "nothing to checkpoint"
        if path is None:
            path = os.path.join(self.checkpoint_path, "checkpoint.npz")
        self._sync()
        arrays = {f: getattr(self.state, f).detach().cpu() for f in FIELDS}
        # npz cannot represent bfloat16; store p widened to f32 — lossless —
        # and restore re-narrows per cfg.p_dtype
        if arrays["p"].dtype == torch.bfloat16:
            arrays["p"] = arrays["p"].float()
        arrays = {f: t.numpy() for f, t in arrays.items()}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(
                    fh,
                    itime=self.itime, time=self.time,
                    imerge=self._imerge, iremove=self._iremove, isplit=self._isplit,
                    key=self.key,
                    config_json=np.frombuffer(self.cfg.to_json().encode(), dtype=np.uint8),
                    torch_generator_state=self.generator.get_state().numpy(),
                    torch_generator_device=np.frombuffer(self.device.type.encode(),
                                                         dtype=np.uint8),
                    **arrays,
                )
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Resume from save_checkpoint output, this package's or the JAX
        package's (config must match; a mismatch raises so silent divergence
        is impossible)."""
        with np.load(path) as ck:
            saved_cfg = bytes(ck["config_json"]).decode()
            if saved_cfg != self.cfg.to_json():
                # allow fields that don't affect the saved state or its
                # physics to differ — extending a run (time_max/ntime_max),
                # changing output cadence/verbosity, or re-tuning the
                # execution knobs is exactly what resume is for
                a = json.loads(saved_cfg)
                b = json.loads(self.cfg.to_json())
                diff = {k for k in set(a) | set(b) if a.get(k) != b.get(k)} - _RUN_ONLY
                if diff:
                    raise ValueError(
                        f"checkpoint {path} was written with a different "
                        f"config (state-affecting fields differ: "
                        f"{sorted(diff)})")
            if any("@" in k for k in ck.files):
                raise NotImplementedError(
                    f"checkpoint {path} holds per-process shards (keys with '@', "
                    "written by a multi-host run of pic1dp_tpu); pic1dp_tpu_torch "
                    "restores single-process checkpoints only")
            state = SimState.from_numpy({f: ck[f] for f in FIELDS}, self.device)
            state.p = state.p.to(torch_dtype(self.cfg.p_dtype))
            self.state = state
            self.itime = int(ck["itime"])
            self.time = float(ck["time"])
            self._imerge = int(ck["imerge"])
            self._iremove = int(ck["iremove"])
            self._isplit = int(ck["isplit"])
            self.key = np.array(ck["key"])
            if ("torch_generator_state" in ck.files
                    and bytes(ck["torch_generator_device"]).decode() == self.device.type):
                self.generator.set_state(torch.from_numpy(np.array(ck["torch_generator_state"])))
            else:
                self.generator.manual_seed((self.cfg.rng.seed + 1) * 1_000_003 + self.itime)
        self._last_checkpoint_time = self.time

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_interval is not None
                and self.time - self._last_checkpoint_time
                >= self.checkpoint_interval - _EPS):
            path = self.save_checkpoint()
            self._last_checkpoint_time = self.time
            if self.cfg.verbosity >= 2:
                self._print(f"checkpoint written: {path}")

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

