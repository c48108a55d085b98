"""End-to-end simulation driver (port of pic1dp_tpu/core/simulation.py).

Reference equivalent: program pic1dp (src/pic1dp.F90:20-126): initialize,
load, initial field solve, RK2 main loop with scheduled particle optimization
and interval-based output, finalize with a timer report.

The main loop is host-side Python.  Steps between events are queued on the
device back to back; the host waits for the device only at a snapshot, at
most once per `output_interval`, at a step with a scheduled optimization
(merge/remove/split), and at a checkpoint.

A snapshot's device half (Stepper.snapshot) writes everything its record
and the progress line need into one packed buffer (diagnostics.SnapshotLayout),
which the host copies once, into a new array each snapshot, so that what a
snapshot callback keeps stays valid.  On a CUDA device that chain is a CUDA
graph from the second snapshot on (Stepper.snapshot_graph); the first runs
it eagerly, and so do the CPU, the EXPLICIT path and a gloo group.

`self.timers` (utils/timers.PhaseTimers), which the Simulation hands to its
Stepper and its SnapshotWriter, holds the run's phases and counters: a
snapshot is the phase "output", split into "output: capture" (where a
snapshot graph is captured), "output: device" (the graph's replay or the
eager chain, ending in the one copy) and "output: write"; the counters
"snapshot graph replays", "snapshot graph captures" and "snapshot eager" say
how each snapshot ran, and "snapshot d2h copies" and "snapshot d2h bytes"
count its copy; the Stepper times its step graphs' captures ("step:
capture") and counts their replays and, on a mesh, counts the all_reduces
("all_reduces", "all_reduce bytes") and times the eager ones ("reduce").
`trace=True` turns tracing on: each multi_step call's steps are then the
phase "step", timed on a CUDA device by timing events and read at the run's
next synchronization (a snapshot, a checkpoint, the run's end), on the CPU
by the host clock; and under a recording torch.profiler every phase is a
"pic1dp.<phase>" span.  With tracing off there is no "step" phase.

`mesh` splits the particle axis over the processes of a torch.distributed
job, one device each (parallel/mesh.py): each rank loads the global state,
keeps its block and steps it with a ShardedStepper.  Only rank 0 writes
pic1dp.out and prints.  Checkpoints of a mesh of more than one rank (or any,
with force_sharded) are one file per process, `<path>.procK.npz`, with the
JAX package's keys: each particle array as `<field>@<offset>`, its global
offset along the particle axis, the field arrays whole.

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
from pic1dp_tpu_torch.core.diagnostics import Energies, SnapshotLayout
from pic1dp_tpu_torch.core.loading import PertbShape, load_particles
from pic1dp_tpu_torch.core.state import FIELDS, SimState, torch_dtype
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.io.writer import SnapshotWriter
from pic1dp_tpu_torch.utils.timers import PhaseTimers

_EPS = math.sqrt(np.finfo(np.float64).eps)  # PETSC_SQRT_MACHINE_EPSILON


# config fields that may differ between a checkpoint and the run resuming
# it: they affect neither the saved state nor its physics
_RUN_ONLY = {"time_max", "ntime_max", "output_interval", "verbosity", "deposit_method",
             "deposit_chunk", "diag_full_rho", "nx_opd", "nv_opd"}


class Simulation:
    def __init__(self, cfg: Config, pertb_shape: PertbShape | None = None,
                 out_path: str | None = None, emulate_ranks: int = 1,
                 checkpoint_interval: float | None = None,
                 checkpoint_path: str | None = None,
                 device: torch.device | str = "cuda", mesh=None, trace: bool = False):
        """`mesh`: None for one device; a parallel.mesh.Mesh, or its size
        (parallel.mesh.make_mesh on `device`; a CUDA device without an index
        becomes cuda:LOCAL_RANK), splits the particle axis over the job's
        processes (module docstring).  `trace`: the timers' tracing (module
        docstring)."""
        self.cfg = cfg.validate()
        self.device = torch.device(device)
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_path = checkpoint_path or "."
        self._last_checkpoint_time = 0.0
        self.timers = PhaseTimers(tracing=trace)
        self.mesh = None
        with self.timers.phase("initialize"):
            if mesh is not None:
                from pic1dp_tpu_torch.parallel import mesh as pmesh

                self.mesh = pmesh.make_mesh(mesh, self.device) if isinstance(mesh, int) \
                    else mesh
                self.device = self.mesh.device
                self.stepper = pmesh.ShardedStepper(cfg, self.mesh, timers=self.timers)
            else:
                self.stepper = Stepper(cfg, self.device, timers=self.timers)
        self._is_io_process = self.mesh is None or self.mesh.rank == 0
        self._has_output = out_path is not None
        self.pertb_shape = pertb_shape
        self.emulate_ranks = emulate_ranks
        self.writer = SnapshotWriter(cfg, out_path, timers=self.timers) \
            if out_path is not None and self._is_io_process else None
        self.snapshot_layout = SnapshotLayout(cfg, self.stepper.dtype,
                                              live_count=cfg.verbosity >= 3)
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
            if self.mesh is not None:
                from pic1dp_tpu_torch.parallel import mesh as pmesh

                # every rank loads the global markers, so the ranks hold the
                # single-device run's markers between them
                state = pmesh.shard_state(state, self.mesh)
                if self.mesh.size > 1:
                    self.generator.manual_seed(pmesh.rank_seed(self.cfg.rng.seed,
                                                               self.mesh.rank))
            state = self.stepper.initial_field(state)
            self._sync()
        self.state = state
        self.itime = 0
        self.time = 0.0
        return state

    def _sync(self) -> None:
        """Wait for the device; the timers then read their device phases."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timers.flush()

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
            # the reference's wtimer slots of a step's parts (push/optimize/
            # collect, src/pic1dp_global.F90:38-50)
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
                live, = self.stepper.reduce_sum(self.state.nparticles())
                n = int(torch.sum(live))
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
            # exact full-spectrum grid charge for the diagnostic stream
            # (reference writes the deposited rho, all modes); every rank
            # takes part in its all_reduce
            full_rho = self.cfg.diag_full_rho and self._has_output
            graph = self.stepper.snapshot_graph(self.state, self.snapshot_layout, full_rho)
            with self.timers.phase("output: device"):
                if graph is None:
                    self.timers.count("snapshot eager")
                    packed = self.stepper.snapshot(self.state, self.snapshot_layout, full_rho)
                else:
                    graph.replay()
                    packed = graph.out
                snap = self.snapshot_layout.unpack(self._to_host(packed))
            eng = snap.energies
            if self.writer is not None:
                self.writer.write_snapshot(self.time, eng, snap.mode_re, snap.mode_im,
                                           snap.electric, snap.rho, snap.ptcl)
        if self.cfg.verbosity >= 1:
            self._print_progress(eng, snap.mode_re, snap.mode_im, snap.nlive)
        if not np.isfinite(eng.field):
            raise FloatingPointError(
                f"non-finite field energy at t = {self.time:.4f} "
                f"(itime = {self.itime}); the run has diverged — reduce dt "
                "or check the configuration. Last checkpoint (if enabled) "
                f"is in {self.checkpoint_path!r}.")
        return {"time": self.time, "field_energy": float(eng.field),
                "marker": eng.marker, "total": eng.total, "pertb": eng.pertb,
                "mode_re": snap.mode_re, "mode_im": snap.mode_im}

    def _to_host(self, packed: torch.Tensor) -> np.ndarray:
        """A snapshot's packed buffer in a new host array: one device-to-host
        copy, counted with its bytes."""
        self.timers.count("snapshot d2h copies")
        self.timers.count("snapshot d2h bytes", packed.numel() * packed.element_size())
        return packed.detach().cpu().numpy()

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

    def phase_table(self, steps: int = 10) -> str:
        """Per-phase step decomposition (push / shape+gather / collect /
        field solve / the two substep kernels / the full step), measured on
        the current state with the two-point slope method
        (utils/phase_split.py) — the reference's wtimer granularity
        (src/pic1dp_output.F90:576-627) that whole-step timing cannot give.
        Run it after (or instead of) a run via `python -m
        pic1dp_tpu_torch.run --phase-table`."""
        from pic1dp_tpu_torch.config import ParticleShape
        from pic1dp_tpu_torch.utils.phase_split import (format_phase_table,
                                                        measure_phase_split)

        if self.state is None:
            self.load()
        if self.cfg.shape != ParticleShape.MATRIX_FREE:
            return ("Info: phase table requires the MATRIX_FREE shape "
                    "(the production hot path)")
        if self.mesh is not None and self.mesh.size > 1:
            # the timing loops run one rank's steps alone
            return ("Info: phase table is not supported under multi-process "
                    "runs (the timing loops fetch to one host); run it on a "
                    "single-process mesh")
        return format_phase_table(
            measure_phase_split(self.stepper, self.state, steps))

    # ---- checkpoint / resume (no reference equivalent: the reference
    # restarts from t = 0 on any failure) ----

    def save_checkpoint(self, path: str | None = None,
                        force_sharded: bool = False) -> str:
        """Write full restart state (particle arrays, field, time counters,
        RNG key and generator state, optimization-schedule cursors) as an
        .npz; atomic rename so a crash mid-write never corrupts the previous
        checkpoint.  The keys are the JAX package's (module docstring).

        Under a mesh of more than one rank, or with force_sharded, each
        process writes `<path>.procK.npz` holding its block of each particle
        array under `<field>@<offset>` and the field arrays whole; restore
        reads its own file back (the same mesh layout, or a finer one saved
        by the JAX package in one file).  Returns the path written."""
        assert self.state is not None, "nothing to checkpoint"
        if path is None:
            path = os.path.join(self.checkpoint_path, "checkpoint.npz")
        self._sync()

        def to_np(t):
            # npz cannot represent bfloat16; store p widened to f32 —
            # lossless — and restore re-narrows per cfg.p_dtype
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        if force_sharded or (self.mesh is not None and self.mesh.size > 1):
            rank = self.mesh.rank if self.mesh is not None else 0
            path = f"{path}.proc{rank}.npz"
            offset = rank * self.state.nparticle_max
            arrays = {(f"{f}@{offset}" if getattr(self.state, f).dim() == 2 else f):
                      to_np(getattr(self.state, f)) for f in FIELDS}
        else:
            arrays = {f: to_np(getattr(self.state, f)) for f in FIELDS}
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
        is impossible).  Per-process shard files are detected by their key
        layout; under a mesh, `path` may name the checkpoint its processes
        saved (each then reads `<path>.procK.npz`)."""
        if not os.path.exists(path) and self.mesh is not None:
            proc = f"{path}.proc{self.mesh.rank}.npz"
            if os.path.exists(proc):
                path = proc
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
                state = self._rebuild_sharded_state(ck, path)
            else:
                state = SimState.from_numpy({f: ck[f] for f in FIELDS}, self.device)
                if self.mesh is not None:
                    from pic1dp_tpu_torch.parallel import mesh as pmesh

                    state = pmesh.shard_state(state, self.mesh)
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
                seed = (self.cfg.rng.seed + 1) * 1_000_003 + self.itime
                if self.mesh is not None and self.mesh.size > 1:
                    from pic1dp_tpu_torch.parallel import mesh as pmesh

                    seed = pmesh.rank_seed(seed, self.mesh.rank)
                self.generator.manual_seed(seed)
        self._last_checkpoint_time = self.time

    def _rebuild_sharded_state(self, ck, path: str) -> SimState:
        """This rank's state from a per-process file: its block of each
        particle array from the `<field>@<offset>` pieces that cover it (one
        piece when the file was saved under this mesh layout, several when
        the JAX package saved a finer one), the field arrays as saved."""
        from pic1dp_tpu_torch.parallel import mesh as pmesh

        if self.mesh is None:
            raise ValueError(
                f"per-process (sharded) checkpoint {path} requires Simulation(mesh=...) "
                "with the same mesh layout it was saved under")
        start, stop = pmesh.local_block(self.cfg.nparticle_max, self.mesh)
        arrays = {}
        for f in FIELDS:
            pieces = sorted((int(k.split("@")[1]), k) for k in ck.files
                            if k.split("@")[0] == f and "@" in k)
            if not pieces:
                arrays[f] = ck[f]
                continue
            block, at = [], start
            for offset, key in pieces:
                piece = ck[key]
                if offset <= at < offset + piece.shape[1]:
                    take = piece[:, at - offset:min(stop, offset + piece.shape[1]) - offset]
                    block.append(take)
                    at += take.shape[1]
            if at != stop:
                raise ValueError(
                    f"checkpoint {path} does not hold particle slots [{at}, {stop}) of "
                    f"{f} for rank {self.mesh.rank} of {self.mesh.size}: restore under "
                    "the mesh layout it was saved with")
            arrays[f] = np.concatenate(block, axis=1)
        return SimState.from_numpy(arrays, self.device)

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
        # reference global_pp prints once from rank 0
        # (src/pic1dp_global.F90:71-90)
        if self._is_io_process:
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

