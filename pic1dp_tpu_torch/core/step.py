"""The RK2 time step: gather -> push -> deposit -> spectral solve (port of
pic1dp_tpu/core/step.py: `Stepper._step_pallas_body` for the matrix-free
spectral path, `_step_grid` for the EXPLICIT grid path, `make_multi_step` as
a CUDA graph, and `push_pair` / `collect_and_solve` for the steps at which
the markers are optimized).

Reference semantics (src/pic1dp.F90:78-109 main loop,
src/pic1dp_interaction.F90 push/deposit, src/pic1dp_field.F90 solve): per
step, two Runge-Kutta (midpoint) substeps.  Substep 1 integrates from the
step-start values with dt/2; substep 2 re-integrates from the same values
with the full dt using the midpoint fields and velocities
(src/pic1dp_interaction.F90:178-193), in the update order x, w, v
(:238-339).  Each substep is one fused call (ops/substep_kernels.py):
gather E, push, deposit the mode projections and solve the modes from them
(on CUDA in the kernel's last block), so a step is the two kernels and never
waits for the host.  E and rho on the grid are read by no substep: `advance`
forms them once, after the last of its steps (a graph's end, the end of a
multi_step call), from the last step's projections and modes; `step` is
advance(state, 1).
Linear runs freeze v and full-f runs leave w alone and deposit p, as the
reference does; every number of species and every equilibrium runs.

Under bf16_weights p is stored as bfloat16 and the substeps stream w1 as
bfloat16; x, v, w and the fields stay float32.

On a CUDA device `multi_step` replays k matrix-free steps from one CUDA
graph, the port's counterpart of the reference's k steps in one `lax.scan`.
The Stepper's `timers` (a Simulation hands it its own) time each capture
("step: capture", host clock) and count the replays ("graph replays"); with
tracing on, a multi_step call's steps, never a capture, are the device phase
"step" (utils/timers.py).

A snapshot's device half (`snapshot`: energies, ptcldist, full_rho where it
runs, the live counts) writes one packed buffer (diagnostics.SnapshotLayout).
On a CUDA device its energies and ptcldist come from one pass over each
species' markers (diagnostics.marker_pass), counted as "snapshot marker
passes", and `snapshot_graph` holds the whole as a CUDA graph over the
state's buffers, captured at the second snapshot (the first runs eagerly)
and replayed at every later one; a replay is the eager chain's bits.

A Stepper given a torch.distributed process group (`group`, set by
parallel/mesh.ShardedStepper) steps one rank's block of the particle axis:
every sum over markers ends in an all_reduce over the group (`reduce_sum`),
where the JAX Stepper has its psums: the (2, nmode) projections of each
substep and of the initial field, the EXPLICIT grid deposit, and in the
diagnostics and particle optimization.  A rank's projections are partial
sums, so there the kernels solve no modes: `_solve` runs after each
all_reduce, on the same factor g and with the same products.  The timers
count each all_reduce and its bytes ("all_reduces", "all_reduce bytes"),
those captured in a CUDA graph at the graph's replays, and time each eager
one as the host phase "reduce".  Without a group nothing else changes.

Nonlinear delta-f has two kernel layouts (ops/substep_kernels.py): substep 1
streams the midpoint velocities v1 and weights w1 to substep 2, or substep 2
rebuilds both from E at x0 of the step-start modes (the recompute layout:
four fewer streams per marker, one more gather of E).  Both give the same
bits.  Each substep 2 that rebuilds w1 is counted as "w1 rebuilds", each
substep of the grid bin (more than 4 kept modes:
FusedSubsteps.uses_grid_bin), both of every step and of push_pair, as
"grid-bin substeps", those of them that deposit in the grid bin's lane form
(each lane on a charge copy of its own: FusedSubsteps.uses_grid_lanes) as
"grid-bin lane deposits", and each of the species loop (one species a block:
FusedSubsteps.uses_species_loop) as "species-loop substeps"; one captured
in a CUDA graph at each replay.
substep_kernels.layout takes the one measured faster on the H100 for the
config's kernel (PERF.md);
PIC1DP_STREAM_V1=1 or 0 overrides it (stream or rebuild), read once, when
the Stepper is made, as the JAX Stepper reads it
(pic1dp_tpu/core/step.py:122-128).

The EXPLICIT grid path (cfg.shape = EXPLICIT) is the stored-shape
cross-check: it assembles the hat-shape matrix at each substep position,
gathers E from the grid, deposits charge on the grid and solves there
(ops/gather.py, ops/deposit.py, SpectralOperator.solve).  On CUDA the
deposit is the GRID_CHARGE kernel (ops/hist_kernels.py), which has no float
atomic, so two runs of the path give the same bits.  Its steps return new
tensors, and `multi_step` runs them as eager steps on every device, never
from a CUDA graph: a graph needs fixed buffers.  Whether the path should
now be captured is an open question (ROADMAP.md section 2).  Every DepositMethod selects this one deposit and one
gather; deposit_chunk is ignored.
"""

from __future__ import annotations

import gc
import os
import warnings

import torch
import torch.distributed as torch_dist

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, ParticleShape
from pic1dp_tpu_torch.core import diagnostics
from pic1dp_tpu_torch.core import optimize as opt_mod
from pic1dp_tpu_torch.core.state import SimState, torch_dtype
from pic1dp_tpu_torch.ops import hist_kernels
from pic1dp_tpu_torch.ops import spectral as spectral_ops
from pic1dp_tpu_torch.ops import substep_kernels
from pic1dp_tpu_torch.ops.deposit import deposit
from pic1dp_tpu_torch.ops.gather import gather
from pic1dp_tpu_torch.ops.interp import wrap_x
from pic1dp_tpu_torch.ops.spectral import SpectralOperator
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps
from pic1dp_tpu_torch.utils.timers import PhaseTimers


class Stepper:
    """Step functions for a fixed Config on one device.

    On a CUDA device the matrix-free substeps launch the hand-written
    kernels; on the CPU they run the kernels' plain PyTorch versions.
    `plain=True` runs the plain versions on any device (the reference a CUDA
    run is held against).  A matrix-free step (and push_pair) updates the
    state's x, v and w in place; an EXPLICIT step returns new tensors.
    `group`: the process group a rank's sums are all-reduced over (module
    docstring); None for one device.  `timers`: where the steps, captures
    and replays are timed and counted (module docstring); a new
    PhaseTimers by default.
    """

    # steps per CUDA graph at most; a longer multi_step replays several
    GRAPH_STEPS = 128

    def __init__(self, cfg: Config, device: torch.device | str, plain: bool = False,
                 group=None, timers: PhaseTimers | None = None):
        cfg.validate()
        if cfg.bf16_weights and cfg.nspecies > 1 and any(
                abs(s.v0) > 2.0 * (s.temperature / s.mass) ** 0.5
                for s in cfg.species):
            # measured limitation of the reference (pic1dp_tpu/core/step.py
            # :104-121, docs/performance.md round 5), kept word for word
            warnings.warn(
                "bf16_weights with multiple strongly shifted species "
                "(|v0| > 2 vth) has a measured post-saturation divergence "
                "(bf16 w1-stream rounding amplifies the vortex-merging "
                "transient; docs/performance.md round 5). Use f32, the "
                "equivalent single-species composite equilibrium, or stop "
                "before deep saturation.", RuntimeWarning, stacklevel=3)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.explicit = cfg.shape == ParticleShape.EXPLICIT
        self.spectral = SpectralOperator.create(cfg.nx, cfg.modes, cfg.lx,
                                                self.dtype, self.device)
        self.sp = dist.SpeciesParams.from_config(cfg, self.dtype, self.device)
        # nonlinear delta-f with PIC1DP_STREAM_V1 set: stream the midpoint
        # velocities v1 between the substeps ("1") or rebuild them ("0");
        # otherwise the config's layout
        env = os.environ.get("PIC1DP_STREAM_V1", "") if cfg.deltaf and not cfg.linear else ""
        self.substeps = FusedSubsteps(cfg, self.sp,
                                      stream_v1=bool(int(env)) if env else None)
        self.stream_v1 = self.substeps.layout == substep_kernels.NONLINEAR
        if plain:
            self._substep1 = self.substeps.substep1_plain
            self._substep2 = self.substeps.substep2_plain
        else:
            self._substep1 = self.substeps.substep1
            self._substep2 = self.substeps.substep2
        self._graphs: dict[int, _StepGraph] = {}
        self._graph_buffers = None   # the state the graphs were captured over
        self._warm = False
        self._snapshot_graph = self._snapshot_key = None
        self._snapshot_warm: set[tuple[bool, bool]] = set()   # snapshot's eager runs
        self.group = group
        self.timers = timers if timers is not None else PhaseTimers()
        # the substeps solve their own projections' modes unless those are
        # a rank's partial sums
        self.kernel_solves = group is None
        # a gloo collective cannot be captured in a CUDA graph; NCCL's can
        self._graphs_capture = group is None or torch_dist.get_backend(group) == "nccl"

    def reduce_sum(self, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The tensors (of one dtype) summed over the ranks of the group, in
        one all_reduce of them laid end to end (the reference's
        MPI_Allreduce); the tensors themselves without a group.  Each
        all_reduce is counted ("all_reduces", "all_reduce bytes"; one
        captured in a graph at each of the graph's replays) and, where it
        runs eagerly, timed as the host phase "reduce"."""
        if self.group is None:
            return tensors
        buf = torch.cat([t.reshape(-1) for t in tensors])
        self.timers.count("all_reduces")
        self.timers.count("all_reduce bytes", buf.numel() * buf.element_size())
        if buf.is_cuda and torch.cuda.is_current_stream_capturing():
            torch_dist.all_reduce(buf, group=self.group)
        else:
            with self.timers.phase("reduce"):
                torch_dist.all_reduce(buf, group=self.group)
        return tuple(part.view(t.shape) for part, t in
                     zip(buf.split([t.numel() for t in tensors]), tensors))

    def _solve(self, p_c, p_s):
        """The modes of all-reduced projections, with the substeps' factor g
        (FusedSubsteps.g = grad_inv / lx), as their kernels solve them."""
        return spectral_ops.solve_modes(p_c, p_s, self.substeps.g)

    def _with_field(self, state: SimState, proj, modes) -> SimState:
        """state's markers with the field of the (all-reduced) projections
        and their modes: rho and E on the grid."""
        (p_c, p_s), (mode_re, mode_im) = proj, modes
        return SimState(
            x=state.x, v=state.v, p=state.p, w=state.w, live=state.live,
            rho=self.spectral.rho_grid_from_projections(p_c, p_s, self.cfg.lx),
            electric=self.spectral.e_grid(mode_re, mode_im),
            mode_re=mode_re, mode_im=mode_im)

    def _solved_substep1(self, state: SimState, mode_re, mode_im):
        """Substep 1 from the step-start modes: (w1, v1, projections, modes),
        the projections all-reduced over the group and solved (by the
        kernel without a group); counted as _count_bins counts it."""
        self._count_bins(1)
        w1, v1, proj, *modes = self._substep1(state.x, state.v, state.p, state.w, mode_re,
                                              mode_im, solve=self.kernel_solves)
        if self.kernel_solves:
            return w1, v1, proj, modes[0]
        proj = self.reduce_sum(*proj)
        return w1, v1, proj, self._solve(*proj)

    def _solved_substep2(self, state: SimState, w1, v1, modes1, mode_re0, mode_im0):
        """Substep 2 (x, v and w updated in place): (projections, modes) as
        _solved_substep1's."""
        _, _, _, proj, *modes = self._counted_substep2(state, w1, v1, modes1, mode_re0,
                                                       mode_im0, solve=self.kernel_solves)
        if self.kernel_solves:
            return proj, modes[0]
        proj = self.reduce_sum(*proj)
        return proj, self._solve(*proj)

    def _counted_substep2(self, state: SimState, w1, v1, modes1, mode_re0, mode_im0,
                          solve: bool = False):
        """The substep 2 call on the state's markers (x, v and w updated in
        place), counted as a "w1 rebuilds" where the layout rebuilds w1 and
        as _count_bins counts it (in a CUDA graph at each replay)."""
        if self.substeps.rebuilds_w1:
            self.timers.count("w1 rebuilds")
        self._count_bins(2)
        return self._substep2(state.x, state.v, state.p, state.w, w1, v1, *modes1, mode_re0,
                              mode_im0, solve=solve)

    def _count_bins(self, substep: int) -> None:
        """Count a call of substep `substep` as "grid-bin substeps" where the
        substeps run the grid bin, as "grid-bin lane deposits" where it
        runs in the lane form, and as "species-loop substeps" where they run
        the species loop."""
        if self.substeps.uses_grid_bin():
            self.timers.count("grid-bin substeps")
        if self.substeps.uses_grid_lanes(substep):
            self.timers.count("grid-bin lane deposits")
        if self.substeps.uses_species_loop():
            self.timers.count("species-loop substeps")

    # ---- grid-space pieces ----

    def deposit_charge(self, x, p, w, live) -> torch.Tensor:
        """Charge density on the grid, every spatial mode (reference
        interaction_collect_charge, src/pic1dp_interaction.F90:33-155)."""
        cfg = self.cfg
        val = w if cfg.deltaf else p.to(self.dtype)
        val = torch.where(live, val, 0.0) * self.sp.charge
        grid, = self.reduce_sum(deposit(x, val, cfg.lx, cfg.nx))
        rho = grid * (cfg.nx / cfg.lx)
        if not cfg.deltaf:
            # subtract equilibrium charge density (reference :142-148)
            rho = rho - torch.sum(self.sp.charge * self.sp.density)
        return rho

    def full_rho(self, state: SimState) -> torch.Tensor:
        """The full-spectrum grid charge of a state (the diag_full_rho
        stream); the state's own rho holds the kept modes only on the
        matrix-free path."""
        return self.deposit_charge(state.x, state.p, state.w, state.live)

    def solve_field(self, rho):
        return self.spectral.solve(rho)

    def _gather(self, x, electric):
        """E at particle positions (reference MatMult(S, E),
        src/pic1dp_interaction.F90:213-220)."""
        return gather(x, electric, self.cfg.lx, self.cfg.nx)

    def _push(self, x, v, p, w, x_bak, v_bak, w_bak, electric, dt_eff):
        """One RK substep particle push: grid-path gather composed with the
        update body (_push_math holds the load-bearing ordering)."""
        e_p = self._gather(x, electric)
        return self._push_math(e_p, x, v, p, w, x_bak, v_bak, w_bak, dt_eff)

    def _push_math(self, e_p, x, v, p, w, x_bak, v_bak, w_bak, dt_eff):
        """The push update given the gathered field, in the reference's
        order x, w, v (src/pic1dp_interaction.F90:238-339)."""
        cfg, sp = self.cfg, self.sp
        q_over_m = sp.charge / sp.mass
        x_new = wrap_x(x_bak + dt_eff * v, cfg.lx)
        if cfg.deltaf:
            p = p.to(self.dtype)
            drive = (p * e_p) if cfg.linear else ((p - w) * e_p)
            kern = dist.minus_dlnf0_dv(cfg.equilibrium, sp, v)
            w_new = w_bak + dt_eff * drive * kern * q_over_m
        else:
            w_new = w
        v_new = v if cfg.linear else v_bak + dt_eff * e_p * q_over_m
        return x_new, v_new, w_new

    def _grid_pushes(self, state: SimState):
        """Both pushes of a grid-path step and the midpoint field between
        them: (x2, v2, w2, rho1, e1)."""
        dt = self.cfg.dt
        x0, v0, w0, p, live = state.x, state.v, state.w, state.p, state.live
        # substep 1: half step from (x0, v0, w0)
        x1, v1, w1 = self._push(x0, v0, p, w0, x0, v0, w0, state.electric, 0.5 * dt)
        rho1 = self.deposit_charge(x1, p, w1, live)
        e1, _, _ = self.solve_field(rho1)
        # substep 2: full step from the same backups, midpoint quantities
        x2, v2, w2 = self._push(x1, v1, p, w1, x0, v0, w0, e1, dt)
        return x2, v2, w2, rho1, e1

    def _step_grid(self, state: SimState) -> SimState:
        """Grid-histogram RK2 step (explicit-shape analogue, cross-check
        path for iptclshape 1-3, reference src/pic1dp_particle.F90:275-350)."""
        x2, v2, w2, _, _ = self._grid_pushes(state)
        rho2 = self.deposit_charge(x2, state.p, w2, state.live)
        e2, mre, mim = self.solve_field(rho2)
        return SimState(x=x2, v=v2, p=state.p, w=w2, live=state.live,
                        rho=rho2, electric=e2, mode_re=mre, mode_im=mim)

    # ---- entry points ----

    def initial_field(self, state: SimState) -> SimState:
        """Deposit + solve for the freshly loaded state
        (reference src/pic1dp.F90:70-72)."""
        cfg = self.cfg
        if self.explicit:
            rho = self.deposit_charge(state.x, state.p, state.w, state.live)
            electric, mre, mim = self.solve_field(rho)
            return SimState(x=state.x, v=state.v, p=state.p, w=state.w, live=state.live,
                            rho=rho, electric=electric, mode_re=mre, mode_im=mim)
        trig = spectral_ops.mode_trig(state.x, cfg.lx, cfg.nx, cfg.modes)
        val = state.w if cfg.deltaf else state.p.to(self.dtype)
        val = torch.where(state.live, val, 0.0) * self.sp.charge
        proj = self.reduce_sum(*spectral_ops.project_modes(trig, val))
        return self._with_field(state, proj, self._solve(*proj))

    def step(self, state: SimState) -> SimState:
        """One full RK2 step; on the matrix-free path x, v and w are updated
        in place."""
        return self.advance(state, 1)

    def advance(self, state: SimState, k: int) -> SimState:
        """k full RK2 steps.  On the matrix-free path x, v and w are updated
        in place, each step's modes carried to the next, and rho and E on
        the grid formed once, after the last step (no substep reads them):
        bit for bit the state of k calls of `step`.  What multi_step runs
        and what a CUDA graph holds.  k = 0 returns state."""
        if self.explicit:
            for _ in range(k):
                state = self._step_grid(state)
            return state
        if k < 1:
            return state
        modes = (state.mode_re, state.mode_im)
        for _ in range(k):
            w1, v1, _, modes1 = self._solved_substep1(state, *modes)
            proj, modes = self._solved_substep2(state, w1, v1, modes1, *modes)
        return self._with_field(state, proj, modes)

    def push_pair(self, state: SimState) -> SimState:
        """Both RK substeps' pushes WITHOUT the final deposit/solve; used by
        the optimization path, which runs merge/remove/split after the second
        push and before the final charge collection (reference
        src/pic1dp.F90:79-90 with particle_optimize acting on irk == 2).

        Returns the state after substep 2's push with rho and E of the
        midpoint solve and the step-start modes.  On the matrix-free path
        these are the step's own two substep calls (on CUDA the two kernels):
        x, v and w are updated in place, so `state` and the result share
        them, and the projections that substep 2 deposits at the pushed
        positions are dropped — collect_and_solve deposits again once the
        markers have been optimized."""
        if self.explicit:
            x2, v2, w2, rho1, e1 = self._grid_pushes(state)
        else:
            w1, v1, (pc1, ps1), (mre1, mim1) = self._solved_substep1(
                state, state.mode_re, state.mode_im)
            x2, v2, w2, _ = self._counted_substep2(state, w1, v1, (mre1, mim1),
                                                   state.mode_re, state.mode_im)
            rho1 = self.spectral.rho_grid_from_projections(pc1, ps1, self.cfg.lx)
            e1 = self.spectral.e_grid(mre1, mim1)
        return SimState(x=x2, v=v2, p=state.p, w=w2, live=state.live, rho=rho1,
                        electric=e1, mode_re=state.mode_re, mode_im=state.mode_im)

    def collect_and_solve(self, state: SimState) -> SimState:
        """Final deposit + solve after optimization."""
        return self.initial_field(state)

    def apply_optimizations(self, state: SimState, generator: torch.Generator,
                            merge=None, remove=None, split=None) -> SimState:
        """merge/remove/split at the given thresholds (None: not due), the
        dice and normals drawn from `generator` on the state's device.  The
        result holds new x, v, p, w and live tensors."""
        dice, normals = opt_mod.draw_randoms(self.cfg, state, generator,
                                             remove=remove is not None,
                                             split=split is not None)
        return opt_mod.apply_optimizations(self.cfg, state, dice, normals, merge=merge,
                                           remove=remove, split=split, reduce=self.reduce_sum)

    def multi_step(self, state: SimState, k: int) -> SimState:
        """k steps, queued without a host sync.  On the CPU, on the
        EXPLICIT path and with a gloo group a loop of steps; matrix-free on a
        CUDA device the steps of graph_steps, after a first call of eager
        steps that loads every kernel the graphs will hold (and, with an
        NCCL group, has made the communicator a capture needs)."""
        if (self.explicit or state.x.device.type != "cuda" or not self._warm
                or not self._graphs_capture):
            with self.timers.device_phase("step", state.x.device, k):
                state = self.advance(state, k)
            self._warm = state.x.device.type == "cuda" and not self.explicit
            return state
        return self.graph_steps(state, k)

    def graph_steps(self, state: SimState, k: int) -> SimState:
        """k steps replayed from CUDA graphs of at most GRAPH_STEPS steps,
        each captured once per step count over this state's buffers (the
        port of make_multi_step, pic1dp_tpu/core/step.py:433-502).  A replay
        is bit for bit the same k eager steps: a graph holds `advance` of its
        steps, the same kernels on the same buffers, with no float atomics.
        x, v and w are updated in place, and each graph ends by forming E
        and rho once and copying them and the new modes into the state's
        own tensors, so the state returned is `state` itself.  Graphs
        captured over another state's buffers are dropped, never replayed
        over this one.  Missing graphs are captured before the replays
        start, outside the device phase "step" that times them."""
        if state.x.device.type != "cuda":
            raise ValueError(f"CUDA graphs replay on a CUDA state, not {state.x.device}")
        if self.explicit:
            raise ValueError("the EXPLICIT grid path runs eager steps, not CUDA graphs")
        if not self._graphs_capture:
            raise ValueError("a gloo group's all_reduce cannot be captured in a CUDA graph")
        # A graph holds addresses, not data: a replay reads and writes
        # whatever lies at the captured addresses now.  Particle optimization
        # hands back new tensors; if the allocator gives them other addresses
        # the comparison below drops the graphs, and if it re-uses every
        # captured address (same shapes and dtypes, contiguous as
        # apply_optimizations returns them) the graphs are valid for the new
        # state as they stand, since they then address exactly its tensors.
        # The graphs' own temporaries (w1 and v1 where the layout streams
        # them, the partial sums) live in their private pool, which no other
        # allocation can take.
        buffers = _addresses(state, ("x", "v", "p", "w", "mode_re", "mode_im", "electric",
                                     "rho"))
        if buffers != self._graph_buffers:
            self._graphs, self._graph_buffers = {}, buffers
        full, rest = divmod(k, self.GRAPH_STEPS)
        graphs = []
        for n in [self.GRAPH_STEPS] * full + [rest] * (rest > 0):
            if n not in self._graphs:
                with self.timers.phase("step: capture"):
                    self._graphs[n] = _StepGraph(self, state, n)
            graphs.append(self._graphs[n])
        with self.timers.device_phase("step", state.x.device, k):
            for graph in graphs:
                graph.replay()
        return state

    def energies(self, state: SimState) -> diagnostics.Energies:
        return diagnostics.energies(self.cfg, self.sp, state, reduce=self.reduce_sum)

    def ptcldist(self, state: SimState) -> diagnostics.PtclDist:
        return diagnostics.ptcldist(self.cfg, self.sp, state, reduce=self.reduce_sum)

    def snapshot(self, state: SimState, layout: diagnostics.SnapshotLayout,
                 full_rho: bool = False) -> torch.Tensor:
        """A snapshot's device half, packed by `layout` into one new tensor:
        energies, ptcldist (on CUDA from one marker pass a species, each
        counted), the modes, E and rho (full_rho's where `full_rho`) and,
        where the layout holds them, the live counts, all reduced over the
        group.  What a snapshot graph holds; the state is only read."""
        if state.x.device.type == "cuda":
            eng, ptcl = diagnostics.marker_pass(self.cfg, self.sp, state, self.reduce_sum)
            self.timers.count("snapshot marker passes", self.cfg.nspecies)
        else:
            eng, ptcl = self.energies(state), self.ptcldist(state)
        rho = self.full_rho(state) if full_rho else state.rho
        nlive = self.reduce_sum(state.nparticles())[0] if layout.live_count else None
        if state.x.device.type == "cuda":
            self._snapshot_warm.add((full_rho, layout.live_count))
        return layout.pack(diagnostics.Snapshot(eng, state.mode_re, state.mode_im,
                                                state.electric, rho, ptcl, nlive))

    def snapshot_graph(self, state: SimState, layout: diagnostics.SnapshotLayout,
                       full_rho: bool = False) -> "_SnapshotGraph | None":
        """The CUDA graph of `snapshot` over this state's buffers, or None
        where the snapshot runs eagerly: on the CPU, on the EXPLICIT path
        (its steps hand back new tensors, so the buffers move every
        interval), with a gloo group (its all_reduce cannot be captured), and
        until `snapshot` has run eagerly on this Stepper with these
        arguments (that configures the hist kernels outside any capture and,
        with an NCCL group, has made the communicator).  A missing graph is
        captured here, as the phase "output: capture" (counted as "snapshot
        graph captures"); one captured over other buffers is dropped first,
        as graph_steps drops its graphs, never replayed over this state."""
        if (self.explicit or state.x.device.type != "cuda" or not self._graphs_capture
                or (full_rho, layout.live_count) not in self._snapshot_warm):
            return None
        key = (full_rho, layout.live_count,
               _addresses(state, ("x", "v", "p", "w", "live", "mode_re", "mode_im",
                                  "electric", "rho")))
        if key != self._snapshot_key:
            self._snapshot_graph = self._snapshot_key = None
            with self.timers.phase("output: capture"):
                self._snapshot_graph = _SnapshotGraph(self, state, layout, full_rho)
                self.timers.count("snapshot graph captures")
            self._snapshot_key = key
        return self._snapshot_graph


def _addresses(state: SimState, fields) -> tuple:
    """Address, shape and dtype of each of the state's tensors `fields`:
    what a CUDA graph captured over them reads and writes."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in (getattr(state, f) for f in fields))


class CountedGraph:
    """fn() captured in a CUDA graph.  The substep and hist kernel wrappers
    count their launches while fn is captured, when nothing runs, and so
    does `timers` what fn counts there (Stepper.reduce_sum's all_reduces);
    those counts are taken back at once and added again at each replay,
    when the work does run.  fn must have run eagerly once before (that
    loads every kernel the graph will hold).  `timers`, if given, also
    counts the replays under `counter`.  fn itself is not kept."""

    KERNELS = substep_kernels.KERNELS + hist_kernels.KERNELS

    def __init__(self, fn, timers: PhaseTimers | None = None,
                 counter: str = "graph replays"):
        self.timers, self.counter = timers, counter
        before = [k.launches for k in self.KERNELS]
        counts = timers.counters() if timers is not None else {}
        self.graph = torch.cuda.CUDAGraph()
        # a graph destroyed during a capture invalidates the capture, and
        # the cyclic collector may free another run's graphs at any moment
        # (a caller's reference cycle did so on four cards): it is held off
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                fn()
        finally:
            if collecting:
                gc.enable()
        self.launches = [k.launches - b for k, b in zip(self.KERNELS, before)]
        for k, b in zip(self.KERNELS, before):
            k.launches = b
        self.counts = timers.take_back(counts) if timers is not None else {}

    def replay(self) -> None:
        self.graph.replay()
        for k, d in zip(self.KERNELS, self.launches):
            k.launches += d
        if self.timers is not None:
            for name, n in self.counts.items():
                self.timers.count(name, n)
            self.timers.count(self.counter)


class _StepGraph(CountedGraph):
    """n steps of a Stepper over one state's buffers (Stepper.advance); the
    graph ends by copying the new modes, E and rho into the state's own
    tensors."""

    def __init__(self, stepper: Stepper, state: SimState, n: int):
        def steps():
            out = stepper.advance(state, n)
            for field in ("mode_re", "mode_im", "electric", "rho"):
                getattr(state, field).copy_(getattr(out, field))

        super().__init__(steps, stepper.timers)


class _SnapshotGraph(CountedGraph):
    """Stepper.snapshot over one state's buffers; each replay writes the
    packed buffer `out`, which lives in the graph's pool (counted as
    "snapshot graph replays")."""

    def __init__(self, stepper: Stepper, state: SimState,
                 layout: diagnostics.SnapshotLayout, full_rho: bool):
        out = []
        super().__init__(lambda: out.append(stepper.snapshot(state, layout, full_rho)),
                         stepper.timers, "snapshot graph replays")
        self.out, = out
