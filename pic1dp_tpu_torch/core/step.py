"""The RK2 time step of the matrix-free spectral path (port of
pic1dp_tpu/core/step.py, `Stepper._step_pallas_body`, and of
`make_multi_step` as a CUDA graph).

Reference semantics (src/pic1dp.F90:78-109 main loop,
src/pic1dp_interaction.F90 push/deposit, src/pic1dp_field.F90 solve): per
step, two Runge-Kutta (midpoint) substeps.  Substep 1 integrates from the
step-start values with dt/2; substep 2 re-integrates from the same values
with the full dt using the midpoint fields and velocities
(src/pic1dp_interaction.F90:178-193), in the update order x, w, v
(:238-339).  Each substep is one fused call (ops/substep_kernels.py):
gather E, push, and deposit the mode projections; between them the mode
solve is two multiplies on the device, so a step never waits for the host.
Linear runs freeze v and full-f runs leave w alone and deposit p, as the
reference does; every number of species and every equilibrium runs.

Under bf16_weights p is stored as bfloat16 and the substeps stream w1 as
bfloat16; x, v, w and the fields stay float32.

On a CUDA device `multi_step` replays k steps from one CUDA graph, the
port's counterpart of the reference's k steps in one `lax.scan`.

Not ported yet: the EXPLICIT grid path, and push_pair with the particle
optimization it serves.
"""

from __future__ import annotations

import warnings

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, ParticleShape
from pic1dp_tpu_torch.core import diagnostics
from pic1dp_tpu_torch.core.state import SimState, torch_dtype
from pic1dp_tpu_torch.ops import spectral as spectral_ops
from pic1dp_tpu_torch.ops import substep_kernels
from pic1dp_tpu_torch.ops.spectral import SpectralOperator
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps


class Stepper:
    """Step functions for a fixed Config on one device.

    On a CUDA device the substeps launch the hand-written kernels; on the
    CPU they run the kernels' plain PyTorch versions.  `plain=True` runs the
    plain versions on any device (the reference a CUDA run is held against).
    A step updates the state's x, v and w in place.
    """

    # steps per CUDA graph at most; a longer multi_step replays several
    GRAPH_STEPS = 128

    def __init__(self, cfg: Config, device: torch.device | str, plain: bool = False):
        cfg.validate()
        if cfg.shape != ParticleShape.MATRIX_FREE:
            raise NotImplementedError(
                "not ported to pic1dp_tpu_torch yet: the EXPLICIT grid path")
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
        self.spectral = SpectralOperator.create(cfg.nx, cfg.modes, cfg.lx,
                                                self.dtype, self.device)
        self.sp = dist.SpeciesParams.from_config(cfg, self.dtype, self.device)
        self.substeps = FusedSubsteps(cfg, self.sp)
        if plain:
            self._substep1 = self.substeps.substep1_plain
            self._substep2 = self.substeps.substep2_plain
        else:
            self._substep1 = self.substeps.substep1
            self._substep2 = self.substeps.substep2
        self._graphs: dict[int, _StepGraph] = {}
        self._graph_buffers = None   # the state the graphs were captured over
        self._warm = False

    def _solve(self, p_c, p_s):
        return spectral_ops.solve_modes_from_projections(
            p_c, p_s, self.spectral.grad_inv, self.cfg.lx)

    def _with_field(self, state: SimState, x, v, w, p_c, p_s) -> SimState:
        mode_re, mode_im = self._solve(p_c, p_s)
        return SimState(
            x=x, v=v, p=state.p, w=w, live=state.live,
            rho=self.spectral.rho_grid_from_projections(p_c, p_s, self.cfg.lx),
            electric=self.spectral.e_grid(mode_re, mode_im),
            mode_re=mode_re, mode_im=mode_im)

    def initial_field(self, state: SimState) -> SimState:
        """Deposit + solve for the freshly loaded state
        (reference src/pic1dp.F90:70-72)."""
        cfg = self.cfg
        trig = spectral_ops.mode_trig(state.x, cfg.lx, cfg.nx, cfg.modes)
        val = state.w if cfg.deltaf else state.p.to(self.dtype)
        val = torch.where(state.live, val, 0.0) * self.sp.charge
        p_c, p_s = spectral_ops.project_modes(trig, val)
        return self._with_field(state, state.x, state.v, state.w, p_c, p_s)

    def step(self, state: SimState) -> SimState:
        """One full RK2 step; x, v and w are updated in place."""
        w1, v1, (pc1, ps1) = self._substep1(
            state.x, state.v, state.p, state.w, state.mode_re, state.mode_im)
        mre1, mim1 = self._solve(pc1, ps1)
        x2, v2, w2, (pc2, ps2) = self._substep2(
            state.x, state.v, state.p, state.w, w1, v1, mre1, mim1,
            state.mode_re, state.mode_im)
        return self._with_field(state, x2, v2, w2, pc2, ps2)

    def multi_step(self, state: SimState, k: int) -> SimState:
        """k steps, queued without a host sync.  On the CPU a loop of steps;
        on a CUDA device the steps of graph_steps, after a first call of
        eager steps that loads every kernel the graphs will hold."""
        if state.x.device.type != "cuda" or not self._warm:
            for _ in range(k):
                state = self.step(state)
            self._warm = state.x.device.type == "cuda"
            return state
        return self.graph_steps(state, k)

    def graph_steps(self, state: SimState, k: int) -> SimState:
        """k steps replayed from CUDA graphs of at most GRAPH_STEPS steps,
        each captured once per step count over this state's buffers (the
        port of make_multi_step, pic1dp_tpu/core/step.py:433-502).  A replay
        is bit for bit the same k eager steps: the same kernels on the same
        buffers, with no float atomics.  x, v and w are updated in place, and
        each graph ends by copying the new modes, E and rho into the state's
        own tensors, so the state returned is `state` itself.  Graphs
        captured over another state's buffers are dropped, never replayed
        over this one."""
        if state.x.device.type != "cuda":
            raise ValueError(f"CUDA graphs replay on a CUDA state, not {state.x.device}")
        buffers = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in (
            state.x, state.v, state.p, state.w, state.mode_re, state.mode_im,
            state.electric, state.rho))
        if buffers != self._graph_buffers:
            self._graphs, self._graph_buffers = {}, buffers
        full, rest = divmod(k, self.GRAPH_STEPS)
        for n in [self.GRAPH_STEPS] * full + [rest] * (rest > 0):
            if n not in self._graphs:
                self._graphs[n] = _StepGraph(self, state, n)
            self._graphs[n].replay()
        return state

    def energies(self, state: SimState) -> diagnostics.Energies:
        return diagnostics.energies(self.cfg, self.sp, state)

    def ptcldist(self, state: SimState) -> diagnostics.PtclDist:
        return diagnostics.ptcldist(self.cfg, self.sp, state)


class _StepGraph:
    """n steps of a Stepper over one state's buffers, captured in a CUDA
    graph.  The wrappers count their launches while the steps are captured,
    when nothing runs; those counts are taken back at once and added again
    at each replay, when the kernels do run."""

    def __init__(self, stepper: Stepper, state: SimState, n: int):
        kernels = substep_kernels.KERNELS
        before = [k.launches for k in kernels]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = state
            for _ in range(n):
                out = stepper.step(out)
            for field in ("mode_re", "mode_im", "electric", "rho"):
                getattr(state, field).copy_(getattr(out, field))
        self.launches = [k.launches - b for k, b in zip(kernels, before)]
        for k, b in zip(kernels, before):
            k.launches = b

    def replay(self) -> None:
        self.graph.replay()
        for k, d in zip(substep_kernels.KERNELS, self.launches):
            k.launches += d
