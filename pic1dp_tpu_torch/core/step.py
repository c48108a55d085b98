"""The RK2 time step of the matrix-free spectral path (port of
pic1dp_tpu/core/step.py, `Stepper._step_pallas_body`).

Reference semantics (src/pic1dp.F90:78-109 main loop,
src/pic1dp_interaction.F90 push/deposit, src/pic1dp_field.F90 solve): per
step, two Runge-Kutta (midpoint) substeps.  Substep 1 integrates from the
step-start values with dt/2; substep 2 re-integrates from the same values
with the full dt using the midpoint fields and velocities
(src/pic1dp_interaction.F90:178-193), in the update order x, w, v
(:238-339).  Each substep is one fused call (ops/substep_kernels.py):
gather E, push, and deposit the mode projections; between them the mode
solve is two multiplies on the device, so a step never waits for the host.

Under bf16_weights p is stored as bfloat16 and the substeps stream w1 as
bfloat16; x, v, w and the fields stay float32.

Not ported yet: the EXPLICIT grid path, linear and full-f runs, and
push_pair with the particle optimization it serves.
"""

from __future__ import annotations

import warnings

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, ParticleShape
from pic1dp_tpu_torch.core import diagnostics
from pic1dp_tpu_torch.core.state import SimState, torch_dtype
from pic1dp_tpu_torch.ops import spectral as spectral_ops
from pic1dp_tpu_torch.ops.spectral import SpectralOperator
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps


class Stepper:
    """Step functions for a fixed Config on one device.

    On a CUDA device the substeps launch the hand-written kernels; on the
    CPU they run the kernels' plain PyTorch versions.  `plain=True` runs the
    plain versions on any device (the reference a CUDA run is held against).
    A step updates the state's x, v and w in place.
    """

    def __init__(self, cfg: Config, device: torch.device | str, plain: bool = False):
        cfg.validate()
        missing = [what for what, cond in (
            ("the EXPLICIT grid path", cfg.shape != ParticleShape.MATRIX_FREE),
            ("linear runs", cfg.linear),
            ("full-f runs", not cfg.deltaf)) if cond]
        if missing:
            raise NotImplementedError(
                f"not ported to pic1dp_tpu_torch yet: {', '.join(missing)}")
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
        val = torch.where(state.live, state.w, 0.0) * self.sp.charge
        p_c, p_s = spectral_ops.project_modes(trig, val)
        return self._with_field(state, state.x, state.v, state.w, p_c, p_s)

    def step(self, state: SimState) -> SimState:
        """One full RK2 step; x, v and w are updated in place."""
        w1, v1, (pc1, ps1) = self._substep1(
            state.x, state.v, state.p, state.w, state.mode_re, state.mode_im)
        mre1, mim1 = self._solve(pc1, ps1)
        x2, v2, w2, (pc2, ps2) = self._substep2(
            state.x, state.v, state.p, state.w, w1, v1, mre1, mim1)
        return self._with_field(state, x2, v2, w2, pc2, ps2)

    def multi_step(self, state: SimState, k: int) -> SimState:
        """k steps, queued without a host sync."""
        for _ in range(k):
            state = self.step(state)
        return state

    def energies(self, state: SimState) -> diagnostics.Energies:
        return diagnostics.energies(self.cfg, self.sp, state)

    def ptcldist(self, state: SimState) -> diagnostics.PtclDist:
        return diagnostics.ptcldist(self.cfg, self.sp, state)
