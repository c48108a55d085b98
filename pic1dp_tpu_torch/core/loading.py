"""Marker particle loading (port of pic1dp_tpu/core/loading.py).

Mirrors reference particle_load (src/pic1dp_particle.F90:145-269):
  1. velocities: Gaussian ~ f0 for PHYSICAL marker loading (Maxwellian only,
     :172-178) or uniform in [-v_max, v_max] for UNIFORM loading (:179-181)
  2. equilibrium weight p = f0/g evaluated per equilibrium (:182-218)
  3. x ~ U[0, lx)  (:221-223)
  4. w = sum_modes (A_cos cos(2 pi m x / lx) + A_sin sin(...)) * p  (:225-237)
  5. surplus markers beyond nparticle_init unloaded (live mask) (:239-248)
  6. nonlinear: p += w so p = f/g (:259-264)

The random numbers come from a torch.Generator on the state's device, seeded
with cfg.rng.seed.  They are not jax.random's numbers: the loader is held to
the JAX one statistically, and tests move one loaded state into both
packages instead.  Not ported yet: the multirand backend and the
per-species perturbation-shape hook.
"""

from __future__ import annotations

import math
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, MarkerLoading
from pic1dp_tpu_torch.core.state import SimState, balanced_live_mask, torch_dtype

def _initial_w(cfg: Config, x, p):
    """Initial perturbed weight (reference src/pic1dp_particle.F90:225-237)."""
    w = torch.zeros_like(x)
    for mode, amp_c, amp_s in zip(cfg.init_modes, cfg.init_amp_cos, cfg.init_amp_sin):
        theta = (2.0 * math.pi / cfg.lx) * mode * x
        w = w + amp_c * torch.cos(theta) + amp_s * torch.sin(theta)
    return w * p


def _finish_load(cfg: Config, x, v, p, w, live=None) -> SimState:
    zeros = SimState.zeros(cfg, x.device)
    if live is None:
        live = torch.stack([balanced_live_mask(cfg.nparticle_max, n, x.device)
                            for n in cfg.nparticle_init])
    if not cfg.linear:
        # nonlinear: p = f/g = f0/g + delta f/g (reference :259-264)
        p = p + w
    # Dead-slot invariant: p = w = 0 off the live mask, so dead markers
    # deposit nothing and their weights stay zero under the push equations —
    # the hot kernels never need to read the mask (core/state.py docstring).
    p = torch.where(live, p, 0.0).to(torch_dtype(cfg.p_dtype))
    w = torch.where(live, w, 0.0)
    return SimState(x=x, v=v, p=p, w=w, live=live, rho=zeros.rho,
                    electric=zeros.electric, mode_re=zeros.mode_re,
                    mode_im=zeros.mode_im)


def load_particles(cfg: Config, device: torch.device | str,
                   generator: torch.Generator | None = None) -> SimState:
    """Load markers on `device` from `generator` (default: a new generator
    on that device seeded with cfg.rng.seed)."""
    if cfg.rng.backend == "multirand":
        raise NotImplementedError(
            "the multirand loader is not ported to pic1dp_tpu_torch yet")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.rng.seed)
    dtype = torch_dtype(cfg.dtype)
    ns, n = cfg.nspecies, cfg.nparticle_max
    sp = dist.SpeciesParams.from_config(cfg, dtype, device)
    npinit = torch.tensor([[ni] for ni in cfg.nparticle_init], dtype=dtype,
                          device=device)
    shape = dict(size=(ns, n), generator=generator, dtype=dtype, device=device)
    if cfg.marker == MarkerLoading.PHYSICAL:
        # markers ~ f0: Maxwellian only (reference :172-178)
        v = torch.randn(**shape) * torch.sqrt(sp.temperature / sp.mass) + sp.v0
        p = sp.density * cfg.lx / npinit * torch.ones((ns, n), dtype=dtype,
                                                      device=device)
    else:
        v = (torch.rand(**shape) - 0.5) * (2.0 * cfg.v_max)
        p = dist.loader_weight_uniform(cfg.equilibrium, sp, v, cfg.lx,
                                       cfg.v_max, npinit)
    # the product can round up to lx itself, which is the cell at 0
    x = torch.rand(**shape) * cfg.lx
    x = torch.where(x < cfg.lx, x, 0.0)
    w = _initial_w(cfg, x, p)
    return _finish_load(cfg, x, v, p, w)
