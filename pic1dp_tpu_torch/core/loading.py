"""Marker particle loading (port of pic1dp_tpu/core/loading.py).

Mirrors reference particle_load (src/pic1dp_particle.F90:145-269):
  1. velocities: Gaussian ~ f0 for PHYSICAL marker loading (Maxwellian only,
     :172-178) or uniform in [-v_max, v_max] for UNIFORM loading (:179-181)
  2. equilibrium weight p = f0/g evaluated per equilibrium (:182-218)
  3. x ~ U[0, lx)  (:221-223)
  4. w = sum_modes (A_cos cos(2 pi m x / lx) + A_sin sin(...)) * p
         * pertb_shape(v)  (:225-237)
  5. surplus markers beyond nparticle_init unloaded (live mask) (:239-248)
  6. nonlinear: p += w so p = f/g (:259-264)

Two RNG backends:
  * the default (cfg.rng.backend "jax"): a torch.Generator on the state's
    device, seeded with cfg.rng.seed.  Its numbers are not jax.random's: this
    loader is held to the JAX one statistically, and tests move one loaded
    state into both packages instead.
  * "multirand": bit-exact reproduction of the reference's multirand engines
    (pic1dp_tpu_torch.rng), drawn on the host in float64 in the reference's
    order, so a constant-seed run loads the identical markers as the Fortran
    code and as the JAX package.  This loader follows the JAX one step for
    step; unlike the torch.Generator loader it does not fold a position
    drawn as exactly lx back to 0 (the engines' uniform is inclusive of 1;
    hat_x clamps such a marker into the last cell).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, MarkerLoading
from pic1dp_tpu_torch.core.state import SimState, balanced_live_mask, torch_dtype

# (velocities of one species, its index) -> a factor on its initial w
PertbShape = Callable[[torch.Tensor, int], torch.Tensor]


def _initial_w(cfg: Config, x, p, v=None, pertb_shape: PertbShape | None = None):
    """Initial perturbed weight (reference src/pic1dp_particle.F90:225-237)."""
    w = torch.zeros_like(x)
    for mode, amp_c, amp_s in zip(cfg.init_modes, cfg.init_amp_cos, cfg.init_amp_sin):
        theta = (2.0 * math.pi / cfg.lx) * mode * x
        w = w + amp_c * torch.cos(theta) + amp_s * torch.sin(theta)
    w = w * p
    if pertb_shape is not None:
        # per-species hook (reference input_pertb_shape, src/pic1dp_input.F90:263-281)
        w = w * torch.stack([pertb_shape(v[s], s) for s in range(cfg.nspecies)])
    return w


def _reference_live_mask(nmax: int, ninit: int, offsets) -> np.ndarray:
    """The reference's unload semantics (src/pic1dp_particle.F90:239-248):
    each rank drops the LAST (nmax - ninit)/npe slots of its block, with the
    division remainder dropped on rank 0 additionally."""
    npe = len(offsets) - 1
    surplus = nmax - ninit
    base = surplus // npe
    mask = np.ones(nmax, dtype=bool)
    for r in range(npe):
        unload = base + (surplus % npe if r == 0 else 0)
        if unload:
            mask[offsets[r + 1] - unload:offsets[r + 1]] = False
    return mask


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


def _weights(cfg: Config, sp: dist.SpeciesParams, v):
    """(v, p) of the configured marker loading from raw draws `v`: standard
    normals for PHYSICAL loading, uniform in [0, 1) for UNIFORM."""
    ns, n = cfg.nspecies, cfg.nparticle_max
    npinit = torch.tensor([[ni] for ni in cfg.nparticle_init], dtype=v.dtype,
                          device=v.device)
    if cfg.marker == MarkerLoading.PHYSICAL:
        # markers ~ f0: Maxwellian only (reference :172-178)
        v = v * torch.sqrt(sp.temperature / sp.mass) + sp.v0
        p = sp.density * cfg.lx / npinit * torch.ones((ns, n), dtype=v.dtype,
                                                      device=v.device)
    else:
        p = dist.loader_weight_uniform(cfg.equilibrium, sp, v, cfg.lx,
                                       cfg.v_max, npinit)
    return v, p


def load_particles_multirand(cfg: Config, device: torch.device | str,
                             emulate_ranks: int = 1,
                             pertb_shape: PertbShape | None = None) -> SimState:
    """Load markers with the multirand-compatible engines, drawing in the
    reference's order so constant-seed runs are marker-for-marker identical
    to the Fortran code run on `emulate_ranks` MPI ranks.

    Rank r owns the PETSC_DECIDE contiguous block of the particle axis
    (n // npe plus one extra for the first n % npe ranks, matching
    VecSetSizes(PETSC_DECIDE, ...) reference src/pic1dp_particle.F90:89-94),
    and seeds its engine with mype=r (reference :159-160).  The draws are
    made on the host in float64, cast to cfg.dtype and moved to `device`,
    where the weights are computed.
    """
    from pic1dp_tpu_torch.rng.native import make_multirand

    dtype = torch_dtype(cfg.dtype)
    ns, n = cfg.nspecies, cfg.nparticle_max
    rc = cfg.rng

    # PETSC_DECIDE ownership blocks
    base, extra = divmod(n, emulate_ranks)
    counts = [base + (1 if r < extra else 0) for r in range(emulate_ranks)]
    offsets = np.concatenate([[0], np.cumsum(counts)])

    x = np.empty((ns, n))
    v = np.empty((ns, n))
    for r in range(emulate_ranks):
        eng = make_multirand(algorithm=rc.algorithm, seed_type=rc.seed_type,
                             mype=r, warmup=rc.warmup,
                             selftest=rc.selftest and r == 0)
        lo, hi = offsets[r], offsets[r + 1]
        cnt = int(hi - lo)
        for s in range(ns):
            # reference order per species: v array, (p computed from v), x array
            if cfg.marker == MarkerLoading.PHYSICAL:
                v[s, lo:hi] = eng.gaussian_array(cnt)
            else:
                v[s, lo:hi] = (eng.real_array(cnt) - 0.5) * 2.0 * cfg.v_max
            x[s, lo:hi] = eng.real_array(cnt) * cfg.lx

    sp = dist.SpeciesParams.from_config(cfg, dtype, device)
    vt = torch.from_numpy(v).to(device=device, dtype=dtype)
    xt = torch.from_numpy(x).to(device=device, dtype=dtype)
    vt, p = _weights(cfg, sp, vt)
    w = _initial_w(cfg, xt, p, vt, pertb_shape)
    # reference unload semantics so the LIVE marker set (not just the drawn
    # values) matches a Fortran run on emulate_ranks ranks
    live = torch.from_numpy(np.stack([_reference_live_mask(n, ni, offsets)
                                      for ni in cfg.nparticle_init])).to(device)
    return _finish_load(cfg, xt, vt, p, w, live=live)


def load_particles(cfg: Config, device: torch.device | str,
                   generator: torch.Generator | None = None,
                   pertb_shape: PertbShape | None = None,
                   emulate_ranks: int = 1) -> SimState:
    """Load markers on `device`: from the multirand engines when
    cfg.rng.backend says so (`emulate_ranks` applies there only), else from
    `generator` (default: a new generator on that device seeded with
    cfg.rng.seed)."""
    device = torch.device(device)
    if cfg.rng.backend == "multirand":
        return load_particles_multirand(cfg, device, emulate_ranks, pertb_shape)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.rng.seed)
    dtype = torch_dtype(cfg.dtype)
    sp = dist.SpeciesParams.from_config(cfg, dtype, device)
    shape = dict(size=(cfg.nspecies, cfg.nparticle_max), generator=generator,
                 dtype=dtype, device=device)
    if cfg.marker == MarkerLoading.PHYSICAL:
        v, p = _weights(cfg, sp, torch.randn(**shape))
    else:
        v, p = _weights(cfg, sp, (torch.rand(**shape) - 0.5) * (2.0 * cfg.v_max))
    # the product can round up to lx itself, which is the cell at 0
    x = torch.rand(**shape) * cfg.lx
    x = torch.where(x < cfg.lx, x, 0.0)
    w = _initial_w(cfg, x, p, v, pertb_shape)
    return _finish_load(cfg, x, v, p, w)
