"""Equilibrium velocity-distribution library (port of pic1dp_tpu/distributions.py).

The reference spreads each equilibrium's math over three places that must stay
consistent: marker loading (reference src/pic1dp_particle.F90:182-218), the
delta-f weight push term -f0'/f0 (reference src/pic1dp_interaction.F90:274-326),
and the full-f diagnostic subtraction (reference src/pic1dp_output.F90:371-452).
Here each equilibrium is one set of functions:

    f0(v)              the equilibrium distribution function (per unit v,
                       integrates to `density` over v, except bump-on-tail
                       which integrates to 1 with `density` the core fraction)
    minus_dlnf0_dv(v)  -d(ln f0)/dv = -f0'(v)/f0(v), used by the weight push
    equilibrium_energy equilibrium kinetic energy integral lx * int v^2 f0 dv
                       (full-f perturbed-energy diagnostics,
                       reference src/pic1dp_output.F90:157-170)

All functions are vectorized over a stacked species axis: the species
parameters are (nspecies, 1) tensors and v is (nspecies, nparticle), so one
call covers every species.  The parameter tensors are built at the state's
dtype, so they never promote an f32 chain.

As in the JAX package, the full-f subtraction uses the correct f0 where the
reference drops a sqrt() on the thermal-velocity normalization when T/m != 1
(src/pic1dp_output.F90:413-414); for T = m = 1 the two agree exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pic1dp_tpu_torch.config import Config, Equilibrium

_SQRT2PI = math.sqrt(2.0 * math.pi)


class SpeciesParams(NamedTuple):
    """Species parameters stacked to (nspecies, 1) tensors for broadcasting."""

    charge: torch.Tensor
    mass: torch.Tensor
    temperature: torch.Tensor
    temperature2: torch.Tensor
    density: torch.Tensor
    v0: torch.Tensor

    @classmethod
    def from_config(cls, cfg: Config, dtype: torch.dtype,
                    device: torch.device | str) -> "SpeciesParams":
        def col(attr):
            return torch.tensor([[getattr(s, attr)] for s in cfg.species],
                                dtype=dtype, device=device)

        return cls(charge=col("charge"), mass=col("mass"),
                   temperature=col("temperature"),
                   temperature2=col("temperature2"),
                   density=col("density"), v0=col("v0"))


def _gauss(v, vth2):
    """exp(-v^2 / (2 vth2)) / sqrt(2 pi vth2)."""
    return torch.exp(-v * v / (2.0 * vth2)) / torch.sqrt(2.0 * math.pi * vth2)


def f0(eq: Equilibrium, sp: SpeciesParams, v: torch.Tensor) -> torch.Tensor:
    """Equilibrium distribution f0(v), stacked over species (reference
    src/pic1dp_input.F90:49-54, loader weights src/pic1dp_particle.F90:182-218)."""
    vth2 = sp.temperature / sp.mass
    if eq == Equilibrium.MAXWELLIAN:
        return sp.density * _gauss(v - sp.v0, vth2)
    if eq == Equilibrium.TWO_STREAM1:
        # f(v) = n * v^2 exp(-v^2/2) / sqrt(2 pi); T, v0 unused (reference :51, :64)
        return sp.density * v * v * torch.exp(-v * v / 2.0) / _SQRT2PI
    if eq == Equilibrium.TWO_STREAM2:
        # f(v) = n/2 * (fm(v - v0) + fm(v + v0)) (reference :52)
        return 0.5 * sp.density * (_gauss(v - sp.v0, vth2) + _gauss(v + sp.v0, vth2))
    if eq == Equilibrium.BUMP_ON_TAIL:
        # f(v) = n fm(v; T) + (1 - n) fm(v - v0; T2) (reference :53)
        vth2b = sp.temperature2 / sp.mass
        return sp.density * _gauss(v, vth2) + (1.0 - sp.density) * _gauss(
            v - sp.v0, vth2b)
    raise ValueError(f"unknown equilibrium {eq}")


def minus_dlnf0_dv(eq: Equilibrium, sp: SpeciesParams, v: torch.Tensor) -> torch.Tensor:
    """-f0'(v)/f0(v), the delta-f weight-equation kernel
    (reference src/pic1dp_interaction.F90:274-326)."""
    vth2 = sp.temperature / sp.mass
    if eq == Equilibrium.MAXWELLIAN:
        return (v - sp.v0) / vth2                        # reference :322-326
    if eq == Equilibrium.TWO_STREAM1:
        return v - 2.0 / v                               # reference :276
    if eq == Equilibrium.TWO_STREAM2:
        # weighted mean of the two beams' Maxwellian terms (reference :277-292)
        ep = torch.exp(-(v + sp.v0) ** 2 / (2.0 * vth2))
        em = torch.exp(-(v - sp.v0) ** 2 / (2.0 * vth2))
        return ((v + sp.v0) * ep + (v - sp.v0) * em) / ((ep + em) * vth2)
    if eq == Equilibrium.BUMP_ON_TAIL:
        # core + beam weighted mean (reference :293-321)
        vth2b = sp.temperature2 / sp.mass
        core = sp.density * torch.exp(-v * v / (2.0 * vth2)) / torch.sqrt(vth2)
        beam = ((1.0 - sp.density)
                * torch.exp(-(v - sp.v0) ** 2 / (2.0 * vth2b))
                / torch.sqrt(vth2b))
        return (core * v / vth2 + beam * (v - sp.v0) / vth2b) / (core + beam)
    raise ValueError(f"unknown equilibrium {eq}")


def loader_weight_uniform(eq: Equilibrium, sp: SpeciesParams, v: torch.Tensor,
                          lx: float, v_max: float,
                          nparticle_init: torch.Tensor) -> torch.Tensor:
    """Marker weight p = f0(v) * lx * 2 v_max / N for uniform-in-v loading
    (g = N / (lx * 2 v_max)), reference src/pic1dp_particle.F90:179-218.
    `nparticle_init` has shape (nspecies, 1)."""
    return f0(eq, sp, v) * (lx * 2.0 * v_max) / nparticle_init


def equilibrium_energy(eq: Equilibrium, sp: SpeciesParams, lx: float) -> torch.Tensor:
    """lx * int v^2 f0(v) dv per species, shape (nspecies, 1) (reference
    src/pic1dp_output.F90:157-170 has two of the four cases; all four here)."""
    vth2 = sp.temperature / sp.mass
    if eq == Equilibrium.MAXWELLIAN:
        return (vth2 + sp.v0**2) * sp.density * lx
    if eq == Equilibrium.TWO_STREAM1:
        # int v^2 * v^2 exp(-v^2/2)/sqrt(2 pi) dv = 3
        return 3.0 * sp.density * lx
    if eq == Equilibrium.TWO_STREAM2:
        return (vth2 + sp.v0**2) * sp.density * lx
    if eq == Equilibrium.BUMP_ON_TAIL:
        vth2b = sp.temperature2 / sp.mass
        return (sp.density * vth2 + (1.0 - sp.density) * (vth2b + sp.v0**2)) * lx
    raise ValueError(f"unknown equilibrium {eq}")
