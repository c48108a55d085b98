"""The initial markers of a run, made by the benchmark from --seed.

Every run of a cell starts from these markers, and the plain reference
starts from the same.  x and v are drawn on the device by a torch.Generator
seeded from the seed and the process's place in the job, in two large
calls, in the dtype the program holds them in, x first.  The configuration's
marker loading, as the reference's Physics reads it, decides v:

  uniform   v uniform in [-v_max, v_max], formed in the markers' dtype
  physical  v ~ f0 species by species (Maxwellian only): standard normals
            drawn in the markers' dtype, v0 + sqrt(T/m) times them formed in
            float64 and rounded once to that dtype

p and w follow from x and v through the reference's loader in float64,
rounded once to that dtype.
"""

from __future__ import annotations

import dataclasses

import torch

SEED_MOD = 2**63


@dataclasses.dataclass
class Markers:
    """This process's block of the markers, (nspecies, n) each."""

    x: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    live: torch.Tensor


def block_seed(seed: int, rank: int) -> int:
    """The generator seed of block `rank` (any whole number `seed`)."""
    return (int(seed) * 1_000_003 + 7_919 * (rank + 1)) % SEED_MOD


def make(physics, dtype: torch.dtype, n_block: int, n_global: int, seed: int, rank: int,
         device) -> Markers:
    """Block `rank` of n_global markers per species: x uniform in [0, lx),
    v by the configuration's marker loading, every marker live."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, rank))
    shape = (physics.nspecies, n_block)
    x = torch.rand(shape, generator=gen, dtype=dtype, device=device) * physics.lx
    x = torch.where(x < physics.lx, x, 0.0)
    if physics.marker == "physical":
        normal = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        vth = torch.sqrt(physics.temperature / physics.mass)
        v = (physics.v0 + vth * normal.to(torch.float64)).to(dtype)
    else:
        v = (torch.rand(shape, generator=gen, dtype=dtype, device=device) - 0.5) \
            * (2.0 * physics.v_max)
    p, w = physics.load_weights(x, v, n_global)
    return Markers(x=x, v=v, p=p.to(dtype), w=w.to(dtype),
                   live=torch.ones(shape, dtype=torch.bool, device=device))
