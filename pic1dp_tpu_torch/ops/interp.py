"""Hat-function (CIC) interpolation primitives (port of pic1dp_tpu/ops/interp.py).

The reference's "shape" of a particle is linear (hat/cloud-in-cell)
interpolation between the two nearest grid points with periodic boundary:

    s  = x / lx * nx;  ix = floor(s);  frac = s - ix
    weight (1 - frac) at cell ix, weight frac at cell (ix + 1) mod nx

(reference src/pic1dp_particle.F90:306-333, src/pic1dp_interaction.F90:100-113).

The velocity-grid variant spans [-v_max, v_max] with nv-1 intervals and
*inclusive* endpoints:

    s = (v + v_max) / (2 v_max) * (nv - 1);  iv = floor(s)

(reference src/pic1dp_particle.F90:382-389, src/pic1dp_output.F90:247-250).
Indices are int64, the index type of torch's indexing and index_add_.
"""

from __future__ import annotations

import torch


def wrap_x(x: torch.Tensor, lx: float) -> torch.Tensor:
    """Periodic wrap into [0, lx) (reference src/pic1dp_interaction.F90:101-104:
    mod() then shift negatives).  torch.remainder, like jnp.mod, takes the
    sign of the divisor; torch.fmod would keep the sign of x."""
    return torch.remainder(torch.remainder(x, lx) + lx, lx)


def hat_x(x: torch.Tensor, lx: float, nx: int):
    """Cell index and hat weights for an x already in [0, lx).

    Returns (ix0, ix1, w0, w1): w0 = 1 - frac at ix0, w1 = frac at
    ix1 = (ix0 + 1) mod nx.
    """
    s = x * (nx / lx)
    ix0 = torch.floor(s).long()
    frac = s - ix0.to(s.dtype)
    # guard against x == lx after float roundoff
    ix0 = ix0.clamp(0, nx - 1)
    ix1 = torch.where(ix0 + 1 >= nx, 0, ix0 + 1)
    return ix0, ix1, 1.0 - frac, frac


def hat_v(v: torch.Tensor, v_max: float, nv: int):
    """Velocity-grid index and hat weights on the inclusive [-v_max, v_max]
    grid with nv points (nv - 1 intervals).

    Returns (iv0, iv1, w0, w1, inside) where `inside` masks |v| < v_max
    (reference skips too-fast particles, src/pic1dp_particle.F90:379-380).
    Out-of-range particles get clipped indices and `inside=False`; callers
    multiply weights by the mask.
    """
    s = (v + v_max) * ((nv - 1) / (2.0 * v_max))
    iv0 = torch.floor(s).long()
    frac = s - iv0.to(s.dtype)
    inside = torch.abs(v) < v_max
    iv0 = iv0.clamp(0, nv - 2)
    return iv0, iv0 + 1, 1.0 - frac, frac, inside


def hat_v_clipped(v: torch.Tensor, v_max: float, nv: int):
    """Velocity-grid interpolation *sampling* variant used by merge/remove/
    split to evaluate the |delta f|(v) profile at particle velocities: instead
    of skipping out-of-range particles it clamps to the boundary cell with
    full weight (reference src/pic1dp_particle.F90:452-466).

    Returns (iv0, iv1, w0, w1).
    """
    s = (v + v_max) * ((nv - 1) / (2.0 * v_max))
    iv0 = torch.floor(s).long()
    frac = s - iv0.to(s.dtype)
    clipped = (iv0 < 0) | (iv0 >= nv - 1)
    iv0 = iv0.clamp(0, nv - 1)
    # clipped particles take the boundary value with weight 1 (sv = 1.0)
    w0 = torch.where(clipped, 1.0, 1.0 - frac)
    w1 = torch.where(clipped, 0.0, frac)
    iv1 = torch.where(iv0 + 1 >= nv, nv - 1, iv0 + 1)
    return iv0, iv1, w0, w1
