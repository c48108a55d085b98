"""Field gather (S E in the vector-matrix formulation; port of
pic1dp_tpu/ops/gather.py).

The reference interpolates the replicated electric field to particle
positions with the same hat weights used for deposition (reference
src/pic1dp_interaction.F90:239-258).  The JAX package's one-hot and
two-level forms exist because dynamic gathers serialize on a TPU; here the
gather is plain indexing (ShapeMatrix.gather), the counterpart of gather_take.
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops.shape_matrix import ShapeMatrix


def gather(x: torch.Tensor, grid: torch.Tensor, lx: float, nx: int) -> torch.Tensor:
    """Interpolate grid (nx,) to positions x (any shape), hat weights,
    periodic."""
    return ShapeMatrix.assemble(x, lx, nx).gather(grid)
