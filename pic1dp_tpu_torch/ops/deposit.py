"""Charge deposition (S^T w in the vector-matrix formulation; port of
pic1dp_tpu/ops/deposit.py).

Each particle at position x carrying `val` adds (1 - frac) * val to cell ix
and frac * val to cell (ix + 1) mod nx (reference
src/pic1dp_interaction.F90:96-115, the matrix-free iptclshape = 4 loop).

The JAX package holds three forms of this sum (flat one-hot, two-level
one-hot, segment_sum) because the TPU has no fast scatter.  A GPU has one:
this module is a single index_add_ (ShapeMatrix.deposit), the counterpart of
deposit_segment, and every DepositMethod selects it: the DepositMethod
values and deposit_chunk are accepted only so that configs and checkpoints of
the JAX package load.  On CUDA index_add_ adds with float atomics, so the
grid's last bits may differ from run to run.
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops.shape_matrix import ShapeMatrix


def deposit(x: torch.Tensor, val: torch.Tensor, lx: float, nx: int) -> torch.Tensor:
    """Hat-weighted sum of val (any shape, like x) onto the (nx,) grid."""
    return ShapeMatrix.assemble(x, lx, nx).deposit(val)
