"""Charge deposition (S^T w in the vector-matrix formulation; port of
pic1dp_tpu/ops/deposit.py).

Each particle at position x carrying `val` adds (1 - frac) * val to cell ix
and frac * val to cell (ix + 1) mod nx (reference
src/pic1dp_interaction.F90:96-115, the matrix-free iptclshape = 4 loop).

The JAX package holds three forms of this sum (flat one-hot, two-level
one-hot, segment_sum) because the TPU has no fast scatter.  This module has
one (ops/hist_kernels.grid_charge, the counterpart of deposit_segment), and
every DepositMethod selects it: the DepositMethod values and deposit_chunk
are accepted only so that configs and checkpoints of the JAX package load.
On CUDA it is the GRID_CHARGE kernel, whose sums run in an order the code
fixes (no float atomic), so the grid repeats bit for bit from run to run; on
the CPU one index_add_.  The EXPLICIT path and diag_full_rho reach it
through deposit below (Stepper.deposit_charge, Stepper.full_rho).
"""

from __future__ import annotations

import torch

from pic1dp_tpu_torch.ops import hist_kernels


def deposit(x: torch.Tensor, val: torch.Tensor, lx: float, nx: int) -> torch.Tensor:
    """Hat-weighted sum of val (any shape, like x) onto the (nx,) grid."""
    return hist_kernels.grid_charge(x, val, lx, nx)
