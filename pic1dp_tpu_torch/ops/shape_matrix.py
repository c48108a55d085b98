"""Explicit particle-shape matrix S in COO form and its transposed-pair
application (port of pic1dp_tpu/ops/shape_matrix.py).

The reference's iptclshape strategies 1-3 materialize the N_p x nx hat
interpolation matrix S (2 nonzeros per row) and apply the pair

    deposit:  rho_grid = S^T w     (reference src/pic1dp_interaction.F90:46-78)
    gather:   E_p      = S  E      (reference :213-220)

Here S is the triplet (ix0, ix1, w0, w1) per particle, assembled once per
substep position and kept beside the positions it was built from.  The
stored-shape cross-check path (cfg.shape = EXPLICIT) applies its gather with
one indexing (ops/gather.py); its deposit, and diag_full_rho's, call
ops/deposit.deposit, which is ops/hist_kernels.grid_charge (on CUDA the
deterministic GRID_CHARGE kernel, on the CPU one index_add_) and assembles no
S.  The production hot loop is matrix-free spectral and never assembles S.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pic1dp_tpu_torch.ops import hist_kernels
from pic1dp_tpu_torch.ops.interp import hat_x


class ShapeMatrix(NamedTuple):
    """COO hat-shape matrix for one set of particle positions x on a box of
    length lx: row i has value w0[i] at column ix0[i] and w1[i] at column
    ix1[i].

    deposit is kept for parity with the JAX package's ShapeMatrix and for
    its tests; no path of the port calls it.  It does not apply the stored
    triplet: it hands x and lx to ops/hist_kernels.grid_charge, which forms
    the same hat weights again where it sums them."""

    ix0: torch.Tensor
    ix1: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor
    nx: int
    x: torch.Tensor
    lx: float

    @classmethod
    def assemble(cls, x: torch.Tensor, lx: float, nx: int) -> "ShapeMatrix":
        """particle_compute_shape_x analogue (reference
        src/pic1dp_particle.F90:275-350); x must already be wrapped."""
        ix0, ix1, w0, w1 = hat_x(x, lx, nx)
        return cls(ix0=ix0, ix1=ix1, w0=w0, w1=w1, nx=nx, x=x, lx=lx)

    def deposit(self, val: torch.Tensor) -> torch.Tensor:
        """S^T val -> (nx,) grid (the SpMV-transpose deposition), the same
        hat weights formed from x again where they are summed."""
        return hist_kernels.grid_charge(self.x, val, self.lx, self.nx)

    def gather(self, grid: torch.Tensor) -> torch.Tensor:
        """S grid -> per-particle values (the SpMV gather)."""
        return self.w0 * grid[self.ix0] + self.w1 * grid[self.ix1]

    def todense(self) -> torch.Tensor:
        """Dense S (testing only; rows = flattened particles)."""
        n = self.ix0.numel()
        rows = torch.arange(n, device=self.ix0.device)
        dense = torch.zeros((n, self.nx), dtype=self.w0.dtype, device=self.w0.device)
        dense.index_put_((rows, self.ix0.reshape(-1)), self.w0.reshape(-1), accumulate=True)
        dense.index_put_((rows, self.ix1.reshape(-1)), self.w1.reshape(-1), accumulate=True)
        return dense
