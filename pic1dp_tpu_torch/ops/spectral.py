"""Spectral (partial-DFT) Poisson solver (port of pic1dp_tpu/ops/spectral.py).

The reference solves Gauss's law dE/dx = rho by keeping only a configured set
of Fourier modes: it assembles an nx-by-nmode cosine matrix and an nx-by-nmode
(-sine) matrix (reference src/pic1dp_field.F90:176-210) and applies them as
SpMV pairs per step (:218-270).  Here they are two small dense matrices.

Conventions (reference src/pic1dp_field.F90:218-257):

    Fre[ix, m] = cos(2 pi mode_m ix / nx)
    Fim[ix, m] = -sin(2 pi mode_m ix / nx)
    mode_im = -(Fre^T rho) / nx           (:231-234)
    mode_re = +(Fim^T rho) / nx           (:236-239)
    mode_re *= grad_inv;  mode_im *= grad_inv,  grad_inv_m = lx/(2 pi mode_m)
    E = 2 * (Fre @ mode_re + Fim @ mode_im)  (:250-257)

Every tensor here is built at the caller's dtype and device: a float64
(nmode,) buffer would promote the whole f32 path.

The matrix-free hot path never touches the nx grid: hat deposition followed
by the partial DFT is linear, so each particle adds its share to the mode
projections directly, at the INTEGER grid angles th_m(j) = 2 pi m j / nx of
its two hat neighbours,

    p_c[m] = sum_i a_i (w0_i cos(th_m(ix0_i)) + w1_i cos(th_m(ix1_i)))
    p_s[m] = sum_i a_i (w0_i sin(th_m(ix0_i)) + w1_i sin(th_m(ix1_i)))

which equals deposit-to-grid + MatMultTranspose (src/pic1dp_interaction.F90:
96-135 then src/pic1dp_field.F90:230-240) up to summation order.  The gather
is the kept-mode expansion of E at the same two neighbours.  The second
neighbour's angle is a constant rotation of the first's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SpectralOperator(NamedTuple):
    """Precomputed partial-DFT matrices and inverse-gradient diagonal."""

    fre: torch.Tensor        # (nx, nmode) cos
    fim: torch.Tensor        # (nx, nmode) -sin
    grad_inv: torch.Tensor   # (nmode,) 1 / k_m = lx / (2 pi mode_m)

    @classmethod
    def create(cls, nx: int, modes: tuple[int, ...], lx: float,
               dtype: torch.dtype, device: torch.device | str) -> "SpectralOperator":
        ix = np.arange(nx)[:, None]
        m = np.asarray(modes)[None, :]
        theta = 2.0 * np.pi / nx * m * ix
        grad_inv = lx / (2.0 * np.pi * np.asarray(modes, dtype=np.float64))

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(fre=t(np.cos(theta)), fim=t(-np.sin(theta)), grad_inv=t(grad_inv))

    def solve(self, rho: torch.Tensor):
        """rho (nx,) -> (E (nx,), mode_re (nmode,), mode_im (nmode,))."""
        nx = self.fre.shape[0]
        mode_im = -(self.fre.T @ rho) / nx
        mode_re = (self.fim.T @ rho) / nx
        mode_re = mode_re * self.grad_inv
        mode_im = mode_im * self.grad_inv
        return self.e_grid(mode_re, mode_im), mode_re, mode_im

    def e_grid(self, mode_re: torch.Tensor, mode_im: torch.Tensor) -> torch.Tensor:
        """E(x) on the grid from the E-field mode components
        (reference src/pic1dp_field.F90:250-257)."""
        return 2.0 * (self.fre @ mode_re + self.fim @ mode_im)

    def rho_grid_from_projections(self, p_c: torch.Tensor, p_s: torch.Tensor,
                                  lx: float) -> torch.Tensor:
        """Kept-mode reconstruction of the charge density from the raw
        particle projections of `project_modes`."""
        rho_re = p_c * (1.0 / lx)
        rho_im = -p_s * (1.0 / lx)
        return 2.0 * (self.fre @ rho_re + self.fim @ rho_im)


def _hat_fracs(x, lx: float, nx: int):
    """ix0 (as a float) and hat weights (shared across modes)."""
    s = x * (nx / lx)
    ix0 = torch.floor(s)
    frac = s - ix0
    ix0 = ix0.clamp(0.0, float(nx - 1))
    return ix0, 1.0 - frac, frac


def mode_trig(x, lx: float, nx: int, modes: tuple[int, ...]):
    """Per-mode cos/sin at the two hat-neighbor grid angles.

    Returns (w0, w1, [(c0, s0, c1, s1)] per mode); all tensors shaped like x.
    The angle constants are computed in float64 and multiply x's dtype as
    Python floats, which never promote a tensor.
    """
    ix0, w0, w1 = _hat_fracs(x, lx, nx)
    out = []
    for m in modes:
        step = 2.0 * np.pi * m / nx
        theta0 = ix0 * float(step)
        c0 = torch.cos(theta0)
        s0 = torch.sin(theta0)
        cd, sd = float(np.cos(step)), float(np.sin(step))
        c1 = c0 * cd - s0 * sd
        s1 = s0 * cd + c0 * sd
        out.append((c0, s0, c1, s1))
    return w0, w1, out


def project_modes(trig, val):
    """Raw mode projections (p_c, p_s), each (nmode,), of a hat-deposited
    particle cloud; `val` = per-particle deposit value (0 for dead markers,
    charge folded in), `trig` = mode_trig(x_deposit, ...)."""
    w0, w1, per_mode = trig
    p_c = torch.stack([torch.sum(val * (w0 * c0 + w1 * c1))
                       for (c0, s0, c1, s1) in per_mode])
    p_s = torch.stack([torch.sum(val * (w0 * s0 + w1 * s1))
                       for (c0, s0, c1, s1) in per_mode])
    return p_c, p_s


def solve_modes_from_projections(p_c, p_s, grad_inv, lx: float):
    """E-field mode components from raw projections: the reference's
    (1/nx)-normalized transform plus grad_inv multiply
    (src/pic1dp_field.F90:230-248), composed with rho = grid * nx / lx.
    Device tensors in, device tensors out: no host sync."""
    mode_re = -p_s * (grad_inv / lx)
    mode_im = -p_c * (grad_inv / lx)
    return mode_re, mode_im


def efield_at(trig, mode_re, mode_im):
    """E hat-interpolated to the particles of `trig` from mode components."""
    w0, w1, per_mode = trig
    e = None
    for i, (c0, s0, c1, s1) in enumerate(per_mode):
        term = (w0 * c0 + w1 * c1) * mode_re[i] - (w0 * s0 + w1 * s1) * mode_im[i]
        e = term if e is None else e + term
    return 2.0 * e
