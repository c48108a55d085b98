"""Diagnostics: energies and particle-distribution snapshots (port of
pic1dp_tpu/core/diagnostics.py).

Reference equivalents:
  * field/kinetic energies: src/pic1dp_output.F90:117-172
  * x-v and v distribution snapshots on the nx_opd x nv_opd diagnostic grid:
    src/pic1dp_output.F90:196-477

The JAX package deposits the x-v histogram as a chunked one-hot contraction
because the TPU has no fast scatter.  Here it is one index_add_ over the flat
bins iv * nx_opd + ix, four hat corners per marker.  On CUDA index_add_ adds
with atomics, so a snapshot's histograms may differ in the last bits from run
to run; the step itself does not use them.  The |delta f|(v) histogram that
drives particle optimization (dist_pertb_abs_v) is one index_add_ as well,
over the flat bins species * nv + iv.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.ops.interp import hat_v, hat_x


class Energies(NamedTuple):
    field: torch.Tensor    # scalar: int E^2 dx = sum(E^2) * lx / nx (reference :120-124)
    marker: torch.Tensor   # (ns,): sum_live v^2          (reference :126-135)
    total: torch.Tensor    # (ns,): sum v^2 p             (reference :137-143)
    pertb: torch.Tensor    # (ns,): sum v^2 w (delta-f)   (reference :145-171)


def energies(cfg: Config, sp: dist.SpeciesParams, state: SimState) -> Energies:
    field = torch.sum(state.electric ** 2) * (cfg.lx / cfg.nx)
    v2 = torch.where(state.live, state.v * state.v, 0.0)
    marker = torch.sum(v2, dim=1)
    total = torch.sum(v2 * state.p, dim=1)
    if cfg.deltaf:
        pertb = torch.sum(v2 * state.w, dim=1)
        if cfg.linear:
            # linear: p = f0/g, perturbed energy must be added to get total
            # (reference src/pic1dp_output.F90:152-155)
            total = total + pertb
    else:
        # full-f: subtract the analytic equilibrium energy (reference :156-170)
        pertb = total - dist.equilibrium_energy(cfg.equilibrium, sp, cfg.lx)[:, 0]
    return Energies(field=field, marker=marker, total=total, pertb=pertb)


class PtclDist(NamedTuple):
    """Per-species distribution snapshots (reference output_ptcldist).

    xv tensors have shape (ns, nv_opd, nx_opd); v tensors (ns, nv_opd).
    Order matches the reference record: marker g, total f, perturbed delta f.
    """

    markr_xv: torch.Tensor
    total_xv: torch.Tensor
    pertb_xv: torch.Tensor
    markr_v: torch.Tensor
    total_v: torch.Tensor
    pertb_v: torch.Tensor


def deposit_xv(x, v, vals, lx: float, v_max: float, nx: int, nv: int):
    """Histogram vals (k, N) over the (nv, nx) diagnostic grid with hat
    weights in both coordinates; particles with |v| >= v_max are skipped
    (reference src/pic1dp_output.F90:239-315).

    Returns (hist_xv (k, nv, nx), hist_v (k, nv)); hist_v is hist_xv summed
    over x, the two x weights of a marker adding up to one.
    """
    k = vals.shape[0]
    ix0, ix1, wx0, wx1 = hat_x(x, lx, nx)
    iv0, iv1, wv0, wv1, inside = hat_v(v, v_max, nv)
    wv0 = torch.where(inside, wv0, 0.0)
    wv1 = torch.where(inside, wv1, 0.0)
    bins = torch.cat([iv0 * nx + ix0, iv0 * nx + ix1, iv1 * nx + ix0, iv1 * nx + ix1])
    weights = torch.cat([wv0 * wx0, wv0 * wx1, wv1 * wx0, wv1 * wx1])
    hist = torch.zeros((nv * nx, k), dtype=vals.dtype, device=vals.device)
    hist.index_add_(0, bins, weights[:, None] * vals.T.repeat(4, 1))
    hist_xv = hist.T.reshape(k, nv, nx)
    return hist_xv, hist_xv.sum(dim=2)


def ptcldist(cfg: Config, sp: dist.SpeciesParams, state: SimState) -> PtclDist:
    """Marker/total/perturbed distribution snapshots
    (reference src/pic1dp_output.F90:196-477)."""
    nx, nv = cfg.nx_opd, cfg.nv_opd
    delx_inv = nx / cfg.lx
    delv_inv = (nv - 1) / (2.0 * cfg.v_max)

    out_xv, out_v = [], []
    for s in range(cfg.nspecies):
        live = state.live[s]
        vals = torch.stack([
            live.to(state.x.dtype),
            torch.where(live, state.p[s], 0.0).to(state.x.dtype),
            torch.where(live, state.w[s], 0.0),
        ])
        hxv, hv = deposit_xv(state.x[s], state.v[s], vals, cfg.lx, cfg.v_max, nx, nv)
        out_xv.append(hxv)
        out_v.append(hv)
    hxv = torch.stack(out_xv, dim=1)  # (3, ns, nv, nx)
    hv = torch.stack(out_v, dim=1)    # (3, ns, nv)

    markr_xv, total_xv, pertb_xv = hxv[0], hxv[1], hxv[2]
    markr_v, total_v, pertb_v = hv[0], hv[1], hv[2]

    if cfg.linear:
        # linear: p = f0/g, add perturbation for the total (reference :327-331)
        total_xv = total_xv + pertb_xv
        total_v = total_v + pertb_v

    # normalize by cell sizes (reference :360-369)
    markr_xv = markr_xv * (delx_inv * delv_inv)
    total_xv = total_xv * (delx_inv * delv_inv)
    markr_v = markr_v * delv_inv
    total_v = total_v * delv_inv
    if cfg.deltaf:
        pertb_xv = pertb_xv * (delx_inv * delv_inv)
        pertb_v = pertb_v * delv_inv
    else:
        # full-f: perturbed = total - analytic equilibrium (reference :370-453)
        vgrid = (torch.arange(nv, dtype=state.x.dtype, device=state.x.device)
                 / (nv - 1) * 2.0 - 1.0) * cfg.v_max
        f0v = dist.f0(cfg.equilibrium, sp, vgrid[None, :])  # (ns, nv)
        pertb_xv = total_xv - f0v[:, :, None]
        pertb_v = total_v - cfg.lx * f0v

    return PtclDist(markr_xv=markr_xv, total_xv=total_xv, pertb_xv=pertb_xv,
                    markr_v=markr_v, total_v=total_v, pertb_v=pertb_v)


def dist_pertb_abs_v(v, w, live, v_max: float, nv: int) -> torch.Tensor:
    """|delta f| deposited on the nv-point velocity grid, per species —
    drives merge/remove/split (reference particle_compute_dist_pertb_abs_v,
    src/pic1dp_particle.F90:356-403).  v, w, live: (ns, N) -> (ns, nv).
    Markers with |v| >= v_max are skipped."""
    ns = v.shape[0]
    iv0, iv1, wv0, wv1, inside = hat_v(v, v_max, nv)
    val = torch.where(live & inside, torch.abs(w), 0.0)
    row = torch.arange(ns, device=v.device)[:, None] * nv
    prof = torch.zeros(ns * nv, dtype=val.dtype, device=val.device)
    prof.index_add_(0, torch.cat([(row + iv0).reshape(-1), (row + iv1).reshape(-1)]),
                    torch.cat([(wv0 * val).reshape(-1), (wv1 * val).reshape(-1)]))
    return prof.reshape(ns, nv)
