"""Diagnostics: energies and particle-distribution snapshots (port of
pic1dp_tpu/core/diagnostics.py).

Reference equivalents:
  * field/kinetic energies: src/pic1dp_output.F90:117-172
  * x-v and v distribution snapshots on the nx_opd x nv_opd diagnostic grid:
    src/pic1dp_output.F90:196-477

The JAX package deposits the x-v histogram as a chunked one-hot contraction
because the TPU has no fast scatter.  Here it is ops/hist_kernels.hist_xv,
four hat corners per marker onto the flat bins iv * nx_opd + ix, and the
|delta f|(v) profile that drives particle optimization (dist_pertb_abs_v) is
ops/hist_kernels.profile, onto the flat bins species * nv + iv.  On CUDA both
are hand-written kernels whose sums run in an order the code fixes (no float
atomic), so a snapshot's histograms and the profile repeat bit for bit from
run to run; on the CPU each is one index_add_.

When the particle axis is split over ranks (parallel/mesh.py), `reduce`
sums a rank's partial sums over the ranks: the energies' marker sums and
ptcldist's RAW histograms, before any derived quantity (normalization, the
full-f equilibrium subtraction), as the JAX package's psums do.

On CUDA a snapshot takes both from one pass over the markers a species
(marker_pass, ops/hist_kernels.xv_pass): the x-v histogram kernel reads
live, p and w itself and sums the energies' v^2 moments in the same pass,
so no marker-sized array is formed; energies and ptcldist, the plain
version, run on the CPU and in the tests that hold the pass.

A snapshot's arrays travel to the host as one packed buffer
(SnapshotLayout): Stepper.snapshot forms them and packs them on the device,
the host copies the buffer once and reads each array as a view of the copy.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.ops import hist_kernels


class Energies(NamedTuple):
    field: torch.Tensor    # scalar: int E^2 dx = sum(E^2) * lx / nx (reference :120-124)
    marker: torch.Tensor   # (ns,): sum_live v^2          (reference :126-135)
    total: torch.Tensor    # (ns,): sum v^2 p             (reference :137-143)
    pertb: torch.Tensor    # (ns,): sum v^2 w (delta-f)   (reference :145-171)


Reduce = Callable[..., tuple]


def unreduced(*tensors):
    """A rank's sums as they are: one device, or nothing to reduce."""
    return tensors


def energies(cfg: Config, sp: dist.SpeciesParams, state: SimState,
             reduce: Reduce = unreduced) -> Energies:
    v2 = torch.where(state.live, state.v * state.v, 0.0)
    return _energies(cfg, sp, state, *reduce(torch.sum(v2, dim=1),
                                             torch.sum(v2 * state.p, dim=1),
                                             torch.sum(v2 * state.w, dim=1)))


def _energies(cfg: Config, sp: dist.SpeciesParams, state: SimState, marker, total,
              pertb) -> Energies:
    """Energies from the raw marker sums over every rank: sum_live v^2,
    v^2 p and v^2 w, each (ns,)."""
    field = torch.sum(state.electric ** 2) * (cfg.lx / cfg.nx)
    if cfg.deltaf:
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
    hist_xv = hist_kernels.hist_xv(x, v, vals, lx, v_max, nx, nv)
    return hist_xv, hist_xv.sum(dim=2)


def ptcldist(cfg: Config, sp: dist.SpeciesParams, state: SimState,
             reduce: Reduce = unreduced) -> PtclDist:
    """Marker/total/perturbed distribution snapshots
    (reference src/pic1dp_output.F90:196-477)."""
    out_xv, out_v = [], []
    for s in range(cfg.nspecies):
        vals = hist_kernels.xv_channels(state.live[s], state.p[s], state.w[s], state.x.dtype)
        hxv, hv = deposit_xv(state.x[s], state.v[s], vals, cfg.lx, cfg.v_max,
                             cfg.nx_opd, cfg.nv_opd)
        out_xv.append(hxv)
        out_v.append(hv)
    # the RAW histograms: f0 must come off the sum over ranks, not once per rank
    return _ptcldist(cfg, sp, state, *reduce(torch.stack(out_xv, dim=1),
                                             torch.stack(out_v, dim=1)))


def _ptcldist(cfg: Config, sp: dist.SpeciesParams, state: SimState, hxv, hv) -> PtclDist:
    """PtclDist from the raw histograms over every rank: hxv (3, ns, nv,
    nx) and hv (3, ns, nv) of the channels live, p and w."""
    nx, nv = cfg.nx_opd, cfg.nv_opd
    delx_inv = nx / cfg.lx
    delv_inv = (nv - 1) / (2.0 * cfg.v_max)
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


def _stack(tensors, dim: int) -> torch.Tensor:
    """torch.stack, or a view of the one tensor (no copy for one species)."""
    return tensors[0].unsqueeze(dim) if len(tensors) == 1 else torch.stack(tensors, dim)


def marker_pass(cfg: Config, sp: dist.SpeciesParams, state: SimState,
                reduce: Reduce = unreduced) -> tuple[Energies, PtclDist]:
    """energies and ptcldist from one pass over each species' markers
    (hist_kernels.xv_pass): its histograms are ptcldist's bit for bit, and
    its moments are the energies' raw sums, summed in the pass's order.
    Each is reduced over the ranks as energies and ptcldist reduce it."""
    hxv, hv, moments = [], [], []
    for s in range(cfg.nspecies):
        h, m = hist_kernels.xv_pass(state.x[s], state.v[s], state.live[s], state.p[s],
                                    state.w[s], cfg.lx, cfg.v_max, cfg.nx_opd, cfg.nv_opd)
        hxv.append(h)
        hv.append(h.sum(dim=2))
        moments.append(m)
    eng = _energies(cfg, sp, state, *reduce(*_stack(moments, 1)))
    return eng, _ptcldist(cfg, sp, state, *reduce(_stack(hxv, 1), _stack(hv, 1)))


class Snapshot(NamedTuple):
    """What a snapshot record and the progress line need: device tensors
    where Stepper.snapshot forms them, numpy views of one host copy where
    SnapshotLayout.unpack reads them."""

    energies: Energies
    mode_re: Any
    mode_im: Any
    electric: Any
    rho: Any             # the state's rho, or the full-spectrum rho (diag_full_rho)
    ptcl: PtclDist
    nlive: Any           # (ns,) int64 live markers, or None without live_count


class SnapshotLayout:
    """Where each array of a Snapshot lies in one flat buffer of the state's
    float dtype, in the order of Snapshot's fields: the field energy, each
    species' marker, total and perturbed energies, mode_re, mode_im, E, rho,
    the six histograms in PtclDist's order and, with live_count, the live
    counts.  Every array but the counts is of that dtype, so packing copies
    its values exactly; the int64 counts are packed as their raw bytes
    (8 / itemsize elements a count).  The layout follows from the config,
    the dtype and live_count alone."""

    def __init__(self, cfg: Config, dtype: torch.dtype, live_count: bool = False):
        ns, nxo, nvo = cfg.nspecies, cfg.nx_opd, cfg.nv_opd
        self.dtype, self.live_count = dtype, live_count
        self.shapes = ([(), (ns,), (ns,), (ns,), (cfg.nmode,), (cfg.nmode,), (cfg.nx,),
                        (cfg.nx,)] + [(ns, nvo, nxo)] * 3 + [(ns, nvo)] * 3)
        if live_count:
            self.shapes.append((ns * 8 // dtype.itemsize,))
        self.sizes = [math.prod(shape) for shape in self.shapes]
        self.numel = sum(self.sizes)

    def pack(self, snap: Snapshot) -> torch.Tensor:
        """The snapshot's arrays laid end to end in one new tensor."""
        parts = [*snap.energies, snap.mode_re, snap.mode_im, snap.electric, snap.rho,
                 *snap.ptcl]
        if self.live_count:
            parts.append(snap.nlive.view(self.dtype))
        for part, shape in zip(parts, self.shapes):
            if part.dtype != self.dtype or tuple(part.shape) != shape:
                raise ValueError(f"a snapshot array of {part.dtype} {tuple(part.shape)} "
                                 f"where the layout holds {self.dtype} {shape}")
        return torch.cat([part.reshape(-1) for part in parts])

    def unpack(self, flat: np.ndarray) -> Snapshot:
        """A Snapshot of views of `flat`, a host copy of a packed buffer."""
        views, at = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            views.append(flat[at:at + size].reshape(shape))
            at += size
        nlive = views[14].view(np.int64) if self.live_count else None
        return Snapshot(Energies(*views[:4]), *views[4:8], PtclDist(*views[8:14]), nlive)


def dist_pertb_abs_v(v, w, live, v_max: float, nv: int) -> torch.Tensor:
    """|delta f| deposited on the nv-point velocity grid, per species —
    drives merge/remove/split (reference particle_compute_dist_pertb_abs_v,
    src/pic1dp_particle.F90:356-403).  v, w, live: (ns, N) -> (ns, nv).
    Markers with |v| >= v_max are skipped."""
    return hist_kernels.profile(v, w, live, v_max, nv)
