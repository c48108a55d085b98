"""Snapshot output stream writer.

Produces the same logical record stream as the reference
(src/pic1dp_output.F90):

  header:   ints [nspecies, nmode, nx, nv, nx_opd, nv_opd, modes...] (:75-86)
            reals [lx, v_max] (:88-92)
  per snapshot (output_all, :554-570):
    scalars [time, int E^2 dx, per species (marker, total, pertb) energy]
    Vec mode_re, Vec mode_im (E-field Fourier components)
    Vec electric(x), Vec chargeden(x)
    per species: 3 x (nx_opd*nv_opd) dists (marker, total, pertb),
                 3 x (nv_opd) dists

in the PETSc binary-viewer format (io/petsc_binary.py), streamed to disk as
the run progresses, so the file is valid after every snapshot and readable by
both pic1dp_tpu.analysis and the reference's Python tools.
"""

from __future__ import annotations

import os
from typing import BinaryIO

import numpy as np

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.io import petsc_binary as pb


class SnapshotWriter:
    """Streams snapshots to `<path>/pic1dp.out` (reference file name,
    src/pic1dp_output.F90:68-72)."""

    def __init__(self, cfg: Config, path: str = ".", filename: str = "pic1dp.out"):
        self.cfg = cfg
        os.makedirs(path, exist_ok=True)
        self.filepath = os.path.join(path, filename)
        self._fh: BinaryIO = open(self.filepath, "wb")
        pb.write_int(self._fh, [cfg.nspecies, cfg.nmode, cfg.nx, cfg.nv,
                                cfg.nx_opd, cfg.nv_opd, *cfg.modes])
        pb.write_real(self._fh, [cfg.lx, cfg.v_max])
        self._fh.flush()

    def write_snapshot(self, time: float, energies, mode_re, mode_im,
                       electric, rho, ptcl) -> None:
        """energies: diagnostics.Energies; ptcl: diagnostics.PtclDist."""
        cfg = self.cfg
        scalars = [time, float(energies.field)]
        for s in range(cfg.nspecies):
            scalars += [float(energies.marker[s]), float(energies.total[s]),
                        float(energies.pertb[s])]
        pb.write_real(self._fh, scalars)
        pb.write_vec(self._fh, np.asarray(mode_re))
        pb.write_vec(self._fh, np.asarray(mode_im))
        pb.write_vec(self._fh, np.asarray(electric))
        pb.write_vec(self._fh, np.asarray(rho))
        for s in range(cfg.nspecies):
            # xv arrays are stored flattened row-major (iv * nx_opd + ix),
            # matching reference indexing (src/pic1dp_output.F90:252-298)
            pb.write_real(self._fh, np.asarray(ptcl.markr_xv[s]).reshape(-1))
            pb.write_real(self._fh, np.asarray(ptcl.total_xv[s]).reshape(-1))
            pb.write_real(self._fh, np.asarray(ptcl.pertb_xv[s]).reshape(-1))
            pb.write_real(self._fh, np.asarray(ptcl.markr_v[s]))
            pb.write_real(self._fh, np.asarray(ptcl.total_v[s]))
            pb.write_real(self._fh, np.asarray(ptcl.pertb_v[s]))
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
