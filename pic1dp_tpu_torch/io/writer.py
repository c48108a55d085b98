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
the run progresses and readable by both pic1dp_tpu.analysis and the
reference's Python tools.

A Simulation hands each record over with `defer_snapshot`: the writer holds
it, at most one, and writes it at `write_pending`, which Simulation.run calls
once it has enqueued the next chunk (so the host writes while the device
steps), or at the next `defer_snapshot`, or at `close`.  So the file is
valid, every record whole, after each of those calls: while a snapshot
callback runs it holds the records up to the previous snapshot, and at the
end of a run (however the run ended) all of them.  `write_snapshot` writes at
once.

A record's write is the phase "output: write" of the writer's `timers` (a
Simulation hands it its own), and its bytes the counter "bytes written".
"""

from __future__ import annotations

import os
from typing import BinaryIO

import numpy as np

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.io import petsc_binary as pb
from pic1dp_tpu_torch.utils.timers import PhaseTimers


class SnapshotWriter:
    """Streams snapshots to `<path>/pic1dp.out` (reference file name,
    src/pic1dp_output.F90:68-72)."""

    def __init__(self, cfg: Config, path: str = ".", filename: str = "pic1dp.out",
                 timers: PhaseTimers | None = None):
        self.cfg = cfg
        self.timers = timers if timers is not None else PhaseTimers()
        os.makedirs(path, exist_ok=True)
        self.filepath = os.path.join(path, filename)
        self._fh: BinaryIO = open(self.filepath, "wb")
        pb.write_int(self._fh, [cfg.nspecies, cfg.nmode, cfg.nx, cfg.nv,
                                cfg.nx_opd, cfg.nv_opd, *cfg.modes])
        pb.write_real(self._fh, [cfg.lx, cfg.v_max])
        self._fh.flush()
        self._pending: tuple | None = None

    def write_snapshot(self, time: float, energies, mode_re, mode_im,
                       electric, rho, ptcl) -> None:
        """energies: diagnostics.Energies; ptcl: diagnostics.PtclDist."""
        with self.timers.phase("output: write"):
            cfg = self.cfg
            scalars = [time, float(energies.field)]
            for s in range(cfg.nspecies):
                scalars += [float(energies.marker[s]), float(energies.total[s]),
                            float(energies.pertb[s])]
            # the bytes are counted from the writes, not by tell(): on a 9p
            # mount in a gVisor sandbox a seek after each record cost about
            # 0.15 ms a snapshot (an H100 host, 6.4M markers)
            n = pb.write_real(self._fh, scalars)
            for vec in (mode_re, mode_im, electric, rho):
                n += pb.write_vec(self._fh, np.asarray(vec))
            for s in range(cfg.nspecies):
                # xv arrays are stored flattened row-major (iv * nx_opd + ix),
                # matching reference indexing (src/pic1dp_output.F90:252-298)
                for xv in (ptcl.markr_xv, ptcl.total_xv, ptcl.pertb_xv):
                    n += pb.write_real(self._fh, np.asarray(xv[s]).reshape(-1))
                for v in (ptcl.markr_v, ptcl.total_v, ptcl.pertb_v):
                    n += pb.write_real(self._fh, np.asarray(v[s]))
            self._fh.flush()
            self.timers.count("bytes written", n)

    def defer_snapshot(self, *record) -> None:
        """Hold a record, write_snapshot's arguments, until write_pending or
        close; a record held before is written first.  Its arrays are the
        writer's from then on: nothing may write to them."""
        self.write_pending()
        self._pending = record

    def write_pending(self) -> bool:
        """Write the record held, if there is one; whether one was written."""
        if self._pending is None:
            return False
        record, self._pending = self._pending, None
        self.write_snapshot(*record)
        return True

    def close(self) -> None:
        if not self._fh.closed:
            try:
                self.write_pending()
            finally:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
