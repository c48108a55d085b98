"""Read records of pic1dp.out, the program's snapshot stream, with numpy
alone (the reference's format, src/pic1dp_output.F90: big-endian int32
header, float64 reals, each Vec as its class id, its length and float64
values).

  header   ints [nspecies, nmode, nx, nv, nx_opd, nv_opd, modes...]
           reals [lx, v_max]
  record   reals [time, int E^2 dx, per species (marker, total, pertb)]
           Vec mode_re, Vec mode_im, Vec electric, Vec rho
           per species 3 x (nv_opd nx_opd) reals, 3 x nv_opd reals
"""

from __future__ import annotations

import os

import numpy as np

VEC_CLASSID = 1211214


class OutFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            head = np.fromfile(fh, dtype=">i4", count=6)
            if head.size < 6:
                raise ValueError(f"{path}: no header")
            ns, nmode, nx, nv, nxo, nvo = (int(a) for a in head)
            self.modes = np.fromfile(fh, dtype=">i4", count=nmode).astype(int).tolist()
            self.lx, self.v_max = np.fromfile(fh, dtype=">f8", count=2).tolist()
        self.nspecies, self.nmode, self.nx, self.nv = ns, nmode, nx, nv
        self.nx_opd, self.nv_opd = nxo, nvo
        self.header_bytes = 4 * (6 + nmode) + 8 * 2
        self._scalars = 2 + 3 * ns
        vec = lambda n: 8 + 8 * n  # noqa: E731
        self.record_bytes = (8 * self._scalars + 2 * vec(nmode) + 2 * vec(nx)
                             + ns * 8 * (3 * nxo * nvo + 3 * nvo))

    def count(self) -> int:
        """Whole records in the file."""
        return (os.path.getsize(self.path) - self.header_bytes) // self.record_bytes

    def time(self, j: int) -> float:
        """The time of record j."""
        if not 0 <= j < self.count():
            raise IndexError(f"{self.path} has {self.count()} records, not {j + 1}")
        with open(self.path, "rb") as fh:
            fh.seek(self.header_bytes + j * self.record_bytes)
            return float(np.frombuffer(fh.read(8), dtype=">f8")[0])

    def read(self, j: int) -> dict:
        """Record j (0 is the snapshot at t = 0)."""
        if not 0 <= j < self.count():
            raise IndexError(f"{self.path} has {self.count()} records, not {j + 1}")
        with open(self.path, "rb") as fh:
            fh.seek(self.header_bytes + j * self.record_bytes)
            raw = fh.read(self.record_bytes)
        pos = 0

        def reals(n):
            nonlocal pos
            out = np.frombuffer(raw, dtype=">f8", count=n, offset=pos).astype(np.float64)
            pos += 8 * n
            return out

        def vec(n):
            nonlocal pos
            cid, length = np.frombuffer(raw, dtype=">i4", count=2, offset=pos)
            pos += 8
            if cid != VEC_CLASSID or length != n:
                raise ValueError(f"{self.path} record {j}: Vec ({cid}, {length})")
            return reals(n)

        scalars = reals(self._scalars)
        rec = {"time": float(scalars[0]), "energies": scalars[1:],
               "mode_re": vec(self.nmode), "mode_im": vec(self.nmode),
               "electric": vec(self.nx), "rho": vec(self.nx)}
        nxo, nvo, ns = self.nx_opd, self.nv_opd, self.nspecies
        xv = np.empty((3, ns, nvo, nxo))
        vp = np.empty((3, ns, nvo))
        for s in range(ns):
            for k in range(3):
                xv[k, s] = reals(nvo * nxo).reshape(nvo, nxo)
            for k in range(3):
                vp[k, s] = reals(nvo)
        rec["xv"], rec["v"] = xv, vp
        return rec
