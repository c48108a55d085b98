"""Reader + analysis accessors for the `pic1dp.out` science-data stream.

A copy of pic1dp_tpu/analysis/output_data.py that reads through the port's
petsc_binary copy: the port must not import the JAX package, whose __init__
imports jax.  tests/test_torch_analysis.py pins its arrays to the original's.

Python-3 re-design of the reference's tools/OutputData.py (the record layout
it parses is documented there at :28-79 and in io/writer.py).  Reads files
written by pic1dp_tpu_torch.io.writer.SnapshotWriter *or* by the reference's
Fortran code — the byte stream is identical.

Accessor API (kept compatible with reference tools/OutputData.py:84-180 so
downstream tooling ports 1:1):

    get_scalar_t()                  ((nspecies+1)*3 + 2, ntime) scalars vs t:
                                    rows [time, field energy,
                                          (marker, total, pertb) per species,
                                          (marker, total, pertb) summed]
    get_mode_t()                    (2*nmode, ntime) mode Re rows then Im rows
    get_field_x(itime)              (2, nx+1): E(x), rho(x), periodic closure
    get_ptcldist_xv(itime, ispecies, iptcldist, periodicbound=True)
    get_ptcldist_v(itime, ispecies, iptcldist)
                                    iptcldist: 0 marker g, 1 total f,
                                    2 perturbed delta f; ispecies ==
                                    nspecies -> summed over species
    growthrate_energy_fit(t1, t2)   least-squares d ln(int E^2 dx)/dt
    findpeak_energy(t1, t2)         [t_peak, energy_peak]
"""

from __future__ import annotations

import os

import numpy as np

from pic1dp_tpu_torch.io import petsc_binary as pb


class OutputData:
    """Parsed pic1dp output stream (fully loaded into memory)."""

    def __init__(self, datapath: str, filename: str = "pic1dp.out",
                 verbose: bool = False):
        path = datapath
        if os.path.isdir(datapath):
            path = os.path.join(datapath, filename)
        with open(path, "rb") as fh:
            (self.nspecies, self.nmode, self.nx, self.nv,
             self.nx_pd, self.nv_pd) = (int(i) for i in pb.read_int(fh, 6))
            self.mode = pb.read_int(fh, self.nmode)
            self.lx, self.v_max = pb.read_real(fh, 2)

            # axes (periodic x axes get a closure point)
            self.x = np.arange(self.nx + 1.0) / self.nx * self.lx
            self.x_pd = np.arange(self.nx_pd + 1.0) / self.nx_pd * self.lx
            self.v_pd = (np.arange(float(self.nv_pd)) / (self.nv_pd - 1)
                         - 0.5) * 2.0 * self.v_max
            self.xv_pd = np.meshgrid(self.x_pd, self.v_pd)

            self._snapshots = []
            nsc = self.nspecies * 3 + 2
            nxv = self.nx_pd * self.nv_pd
            while True:
                try:
                    scalars = pb.read_real(fh, nsc)
                except EOFError:
                    break
                try:
                    snap = {
                        "scalars": scalars,
                        "mode_re": pb.read_vec(fh),
                        "mode_im": pb.read_vec(fh),
                        "electric": pb.read_vec(fh),
                        "rho": pb.read_vec(fh),
                        "dist_xv": [],  # per species: [marker, total, pertb]
                        "dist_v": [],
                    }
                    for _ in range(self.nspecies):
                        snap["dist_xv"].append(
                            [pb.read_real(fh, nxv) for _ in range(3)])
                        snap["dist_v"].append(
                            [pb.read_real(fh, self.nv_pd) for _ in range(3)])
                except EOFError:
                    break  # truncated (in-progress) final snapshot
                self._snapshots.append(snap)

        self.ntime = len(self._snapshots)
        if verbose:
            print(f"# of time steps read: {self.ntime}")

    # ---- accessors (reference tools/OutputData.py:84-151) ----

    def get_scalar_t(self) -> np.ndarray:
        ns = self.nspecies
        out = np.zeros(((ns + 1) * 3 + 2, self.ntime))
        for it, snap in enumerate(self._snapshots):
            out[: ns * 3 + 2, it] = snap["scalars"]
            for s in range(ns):
                out[ns * 3 + 2, it] += snap["scalars"][s * 3 + 2]
                out[ns * 3 + 3, it] += snap["scalars"][s * 3 + 3]
                out[ns * 3 + 4, it] += snap["scalars"][s * 3 + 4]
        return out

    def get_mode_t(self) -> np.ndarray:
        out = np.zeros((self.nmode * 2, self.ntime))
        for it, snap in enumerate(self._snapshots):
            out[: self.nmode, it] = snap["mode_re"]
            out[self.nmode:, it] = snap["mode_im"]
        return out

    def get_field_x(self, itime: int) -> np.ndarray:
        out = np.zeros((2, self.nx + 1))
        snap = self._snapshots[itime]
        out[0, : self.nx] = snap["electric"]
        out[1, : self.nx] = snap["rho"]
        out[:, self.nx] = out[:, 0]
        return out

    def get_ptcldist_xv(self, itime: int, ispecies: int, iptcldist: int,
                        periodicbound: bool = True) -> np.ndarray:
        snap = self._snapshots[itime]
        nxp = self.nx_pd + (1 if periodicbound else 0)
        out = np.zeros((self.nv_pd, nxp))
        if ispecies < self.nspecies:
            raw = snap["dist_xv"][ispecies][iptcldist]
            out[:, : self.nx_pd] = raw.reshape(self.nv_pd, self.nx_pd)
        else:
            for s in range(self.nspecies):
                out[:, : self.nx_pd] += snap["dist_xv"][s][iptcldist].reshape(
                    self.nv_pd, self.nx_pd)
        if periodicbound:
            out[:, self.nx_pd] = out[:, 0]
        return out

    def get_ptcldist_v(self, itime: int, ispecies: int, iptcldist: int) -> np.ndarray:
        snap = self._snapshots[itime]
        if ispecies < self.nspecies:
            return snap["dist_v"][ispecies][iptcldist].copy()
        out = np.zeros(self.nv_pd)
        for s in range(self.nspecies):
            out += snap["dist_v"][s][iptcldist]
        return out

    # ---- analysis (reference tools/OutputData.py:153-180) ----

    def _window(self, time1: float, time2: float):
        scalar_t = self.get_scalar_t()
        i1 = max(int(np.searchsorted(scalar_t[0], time1)) - 1, 0)
        i2 = int(np.searchsorted(scalar_t[0], time2))
        return scalar_t[0, i1:i2], scalar_t[1, i1:i2]

    def growthrate_energy_fit(self, time1: float, time2: float) -> float:
        """Least-squares slope of ln(int E^2 dx) over [time1, time2]; the
        field-amplitude growth rate is half of this."""
        t, energy = self._window(time1, time2)
        return float(np.polyfit(t, np.log(energy), 1)[0])

    def findpeak_energy(self, time1: float, time2: float) -> list[float]:
        t, energy = self._window(time1, time2)
        ipk = int(np.argmax(energy))
        return [float(t[ipk]), float(energy[ipk])]
