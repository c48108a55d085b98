"""Plain reference of the nonlinear delta-f electrostatic particle-in-cell
model of pic1dp (PRE 83, 056402; https://github.com/wenjundeng/pic1dp):
marker loading, the RK2 step with the partial-DFT field solve, the energy
diagnostics, the x-v distribution snapshots and the record of pic1dp.out.
Markers are loaded uniformly in v, or drawn from a Maxwellian f0 species by
species (physical loading); the step, the solve and the diagnostics do not
depend on which.

Written from the equations of the Fortran code (src/pic1dp_particle.F90
loading, src/pic1dp_interaction.F90 push and deposit, src/pic1dp_field.F90
solve, src/pic1dp_output.F90 diagnostics), in float64 on whatever device
its tensors are on.  It imports nothing of the program.  `reduce(*t)`
returns the tensors summed over the processes that hold the markers between
them (the identity on one process).

The step, per species of charge q and mass m, hat weights h0 = 1 - f,
h1 = f at the cells j = floor(x nx / lx) and j + 1 (periodic), kept modes
k_m = 2 pi mode_m / lx:

  E(x)   = 2 sum_m [(h0 cos a_m(j) + h1 cos a_m(j+1)) re_m
                    - (h0 sin a_m(j) + h1 sin a_m(j+1)) im_m],
           a_m(j) = 2 pi mode_m j / nx
  proj   : pc_m = sum q w (h0 cos a_m(j) + h1 cos a_m(j+1)), ps_m likewise
           with sin; re_m = -ps_m g_m, im_m = -pc_m g_m, g_m = 1 / (2 pi mode_m)
  substep 1 (dt/2 from x0, v0, w0):  e0 = E(x0), x1 = x0 + dt/2 v0,
           w1 = w0 + dt/2 (p - w0) e0 K(v0) q/m, v1 = v0 + dt/2 e0 q/m,
           modes1 from the projections of w1 at x1
  substep 2 (dt from the same x0, v0, w0): e1 = E(x1; modes1),
           x2 = x0 + dt v1, w2 = w0 + dt (p - w1) e1 K(v1) q/m,
           v2 = v0 + dt e1 q/m, the step's modes from w2 at x2
  K(v)   = -d ln f0 / dv; positions wrap into [0, lx)
  E and rho on the grid: E_j = 2 sum_m (cos a_m(j) re_m - sin a_m(j) im_m),
           rho_j = 2 sum_m (cos a_m(j) pc_m + sin a_m(j) ps_m) / lx

The x-v snapshot histogram deposits (1, p, w) of the live markers with
|v| < v_max at the four hat corners of the (nv_opd, nx_opd) grid.  A marker
on a cell's edge lands by the floor of its coordinate, so the cells and hat
fractions are formed in the markers' own precision (a marker one ulp below
v_max lands a whole cell lower in float32 than in float64); the terms are
summed in float64.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
# markers a block of work holds at once: the float64 temporaries of a block
# stay near 1 GB at 62.5M markers
BLOCK = 1 << 23


class Physics:
    """The parameters of one configuration's "program" section."""

    def __init__(self, program: dict, device):
        if not program.get("deltaf", True) or program.get("linear", False):
            raise NotImplementedError("this reference is nonlinear delta-f only")
        if program.get("shape", 4) != 4:
            raise NotImplementedError("this reference follows the matrix-free shape")
        self.device = torch.device(device)
        self.lx = float(program["lx"])
        self.nx = int(program["nx"])
        self.dt = float(program["dt"])
        self.v_max = float(program["v_max"])
        self.nx_opd = int(program["nx_opd"])
        self.nv_opd = int(program["nv_opd"])
        self.equilibrium = program["equilibrium"]
        if self.equilibrium not in ("bump_on_tail", "maxwellian"):
            raise NotImplementedError(f"equilibrium {self.equilibrium}")
        self.marker = program["marker"]
        if self.marker not in ("uniform", "physical"):
            raise NotImplementedError(f"marker loading {self.marker}")
        if self.marker == "physical" and self.equilibrium != "maxwellian":
            # markers drawn from f0 need a Maxwellian f0, as the reference's
            # input_init requires (src/pic1dp_input.F90:287-300)
            raise ValueError("physical marker loading needs the Maxwellian equilibrium")
        self.modes = [int(m) for m in program["modes"]]
        self.init = list(zip(program["init_modes"], program["init_amp_cos"],
                             program["init_amp_sin"]))
        species = program["species"]
        self.nspecies = len(species)

        def col(key):
            return torch.tensor([[float(s[key])] for s in species], dtype=F64,
                                device=self.device)

        self.charge, self.mass = col("charge"), col("mass")
        self.temperature, self.temperature2 = col("temperature"), col("temperature2")
        self.density, self.v0 = col("density"), col("v0")
        self.q_over_m = self.charge / self.mass
        nm = torch.tensor(self.modes, dtype=F64, device=self.device)
        self.step_angle = (2.0 * math.pi / self.nx) * nm        # a_m(1)
        self.g = 1.0 / (2.0 * math.pi * nm)
        j = torch.arange(self.nx, dtype=F64, device=self.device)
        self.grid_cos = torch.cos(self.step_angle[:, None] * j[None, :])   # (nmode, nx)
        self.grid_sin = torch.sin(self.step_angle[:, None] * j[None, :])

    # ---- equilibrium ----

    def f0(self, v):
        vth2 = self.temperature / self.mass
        core = torch.exp(-v * v / (2.0 * vth2)) / torch.sqrt(2.0 * math.pi * vth2)
        if self.equilibrium == "maxwellian":
            return self.density * torch.exp(-(v - self.v0) ** 2 / (2.0 * vth2)) \
                / torch.sqrt(2.0 * math.pi * vth2)
        vth2b = self.temperature2 / self.mass
        beam = torch.exp(-(v - self.v0) ** 2 / (2.0 * vth2b)) / torch.sqrt(2.0 * math.pi * vth2b)
        return self.density * core + (1.0 - self.density) * beam

    def kern(self, v):
        """-d ln f0 / dv."""
        vth2 = self.temperature / self.mass
        if self.equilibrium == "maxwellian":
            return (v - self.v0) / vth2
        vth2b = self.temperature2 / self.mass
        core = self.density * torch.exp(-v * v / (2.0 * vth2)) / torch.sqrt(vth2)
        beam = (1.0 - self.density) * torch.exp(-(v - self.v0) ** 2 / (2.0 * vth2b)) \
            / torch.sqrt(vth2b)
        return (core * v / vth2 + beam * (v - self.v0) / vth2b) / (core + beam)

    # ---- loading ----

    def load_weights(self, x, v, n_global: int):
        """(p, w) of N = n_global markers a species, x uniform and v by the
        marker loading, in float64 (src/pic1dp_particle.F90:172-237,
        :259-264): p = f0 lx 2 v_max / N for v uniform, p = density lx / N
        for v drawn from f0 (physical); w = sum of the initial perturbation's
        modes times p; and p += w (nonlinear)."""
        x, v = x.to(F64), v.to(F64)
        if self.marker == "physical":
            p = self.density * self.lx / n_global * torch.ones_like(x)
        else:
            p = self.f0(v) * (self.lx * 2.0 * self.v_max / n_global)
        w = torch.zeros_like(x)
        for mode, amp_c, amp_s in self.init:
            theta = (2.0 * math.pi / self.lx) * mode * x
            w = w + amp_c * torch.cos(theta) + amp_s * torch.sin(theta)
        w = w * p
        return p + w, w

    # ---- the step ----

    def wrap(self, x):
        x = torch.remainder(x, self.lx)
        return torch.where(x < self.lx, x, 0.0)

    def _hat_trig(self, x):
        """h0, h1 and (nmode, ...) cos, sin at the two cells of each marker."""
        s = x * (self.nx / self.lx)
        j = torch.floor(s)
        h1 = s - j
        j = j.clamp(0.0, float(self.nx - 1))
        a0 = self.step_angle.view(-1, *([1] * x.dim())) * j
        a1 = a0 + self.step_angle.view(-1, *([1] * x.dim()))
        h0 = 1.0 - h1
        return h0 * torch.cos(a0) + h1 * torch.cos(a1), h0 * torch.sin(a0) + h1 * torch.sin(a1)

    def efield_at(self, x, modes):
        re, im = modes
        c, s = self._hat_trig(x)
        shape = (-1, *([1] * x.dim()))
        return 2.0 * (c * re.view(shape) - s * im.view(shape)).sum(dim=0)

    def _project(self, x, w):
        c, s = self._hat_trig(x)
        val = self.charge * w
        dims = tuple(range(1, c.dim()))
        return (c * val).sum(dim=dims), (s * val).sum(dim=dims)

    def solve(self, proj):
        pc, ps = proj
        return -ps * self.g, -pc * self.g

    def projections(self, x, w, reduce):
        """(pc, ps) of the charge of w at x, summed over every process."""
        pc = torch.zeros(len(self.modes), dtype=F64, device=self.device)
        ps = torch.zeros_like(pc)
        for sl in _blocks(x.shape[-1]):
            c, s = self._project(self.wrap(x[:, sl].to(F64)), w[:, sl].to(F64))
            pc, ps = pc + c, ps + s
        return reduce(pc, ps)

    def step(self, st: dict, modes, reduce):
        """One RK2 step of st's float64 x, v, w (replaced) with p; returns the
        step's modes and projections."""
        x0, v0, w0, p = st["x"], st["v"], st["w"], st["p"]
        dt, qm = self.dt, self.q_over_m
        w1 = torch.empty_like(w0)
        v1 = torch.empty_like(v0)
        pc = torch.zeros(len(self.modes), dtype=F64, device=self.device)
        ps = torch.zeros_like(pc)
        for sl in _blocks(x0.shape[-1]):
            x, v, w = x0[:, sl], v0[:, sl], w0[:, sl]
            e0 = self.efield_at(x, modes)
            w1[:, sl] = w + 0.5 * dt * (p[:, sl] - w) * e0 * self.kern(v) * qm
            v1[:, sl] = v + 0.5 * dt * e0 * qm
            c, s = self._project(self.wrap(x + 0.5 * dt * v), w1[:, sl])
            pc, ps = pc + c, ps + s
        modes1 = self.solve(reduce(pc, ps))
        pc = torch.zeros_like(pc)
        ps = torch.zeros_like(pc)
        x2, v2, w2 = torch.empty_like(x0), torch.empty_like(v0), torch.empty_like(w0)
        for sl in _blocks(x0.shape[-1]):
            x, v, w = x0[:, sl], v0[:, sl], w0[:, sl]
            e1 = self.efield_at(self.wrap(x + 0.5 * dt * v), modes1)
            x2[:, sl] = self.wrap(x + dt * v1[:, sl])
            w2[:, sl] = w + dt * (p[:, sl] - w1[:, sl]) * e1 * self.kern(v1[:, sl]) * qm
            v2[:, sl] = v + dt * e1 * qm
            c, s = self._project(x2[:, sl], w2[:, sl])
            pc, ps = pc + c, ps + s
        st["x"], st["v"], st["w"] = x2, v2, w2
        proj = reduce(pc, ps)
        return self.solve(proj), proj

    def grids(self, modes, proj):
        """(E, rho) on the nx grid."""
        re, im = modes
        pc, ps = proj
        e = 2.0 * (self.grid_cos.T @ re - self.grid_sin.T @ im)
        rho = 2.0 * (self.grid_cos.T @ pc + self.grid_sin.T @ ps) / self.lx
        return e, rho

    # ---- diagnostics ----

    def energies(self, e_grid, v, p, w, live, reduce):
        """([int E^2 dx, then per species sum_live v^2, v^2 p, v^2 w], the
        same with |w|: the scale each is compared on)."""
        ns = self.nspecies
        sums = torch.zeros((4, ns), dtype=F64, device=self.device)
        for sl in _blocks(v.shape[-1]):
            v2 = torch.where(live[:, sl], v[:, sl].to(F64) ** 2, 0.0)
            w64 = w[:, sl].to(F64)
            sums += torch.stack([v2.sum(dim=1), (v2 * p[:, sl].to(F64)).sum(dim=1),
                                 (v2 * w64).sum(dim=1), (v2 * w64.abs()).sum(dim=1)])
        sums, = reduce(sums)
        field = (e_grid ** 2).sum() * (self.lx / self.nx)
        values, scales = [field], [field]
        for s in range(ns):
            values += [sums[0, s], sums[1, s], sums[2, s]]
            scales += [sums[0, s], sums[1, s], sums[3, s]]
        return torch.stack(values), torch.stack(scales)

    def ptcldist(self, x, v, p, w, live, reduce):
        """Per species the normalized (marker, total, perturbed, |perturbed|)
        x-v histograms (4, ns, nv_opd, nx_opd) and their v profiles
        (4, ns, nv_opd), from x and v in their own precision; the fourth, of
        |w|, is the scale the perturbed one is compared on."""
        nxo, nvo = self.nx_opd, self.nv_opd
        raw = torch.zeros((4, self.nspecies, nvo * nxo), dtype=F64, device=self.device)
        for s in range(self.nspecies):
            for sl in _blocks(x.shape[-1]):
                xs, vs = x[s, sl], v[s, sl]
                sx = xs * (nxo / self.lx)
                jx = torch.floor(sx)
                fx = (sx - jx).to(F64)
                jx = jx.long().clamp(0, nxo - 1)
                jx1 = torch.where(jx + 1 >= nxo, 0, jx + 1)
                sv = (vs + self.v_max) * ((nvo - 1) / (2.0 * self.v_max))
                jv = torch.floor(sv)
                fv = (sv - jv).to(F64)
                jv = jv.long().clamp(0, nvo - 2)
                keep = (torch.abs(vs) < self.v_max) & live[s, sl]
                w64 = w[s, sl].to(F64)
                vals = torch.stack([torch.ones_like(fx), p[s, sl].to(F64), w64,
                                    w64.abs()]) * keep
                for b, wgt in ((jv * nxo + jx, (1.0 - fv) * (1.0 - fx)),
                               (jv * nxo + jx1, (1.0 - fv) * fx),
                               ((jv + 1) * nxo + jx, fv * (1.0 - fx)),
                               ((jv + 1) * nxo + jx1, fv * fx)):
                    for k in range(4):
                        raw[k, s].index_add_(0, b, vals[k] * wgt)
        raw, = reduce(raw)
        raw = raw.view(4, self.nspecies, nvo, nxo)
        delx_inv, delv_inv = nxo / self.lx, (nvo - 1) / (2.0 * self.v_max)
        return raw * (delx_inv * delv_inv), raw.sum(dim=3) * delv_inv

    def record(self, time: float, modes, proj, x, v, p, w, live, reduce) -> dict:
        """One snapshot's record of pic1dp.out, as its parts."""
        e_grid, rho = self.grids(modes, proj)
        xv, vprof = self.ptcldist(x, v, p, w, live, reduce)
        energies, scales = self.energies(e_grid, v, p, w, live, reduce)
        return {"time": time, "energies": energies, "energy_scales": scales,
                "mode_re": modes[0], "mode_im": modes[1], "electric": e_grid, "rho": rho,
                "xv": xv, "v": vprof}


def _blocks(n: int):
    for start in range(0, n, BLOCK):
        yield slice(start, min(n, start + BLOCK))
