"""Kinetic dispersion relation for 1D electrostatic Vlasov-Poisson plasma.

A copy of pic1dp_tpu/analysis/dispersion.py (numpy and scipy only): the
port must not import the JAX package, whose __init__ imports jax.
tests/test_torch_dispersion.py pins its roots, fits and command line to the
original's.  -vis plots through the port's visual_dispersion copy, which
needs matplotlib.

Re-design of reference tools/dispersion.py (Python 2) for Python 3: solves

    D(omega) = 1 + sum_s (n_s Z_s^2 / m_s) / (k^2 vth_s^2) (1 + zeta_s Z(zeta_s)) = 0
    zeta_s = (omega / k - v0_s) / sqrt(2 vth_s^2),   vth_s^2 = T_s / m_s

for complex omega via the plasma dispersion function Z (Faddeeva function,
reference tools/dispersion.py:30-32) and Muller's complex root finder
(:34-59), for any collection of (shifted) Maxwellian species.  A bump-on-tail
or two-stream2 equilibrium is expressed as two Maxwellian species
(`species_for_config`).

Used as the accuracy oracle for growth/damping-rate checks (chip_smoke.py):
gamma_sim = energy-fit/2 must match Im(omega) from here.
"""

from __future__ import annotations

import argparse
import cmath
import math
import warnings
from typing import Callable, Sequence

import numpy as np
from scipy import special


def plasma_z(zeta: complex) -> complex:
    """Plasma dispersion function Z(zeta) = i sqrt(pi) w(zeta)
    (reference tools/dispersion.py:30-32)."""
    return 1j * math.sqrt(math.pi) * special.wofz(zeta)


def muller(func: Callable[[complex], complex], x0: complex, x1: complex,
           x2: complex, functol: float = 1e-14, xtol: float = 1e-14,
           niter_max: int = 100) -> complex:
    """Muller's method complex root finder (reference tools/dispersion.py:34-59)."""
    it = 0
    while abs(func(x2)) > functol and abs(x2 - x1) > xtol and it < niter_max:
        f0, f1, f2 = func(x0), func(x1), func(x2)
        w = (f2 - f1) / (x2 - x1) + (f2 - f0) / (x2 - x0) - (f1 - f0) / (x1 - x0)
        d = cmath.sqrt(w * w - 4.0 * f2 * (((f2 - f1) / (x2 - x1)
                                            - (f1 - f0) / (x1 - x0)) / (x2 - x0) + 0j))
        denom = w + d if abs(w + d) > abs(w - d) else w - d
        x0, x1 = x1, x2
        x2 = x1 - 2.0 * func(x1) / denom
        it += 1
    return x2


class Species:
    def __init__(self, charge: float, mass: float, temperature: float,
                 density: float, v0: float):
        self.charge = charge
        self.mass = mass
        self.temperature = temperature
        self.density = density
        self.v0 = v0


class Dispersion:
    """D(omega; k) for a set of shifted-Maxwellian species
    (reference tools/dispersion.py:62-157)."""

    def __init__(self, species: Sequence[Species], k: float):
        self.species = list(species)
        self.k = k
        self._guesses = [0.4739 + 0.153j, 1.793 + 0.491j, 0.9371 + 0.287j]
        self._omega: complex | None = None

    @classmethod
    def from_params(cls, params: Sequence[float], k: float) -> "Dispersion":
        """Flat [Z, m, T, n, v0] * nspecies parameter list, the reference's
        CLI convention (tools/dispersion.py:77-103)."""
        if len(params) % 5:
            raise ValueError("need 5 parameters (Z, m, T, n, v0) per species")
        sp = [Species(*params[i:i + 5]) for i in range(0, len(params), 5)]
        return cls(sp, k)

    def set_k(self, k: float) -> None:
        if k != self.k:
            self.k = k
            self._omega = None

    def append_guess(self, guesses) -> None:
        for g in guesses:
            if g not in self._guesses[-1:]:
                self._guesses = self._guesses[1:] + [g]

    def dispfunc(self, omega: complex) -> complex:
        d = 1.0 + 0j
        for s in self.species:
            vth2 = s.temperature / s.mass
            zeta = (omega / self.k - s.v0) / math.sqrt(2.0 * vth2)
            d += (s.density * s.charge**2 / s.mass) / (self.k**2 * vth2) \
                * (1.0 + zeta * plasma_z(zeta))
        return d

    def solve_omega(self) -> complex:
        if self._omega is None:
            self._omega = muller(self.dispfunc, *self._guesses)
            self.append_guess([self._omega])
        return self._omega

    def scan_k(self, k_values: Sequence[float]) -> np.ndarray:
        """omega(k) scan with guess continuation (reference :266-299)."""
        out = np.zeros(len(k_values), dtype=complex)
        for i, k in enumerate(k_values):
            self.set_k(k)
            out[i] = self.solve_omega()
        return out

    def mode_structure(self, ispecies: int | None = None, v_max: float = 8.0,
                       nx: int = 64, nv: int = 64):
        """delta-f mode structure on the (x, v) plane for the solved omega
        (reference tools/dispersion.py:159-206).  ispecies None => sum."""
        omega = self.solve_omega()
        x = (2.0 * np.pi / self.k) / nx * np.arange(nx + 1)
        v = (2.0 * v_max) / (nv - 1) * np.arange(nv) - v_max
        ms = np.zeros((nv, nx + 1))
        spl = self.species if ispecies is None else [self.species[ispecies]]
        for iv, vv in enumerate(v):
            f_s = 0.0
            for s in spl:
                vth2 = s.temperature / s.mass
                amp = s.charge / s.temperature * (vv - s.v0) \
                    / math.sqrt(2.0 * math.pi * vth2) \
                    * math.exp(-(vv - s.v0) ** 2 / (2.0 * vth2))
                if ispecies is None:
                    amp *= s.density
                f_s += amp
            harm = 1j / (omega - self.k * vv) * np.exp(1j * self.k * x[:nx])
            ms[iv, :nx] = f_s * harm.real * 2.0
        ms[:, nx] = ms[:, 0]
        return x, v, ms


def structure_correlation(output_data, itime: int, mode: int,
                          dispersion: "Dispersion",
                          ispecies: int = 0) -> float:
    """Quantitative delta-f mode-structure comparison (the reference's
    mode-structure plot, tools/dispersion.py:159-206, turned into a metric).

    Extracts the x-Fourier component `mode` of the simulated perturbed
    distribution delta f(x, v) at snapshot `itime` and returns its
    phase/amplitude-free complex correlation with the analytic eigenmode
    structure g(v) = sum_s f'_s(v) * i / (omega - k v):

        corr = |<delta f_k, g>| / (||delta f_k|| ||g||)  in [0, 1]

    (1 = the simulated perturbation IS the theory eigenmode up to a complex
    constant; arbitrary phase/amplitude are projected out by construction).
    `dispersion` must be built at k = 2 pi mode / lx with the species
    decomposition of the run's equilibrium (species_for_config)."""
    om = dispersion.solve_omega()
    k = dispersion.k
    xv = output_data.get_ptcldist_xv(itime, ispecies, 2, periodicbound=False)
    sim_k = np.fft.rfft(xv, axis=1)[:, mode]        # complex (nv_pd,)
    v = output_data.v_pd
    g = np.zeros(len(v), complex)
    for s in dispersion.species:
        vth2 = s.temperature / s.mass
        fprime = (s.density * s.charge / s.temperature * (v - s.v0)
                  / math.sqrt(2.0 * math.pi * vth2)
                  * np.exp(-(v - s.v0) ** 2 / (2.0 * vth2)))
        g += fprime * 1j / (om - k * v)
    denom = np.linalg.norm(sim_k) * np.linalg.norm(g)
    if denom == 0.0:
        return 0.0
    return float(abs(np.vdot(sim_k, g)) / denom)


def fit_mode_omega(t, mode_re, mode_im, window=None):
    """Complex eigenfrequency from a kept-mode amplitude time series.

    The simulated initial perturbation is a STANDING wave = equal parts of
    the +omega and -omega Landau roots (same gamma), so the complex mode
    signal z(t) = A e^{-i omega t} + B e^{+i omega t}, both x e^{gamma t} —
    a log-linear fit of z (or of energy peaks, the runinfo.py method) is
    biased by the beat structure / peak-selection jitter.  This fits the
    exact two-pole model by linear prediction (least-squares Prony):

        z_{k+2} = c1 z_{k+1} + c0 z_k,   roots s, s* of u^2 - c1 u - c0
        gamma = ln|s| / dt_s,   omega_r = |arg s| / dt_s

    using EVERY sample in the window — measured on the k=0.5 Landau case
    this cuts the gamma error from ~1.3% (peaks fit, a transient +
    peak-jitter bias that does NOT shrink with marker count) to the
    sampling-noise level (~0.1-0.9% at 2^22 markers, window (5, 15)).

    t: (nt,) UNIFORM sample times; mode_re/mode_im: (nt,) series of one
    mode (e.g. snapshot["mode_re"][m]); window: (t_lo, t_hi) — choose it
    past the ballistic/higher-root transient (a few k*v_t phase-mixing
    times) and above the marker-noise floor.  Returns complex
    omega = omega_r + i gamma (gamma < 0 = damped)."""
    t = np.asarray(t, float)
    z = np.asarray(mode_re, np.float64) + 1j * np.asarray(mode_im, np.float64)
    if window is not None:
        m = (t >= window[0]) & (t <= window[1])
        t, z = t[m], z[m]
    if len(z) < 4:
        raise ValueError("fit_mode_omega needs >= 4 samples in the window")
    if not np.allclose(np.diff(t), t[1] - t[0], rtol=1e-6, atol=0.0):
        raise ValueError("fit_mode_omega requires uniform sample times")
    dt_s = t[1] - t[0]
    # total-least-squares linear prediction: ordinary LS on z_{k+2} =
    # c1 z_{k+1} + c0 z_k is biased by noise in the REGRESSORS (errors in
    # variables; measured 15x worse gamma on a synthetic noisy two-pole
    # signal); the smallest singular vector of the Hankel matrix treats
    # all three columns symmetrically.
    #
    # The prediction coefficients are constrained REAL: every physical
    # two-pole model here has them — the standing Landau pair
    # {e^{(+-i omega + gamma) dt}} gives c1 = 2 cos(omega dt) e^{gamma dt},
    # c0 = -e^{2 gamma dt}, and the non-propagating pair {e^{+-gamma dt}}
    # gives real c too.  An unconstrained complex null vector is a strictly
    # weaker model: for a purely growing mode the signal is nearly real and
    # its small imaginary part is sampling noise, which the complex TLS
    # "explains" with spurious complex roots (measured on the multimode
    # two-stream series: gamma 0.498 vs theory 0.237 with a fake
    # omega_r = 0.42; the real-constrained fit recovers the local slope).
    # Stacking Re and Im rows imposes the constraint exactly.
    m3 = np.stack([z[2:], z[1:-1], z[:-2]], axis=1)
    m3r = np.concatenate([m3.real, m3.imag], axis=0)
    sv, vh = np.linalg.svd(m3r)[1:]
    v = vh[-1]
    if abs(v[0]) < 1e-12 * np.linalg.norm(v):
        # leading prediction coefficient ~0: the signal has < 2 resolvable
        # poles at lag 2 (degenerate quadratic) — refuse rather than divide
        raise ValueError("fit_mode_omega: degenerate two-pole fit "
                         "(leading linear-prediction coefficient ~ 0)")
    if sv[-2] < 1e-10 * sv[0]:
        # NUMERICALLY rank-1 Hankel (an exactly single-pole signal, e.g. a
        # noiseless synthetic exponential): the null space is 2-dimensional,
        # the second root is arbitrary and would corrupt the conjugate-pair
        # average — fall back to the dominant single pole.  The test is
        # against sigma1 at machine precision, NOT against sigma3: on real
        # data sigma3 is the noise floor and a genuine weak second branch
        # (e.g. the decaying e^{-gamma t} partner of a marginally unstable
        # mode) routinely sits below any sigma3-relative threshold — a
        # sigma2 < 10*sigma3 trigger replaced good two-pole fits with a
        # single-pole LS that is meaningless on two-branch signals
        # (measured: multimode m4 gamma -0.015 vs theory +0.067).
        warnings.warn("fit_mode_omega: numerically rank-1 signal "
                      f"(sigma2/sigma1 = {sv[-2] / sv[0]:.2e}); "
                      "using the dominant root only", stacklevel=2)
        a = np.linalg.lstsq(z[:-1, None], z[1:], rcond=None)[0][0]
        return abs(np.angle(a)) / dt_s + 1j * (math.log(abs(a)) / dt_s)
    if sv[-2] < 3.0 * sv[-1]:
        # sigma2 barely above the noise floor sigma3: the second pole is
        # noise-determined, not resolved — the two-pole fit still beats the
        # single-pole LS on two-branch signals (see the rank-1 note above),
        # but the caller should know the second root carries no information
        # (a damped non-propagating signal can latch its "dominant root"
        # onto a larger-modulus noise root).  Warn, don't fall back.
        warnings.warn("fit_mode_omega: second pole is at the noise floor "
                      f"(sigma2/sigma3 = {sv[-2] / sv[-1]:.2f} < 3); the "
                      "secondary root is noise-determined — treat the "
                      "returned omega as effectively single-pole",
                      stacklevel=2)
    roots = np.roots(v / v[0])
    if len(roots) != 2:
        raise ValueError(f"fit_mode_omega: expected 2 roots, got {len(roots)}")
    mods = np.abs(roots)
    angs = np.angle(roots)
    mod_split = abs(float(np.log(mods[0]) - np.log(mods[1])))
    if float(np.min(np.abs(angs))) > mod_split and angs[0] * angs[1] < 0:
        # conjugate pair (propagating wave: omega_r dt dominates any noise
        # split of the moduli, phases have opposite signs): both roots
        # share modulus e^{gamma dt} — average the symmetric quantities
        # instead of picking one root
        gamma = float(np.mean(np.log(mods))) / dt_s
        omega_r = float(np.mean(np.abs(angs))) / dt_s
    else:
        # non-propagating instability (e.g. two-stream inside the unstable
        # band: omega_r = 0): the poles are e^{+gamma dt} and e^{-gamma dt}
        # — distinct moduli, so averaging would cancel gamma to 0; the
        # physical growing branch is the DOMINANT root
        s = roots[np.argmax(mods)]
        gamma = math.log(abs(s)) / dt_s
        omega_r = abs(np.angle(s)) / dt_s
    return omega_r + 1j * gamma


def two_stream1_dispfunc(k: float) -> Callable[[complex], complex]:
    """D(omega) for the two_stream1 equilibrium f0 = v^2 e^(-v^2/2)/sqrt(2 pi)
    (reference src/pic1dp_input.F90:51), which is NOT a Maxwellian mixture.

    Uses the moment recurrence J_n = integral v^n M/(v - c) dv with
    J_0 = Z(c/sqrt(2))/sqrt(2) and J_n = c J_{n-1} + m_{n-1}
    (m_n the Maxwellian moments 1, 0, 1, 0, ...), giving
    integral f0'/(v - c) dv = 2 J_1 - J_3 and D = 1 - (2 J_1 - J_3)/k^2.
    The unstable root is purely growing (Re omega = 0): e.g.
    omega(k=0.5) = 0.25925i."""

    def dispfunc(omega: complex) -> complex:
        c = omega / k
        j0 = plasma_z(c / math.sqrt(2.0)) / math.sqrt(2.0)
        j1 = c * j0 + 1.0
        j3 = c * (c * j1) + 1.0
        return 1.0 - (2.0 * j1 - j3) / k**2

    return dispfunc


def species_for_config(cfg) -> list[Species]:
    """Maxwellian-equivalent species list for a Config, for comparing
    simulated growth rates against kinetic theory.  bump-on-tail and
    two-stream2 decompose into two Maxwellian components; two-stream1 has no
    shifted-Maxwellian representation (raises)."""
    from pic1dp_tpu_torch.config import Equilibrium

    out = []
    for s in cfg.species:
        if cfg.equilibrium == Equilibrium.MAXWELLIAN:
            out.append(Species(s.charge, s.mass, s.temperature, s.density, s.v0))
        elif cfg.equilibrium == Equilibrium.BUMP_ON_TAIL:
            out.append(Species(s.charge, s.mass, s.temperature, s.density, 0.0))
            out.append(Species(s.charge, s.mass, s.temperature2,
                               1.0 - s.density, s.v0))
        elif cfg.equilibrium == Equilibrium.TWO_STREAM2:
            out.append(Species(s.charge, s.mass, s.temperature,
                               0.5 * s.density, -s.v0))
            out.append(Species(s.charge, s.mass, s.temperature,
                               0.5 * s.density, s.v0))
        else:
            raise ValueError(f"no Maxwellian decomposition for {cfg.equilibrium}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Solve the kinetic dispersion relation of a 1D "
        "electrostatic Vlasov-Poisson plasma of (shifted) Maxwellian species")
    parser.add_argument("params", nargs="*", type=float,
                        help="per species: charge Z, mass m, temperature T, "
                        "density n, flow v0")
    parser.add_argument("-ig", nargs="+", type=complex, metavar="<guess>",
                        help="up to three initial guesses")
    parser.add_argument("-k", nargs="+", type=float, default=[0.5],
                        help="one k, or [start stop] range, or "
                        "[first start stop]")
    parser.add_argument("-sks", type=float, default=0.005,
                        help="k scan step (default 0.005)")
    parser.add_argument("-sms", action="store_true",
                        help="save mode structure to file")
    parser.add_argument("-vis", action="store_true",
                        help="plot omega(k) and mode structure")
    args = parser.parse_args(argv)

    if len(args.params) < 5:
        parser.error("need at least one species (5 parameters)")
    disp = Dispersion.from_params(args.params, args.k[0])
    if args.ig:
        disp.append_guess(args.ig)
    omega = disp.solve_omega()

    def report(k, om):
        vres = om.real / k
        pct = om.imag / om.real * 100.0 if om.real else float("nan")
        print(f"k = {k:.6g}: omega = {om:.6g} (gamma/omega_r = {pct:.3f} %)"
              f" : v_res = {vres:.6g}")

    report(disp.k, omega)
    karr, oarr = [disp.k], [omega]
    if len(args.k) >= 2:
        lo, hi = (args.k[0], args.k[1]) if len(args.k) == 2 else (args.k[1], args.k[2])
        karr = list(np.arange(lo, hi + args.sks, args.sks))
        oarr = disp.scan_k(karr)
        for k, om in zip(karr, oarr):
            report(k, om)
    if args.sms:
        disp.set_k(args.k[0])
        x, v, ms = disp.mode_structure()
        np.savetxt("x_disp.dat", x)
        np.savetxt("v_disp.dat", v)
        np.savetxt("ptcldist_xv_disp.dat", ms)
    if args.vis:
        from pic1dp_tpu_torch.analysis.visual_dispersion import show_dispersion
        show_dispersion(disp, karr, oarr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
