"""The reference's headline case on the port: the electron bump-on-tail
instability of Phys. Rev. E 83, 056402 (2011) Sec. V.A.2 (mirrors
examples/bump_on_tail_pre83.py; every parameter is the framework's
default).

Runs the linear growth phase, fits the growth rate from int E^2 dx as
tools/runinfo.py does (gamma = energy-fit / 2), and compares it with the
kinetic dispersion relation: omega = 1.1694 + 0.0838i, within 10%.

Usage:  python -m pic1dp_tpu_torch.examples.bump_on_tail_pre83
            [nparticles] [t_end] [--device cuda|cpu]
        (defaults 1_000_000 and 100; the reference default is 6.4e6
        markers to t = 500)
"""

from __future__ import annotations

import sys

import numpy as np

from pic1dp_tpu_torch.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu_torch.config import Config, bump_on_tail_default
from pic1dp_tpu_torch.examples import device_of, parser, simulate

TOLERANCE = 0.10


def config(n: int = 1_000_000, t_end: float = 100.0) -> Config:
    n = (n + 1023) // 1024 * 1024  # the original's capacity rounding
    return bump_on_tail_default(nparticle_max=n, time_max=t_end,
                                output_interval=1.0, verbosity=1)


def theory(cfg: Config) -> complex:
    return Dispersion(species_for_config(cfg), 2.0 * np.pi / cfg.lx).solve_omega()


def fit_gamma(snaps: list[dict], t_end: float) -> float:
    """Half the slope of ln int E^2 dx over the linear-growth window (past
    the initial transient, before saturation at |E|^2 ~ 1e-2)."""
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    lo, hi = 25.0, min(t_end * 0.85, 70.0)
    m = (t >= lo) & (t <= hi) & (e > 0)
    return float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)


def main(argv=None) -> int:
    ap = parser("bump-on-tail instability (PRE 83, 056402) against kinetic theory")
    ap.add_argument("nparticles", nargs="?", type=int, default=1_000_000)
    ap.add_argument("t_end", nargs="?", type=float, default=100.0)
    args = ap.parse_args(argv)
    device = device_of(args)

    cfg = config(args.nparticles, args.t_end)
    omega = theory(cfg)
    print(f"dispersion theory: k = {2.0 * np.pi / cfg.lx:.4f}, omega = {omega:.6g}")
    gamma = fit_gamma(simulate(cfg, device), args.t_end)
    rel = abs(gamma - omega.imag) / omega.imag
    print(f"simulated gamma = {gamma:.5f}  (theory {omega.imag:.5f}, "
          f"rel. err {rel:.2%})")
    return 0 if rel < TOLERANCE else 1


if __name__ == "__main__":
    sys.exit(main())
