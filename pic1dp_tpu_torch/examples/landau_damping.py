"""Linear Landau damping verification case on the port (mirrors
examples/landau_damping.py): a k = 0.5 Maxwellian plasma; the
field-amplitude damping rate must match the kinetic dispersion root
omega = 1.4157 - 0.1534i within 5%.

Usage:  python -m pic1dp_tpu_torch.examples.landau_damping [--device cuda|cpu]
            [--nparticle N] [--time-max T]
        (defaults 102,400 markers to t = 20, as the original)
"""

from __future__ import annotations

import sys

import numpy as np

from pic1dp_tpu_torch.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu_torch.config import Config, landau_damping
from pic1dp_tpu_torch.examples import device_of, parser, simulate

TOLERANCE = 0.05


def config(nparticle: int = 102_400, time_max: float = 20.0) -> Config:
    return landau_damping(nx=64, nparticle=nparticle, k=0.5, amp=1e-4,
                          time_max=time_max, output_interval=0.1, verbosity=1)


def theory(cfg: Config) -> complex:
    return Dispersion(species_for_config(cfg), 0.5).solve_omega()


def fit_gamma(snaps: list[dict], window: tuple[float, float] = (1.0, 15.0)) -> float:
    """Half the slope of ln int E^2 dx through the oscillation peaks of the
    damped field energy inside window."""
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    pk = [i for i in range(1, len(e) - 1)
          if e[i] > e[i - 1] and e[i] > e[i + 1] and window[0] <= t[i] <= window[1]]
    return float(np.polyfit(t[pk], np.log(e[pk]), 1)[0] / 2.0)


def main(argv=None) -> int:
    ap = parser("Landau damping against kinetic theory")
    ap.add_argument("--nparticle", type=int, default=102_400)
    ap.add_argument("--time-max", type=float, default=20.0)
    args = ap.parse_args(argv)
    device = device_of(args)

    cfg = config(args.nparticle, args.time_max)
    omega = theory(cfg)
    print(f"dispersion theory: omega = {omega:.6g}")
    gamma = fit_gamma(simulate(cfg, device))
    rel = abs(gamma - omega.imag) / abs(omega.imag)
    print(f"simulated gamma = {gamma:.5f}  (theory {omega.imag:.5f}, "
          f"rel. err {rel:.2%})")
    return 0 if rel < TOLERANCE else 1


if __name__ == "__main__":
    sys.exit(main())
