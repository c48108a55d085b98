"""Nonlinear two-stream instability to saturation on the port (mirrors
examples/two_stream.py: 256 cells, 1e6 markers, k = 0.2, counter-streaming
Maxwellians at +/-3 vth).

Checks, as the original does:
  1. growth rate gamma = d ln(int E^2 dx)/dt / 2 over t in [15, 35] against
     the kinetic dispersion root, within 8%,
  2. saturation: the field-energy peak after the linear phase, before the
     run's end less 2,
  3. total-energy conservation (KE/2 + int E^2 dx / 2) within 2e-3 of the
     kinetic energy.

Usage:  python -m pic1dp_tpu_torch.examples.two_stream [--device cuda|cpu]
            [--nparticle N] [--time-max T]
Env:    PIC1DP_EX_N (markers, default 1e6), PIC1DP_EX_TMAX (default 80), the
        defaults of the two options.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from pic1dp_tpu_torch.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.config import two_stream as two_stream_config
from pic1dp_tpu_torch.examples import device_of, parser, run_dtype, simulate

TOLERANCE, DRIFT_LIMIT = 0.08, 2e-3
GUESSES = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]


def config(n: int = 1_000_000, tmax: float = 80.0, device="cuda") -> Config:
    n = (n + 1023) // 1024 * 1024  # the original's capacity rounding
    return two_stream_config(nparticle=n, time_max=tmax, dtype=run_dtype(device),
                             output_interval=0.5, verbosity=1)


def theory(cfg: Config) -> complex:
    disp = Dispersion(species_for_config(cfg), 0.2)
    disp._guesses = list(GUESSES)
    return disp.solve_omega()


def fit_gamma(snaps: list[dict], window: tuple[float, float] = (15.0, 35.0)) -> float:
    """Half the slope of ln int E^2 dx over window."""
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    m = (t >= window[0]) & (t <= window[1])
    return float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)


def saturation(snaps: list[dict]) -> tuple[float, float, float]:
    """(t, int E^2 dx) at the first local maximum after t = 35
    (findpeak_energy semantics, reference tools/OutputData.py:172-180), and
    the largest total-energy drift as a fraction of the kinetic energy."""
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    ipk = next((i for i in range(1, len(e) - 1)
                if t[i] > 35.0 and e[i] >= e[i - 1] and e[i] > e[i + 1]),
               int(np.argmax(e)))
    ke = np.array([float(np.sum(s["total"])) for s in snaps])
    etot = 0.5 * ke + 0.5 * e
    return float(t[ipk]), float(e[ipk]), float(np.max(np.abs(etot - etot[0])) / ke[0])


def main(argv=None) -> int:
    ap = parser("two-stream instability to saturation against kinetic theory")
    ap.add_argument("--nparticle", type=float,
                    default=float(os.environ.get("PIC1DP_EX_N", 1_000_000)))
    ap.add_argument("--time-max", type=float,
                    default=float(os.environ.get("PIC1DP_EX_TMAX", 80.0)))
    args = ap.parse_args(argv)
    device = device_of(args)

    cfg = config(int(args.nparticle), args.time_max, device)
    omega = theory(cfg)
    print(f"dispersion theory: omega = {omega:.6g}")
    snaps = simulate(cfg, device)
    gamma = fit_gamma(snaps)
    rel = abs(gamma - omega.imag) / omega.imag
    print(f"simulated gamma = {gamma:.5f}  (theory {omega.imag:.5f}, "
          f"rel. err {rel:.2%})")
    t_pk, e_pk, drift = saturation(snaps)
    print(f"saturation: int E^2 dx peaks at {e_pk:.4g} (t = {t_pk:.1f})")
    print(f"total-energy drift: {drift:.2e} of the kinetic energy")
    ok = rel < TOLERANCE and t_pk < args.time_max - 2.0 and drift < DRIFT_LIMIT
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
