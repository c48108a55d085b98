"""Ion-acoustic wave Landau damping on the port: electrons and heavy ions,
two species (mirrors examples/ion_acoustic.py).

The quasineutral ion-acoustic wave (omega ~ k cs, cs = sqrt(Te/mi)) is
Landau-damped on both species.  Parameters: m_i = 25, T_i/T_e = 0.05,
k = 0.5 -> omega = 0.09843 - 0.00774j (electron omega_pe / lambda_De
units), PHYSICAL (per-species Gaussian) marker loading, seed amplitude 3e-4
(linear).  omega and gamma come from the two-pole fit of mode 1 over
t in [60, 300] and must match the root within 2% and 8%.

Usage:  python -m pic1dp_tpu_torch.examples.ion_acoustic [--device cuda|cpu]
            [--nparticle N] [--time-max T]
Env:    PIC1DP_EX_N (markers per species, default 2^22), PIC1DP_EX_TMAX (320),
        the defaults of the two options.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from pic1dp_tpu_torch.analysis.dispersion import (Dispersion, fit_mode_omega,
                                                  species_for_config)
from pic1dp_tpu_torch.config import Config, Equilibrium, MarkerLoading, SpeciesConfig
from pic1dp_tpu_torch.examples import device_of, parser, run_dtype, simulate

OMEGA_TOLERANCE, GAMMA_TOLERANCE = 0.02, 0.08
GUESSES = [0.098 - 0.008j, 0.118 - 0.010j, 0.078 - 0.006j]
K = 0.5


def config(n: int = 2**22, tmax: float = 320.0, device="cuda") -> Config:
    n = (n + 1023) // 1024 * 1024
    return Config(
        linear=False, deltaf=True, lx=2.0 * math.pi / K,
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=1.0, v0=0.0),
                 SpeciesConfig(charge=1.0, mass=25.0, temperature=0.05,
                               density=1.0, v0=0.0)),
        nx=64, nparticle_max=n, time_max=tmax, dt=0.05,
        marker=MarkerLoading.PHYSICAL, v_max=8.0,
        modes=(1,), init_modes=(1,), init_amp_cos=(0.0,),
        init_amp_sin=(3e-4,), output_interval=1.0, verbosity=1,
        dtype=run_dtype(device)).validate()


def theory(cfg: Config) -> complex:
    d = Dispersion(species_for_config(cfg), K)
    d._guesses = list(GUESSES)
    return d.solve_omega()


def fit_omega(snaps: list[dict], tmax: float) -> complex:
    """omega + i gamma of mode 1 from the two-pole fit over t in
    [60, min(300, tmax)], past the Langmuir-branch ringdown."""
    t = np.array([s["time"] for s in snaps])
    zre = np.stack([s["mode_re"] for s in snaps], axis=1)
    zim = np.stack([s["mode_im"] for s in snaps], axis=1)
    return fit_mode_omega(t, zre[0], zim[0], window=(60.0, min(300.0, tmax)))


def main(argv=None) -> int:
    ap = parser("ion-acoustic Landau damping against kinetic theory")
    ap.add_argument("--nparticle", type=float,
                    default=float(os.environ.get("PIC1DP_EX_N", 2**22)))
    ap.add_argument("--time-max", type=float,
                    default=float(os.environ.get("PIC1DP_EX_TMAX", 320.0)))
    args = ap.parse_args(argv)
    device = device_of(args)

    cfg = config(int(args.nparticle), args.time_max, device)
    om = theory(cfg)
    print(f"kinetic theory: omega = {om.real:.5f}, gamma = {om.imag:.5f}")
    fit = fit_omega(simulate(cfg, device), args.time_max)
    om_err = abs(fit.real - abs(om.real)) / abs(om.real)
    g_err = abs(fit.imag - om.imag) / abs(om.imag)
    print(f"measured:       omega = {fit.real:.5f} ({om_err:.2%}), "
          f"gamma = {fit.imag:.5f} ({g_err:.2%})")
    ok = om_err < OMEGA_TOLERANCE and g_err < GAMMA_TOLERANCE
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
