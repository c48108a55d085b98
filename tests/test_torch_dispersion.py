"""The port's copy of analysis/dispersion.py is pinned to the original:
the same roots for every verification case, the same species
decomposition, the same mode fits and the same command-line output."""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.analysis import dispersion as jdisp
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.analysis import dispersion as tdisp

REPO = Path(__file__).resolve().parent.parent


def _ion_acoustic(m):
    return m.Config(
        lx=2.0 * math.pi / 0.5, equilibrium=m.Equilibrium.MAXWELLIAN,
        species=(m.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0, v0=0.0),
                 m.SpeciesConfig(charge=1.0, mass=25.0, temperature=0.05, density=1.0,
                                 v0=0.0)),
        nx=64, nparticle_max=4096, marker=m.MarkerLoading.PHYSICAL, verbosity=0)


# name -> (config in a config module, k, guesses or None, the root to 1e-4)
ROOTS = {
    "landau": (lambda m: m.landau_damping(), 0.5, None, 1.4157 - 0.1534j),
    "bump_on_tail": (lambda m: m.bump_on_tail_default(), 0.36, None,
                     1.16938 + 0.08383j),
    "two_stream": (lambda m: m.two_stream(), 0.2,
                   [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j], 0.28451j),
    "two_maxwellian_species": (lambda m: dataclasses.replace(
        m.two_stream(), equilibrium=m.Equilibrium.MAXWELLIAN,
        species=(m.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5, v0=3.0),
                 m.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5,
                                 v0=-3.0))),
        0.2, [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j], 0.28451j),
    "ion_acoustic": (_ion_acoustic, 0.5, [0.098 - 0.008j, 0.118 - 0.010j, 0.078 - 0.006j],
                     0.09843 - 0.00774j),
}


def _solve(mod, tmod_cfg, k, guesses):
    d = mod.Dispersion(mod.species_for_config(tmod_cfg), k)
    if guesses:
        d._guesses = list(guesses)
    return d.solve_omega()


@pytest.mark.parametrize("name", list(ROOTS))
def test_roots_equal_the_originals(name):
    make, k, guesses, root = ROOTS[name]
    want = _solve(jdisp, make(jcfg_mod), k, guesses)
    got = _solve(tdisp, make(tcfg_mod), k, guesses)
    assert got == want
    assert abs(got.real - root.real) < 1e-4 and abs(got.imag - root.imag) < 1e-4


@pytest.mark.parametrize("eq", list(tcfg_mod.Equilibrium))
def test_species_for_config_equals_the_original(eq):
    kw = dict(species=(tcfg_mod.SpeciesConfig(temperature2=0.5),
                       tcfg_mod.SpeciesConfig(charge=1.0, mass=4.0, v0=-1.0)))
    tcfg = dataclasses.replace(tcfg_mod.bump_on_tail_default(), equilibrium=eq, **kw)
    jcfg = jcfg_mod.Config.from_dict(tcfg.to_dict())
    if eq == tcfg_mod.Equilibrium.TWO_STREAM1:
        for mod, cfg in ((jdisp, jcfg), (tdisp, tcfg)):
            with pytest.raises(ValueError, match="no Maxwellian decomposition"):
                mod.species_for_config(cfg)
        return
    got = [vars(s) for s in tdisp.species_for_config(tcfg)]
    want = [vars(s) for s in jdisp.species_for_config(jcfg)]
    assert got == want


def test_two_stream1_root_equals_the_original():
    guesses = (0.05 + 0.2j, 0.1 + 0.3j, 0.02 + 0.25j)
    got = tdisp.muller(tdisp.two_stream1_dispfunc(0.5), *guesses)
    assert got == jdisp.muller(jdisp.two_stream1_dispfunc(0.5), *guesses)
    assert abs(got.imag - 0.25925) < 1e-4


@pytest.mark.parametrize("omega", [1.4157 - 0.1534j, 0.28451j, 0.0984 - 0.0077j])
def test_fit_mode_omega_equals_the_original(omega):
    """A standing or purely growing two-pole signal with noise from a seed:
    the copy's fit is the original's, and recovers omega."""
    rng = np.random.default_rng(7)
    t = np.arange(0.0, 20.0, 0.1)
    z = np.exp(-1j * omega * t) + np.exp(1j * np.conj(omega) * t)
    z = z + 1e-6 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))
    got = tdisp.fit_mode_omega(t, z.real, z.imag, window=(2.0, 18.0))
    assert got == jdisp.fit_mode_omega(t, z.real, z.imag, window=(2.0, 18.0))
    assert abs(got.imag - omega.imag) < 1e-3 and abs(got.real - abs(omega.real)) < 1e-3


def test_cli_prints_as_the_original():
    args = ["-1", "1", "1", "1", "0", "-k", "0.5"]
    out = [subprocess.run([sys.executable, "-m", f"{pkg}.analysis.dispersion", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
           for pkg in ("pic1dp_tpu_torch", "pic1dp_tpu")]
    assert out[0].returncode == out[1].returncode == 0, out[0].stderr + out[1].stderr
    assert out[0].stdout == out[1].stdout
    assert "omega = 1.41566-0.153359j" in out[0].stdout
