"""The port's ops against the JAX package's, in float64 at 1e-12 relative to
max: interpolation, the four equilibria, the spectral solve (with the
convention cases of tests/test_ops.py) and the snapshot diagnostics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host, to_port

from pic1dp_tpu import distributions as jdist
from pic1dp_tpu.config import Config as JConfig
from pic1dp_tpu.config import Equilibrium as JEquilibrium
from pic1dp_tpu.config import SpeciesConfig as JSpeciesConfig
from pic1dp_tpu.config import landau_damping as jax_landau
from pic1dp_tpu.core import diagnostics as jdiag
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.ops import interp as jinterp
from pic1dp_tpu.ops import spectral as jspec
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.config import Config, Equilibrium, SpeciesConfig, landau_damping
from pic1dp_tpu_torch.core import diagnostics as tdiag
from pic1dp_tpu_torch.ops import interp as tinterp
from pic1dp_tpu_torch.ops import spectral as tspec

LX = 2.0 * np.pi / 0.36
NX = 192
RNG = np.random.default_rng(20)


def _x(n=4096, lo=0.0, hi=LX):
    return RNG.uniform(lo, hi, n)


def test_wrap_x_matches_jnp_mod():
    """jnp.mod takes the divisor's sign; torch.remainder must too."""
    x = np.concatenate([_x(2000, -2 * LX, 3 * LX),
                        [-0.1, 0.0, LX - 1e-9, LX, LX + 0.3, -LX - 0.2]])
    got = host(tinterp.wrap_x(torch.from_numpy(x), LX))
    np.testing.assert_array_equal(got, np.asarray(jinterp.wrap_x(jnp.asarray(x), LX)))
    assert np.all((got >= 0) & (got < LX))


def test_hat_x_matches():
    x = np.concatenate([_x(), [0.0, LX * (1 - 1e-16), LX / NX]])
    jo = jinterp.hat_x(jnp.asarray(x), LX, NX)
    to = tinterp.hat_x(torch.from_numpy(x), LX, NX)
    for name, a, b in zip(("ix0", "ix1", "w0", "w1"), to, jo):
        np.testing.assert_allclose(host(a), np.asarray(b), rtol=0, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("fn", ["hat_v", "hat_v_clipped"])
def test_hat_v_matches(fn):
    v = np.concatenate([RNG.uniform(-9.0, 9.0, 4096), [-8.0, 8.0, 0.0, 7.999999]])
    jo = getattr(jinterp, fn)(jnp.asarray(v), 8.0, 64)
    to = getattr(tinterp, fn)(torch.from_numpy(v), 8.0, 64)
    for i, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_allclose(host(a), np.asarray(b), rtol=0, atol=1e-12,
                                   err_msg=f"{fn}[{i}]")


def _species_pair():
    """Two species with distinct parameters, so no broadcast can hide."""
    return (dict(charge=-1.0, mass=1.0, temperature=1.0, temperature2=0.25,
                 density=0.9, v0=4.0),
            dict(charge=-0.5, mass=2.0, temperature=1.5, temperature2=0.5,
                 density=0.6, v0=-2.5))


@pytest.mark.parametrize("eq", [e.value for e in Equilibrium])
def test_distributions_match(eq):
    sps = _species_pair()
    jcfg = JConfig(equilibrium=JEquilibrium(eq),
                   species=tuple(JSpeciesConfig(**s) for s in sps))
    tcfg = Config(equilibrium=Equilibrium(eq),
                  species=tuple(SpeciesConfig(**s) for s in sps))
    jsp = jdist.SpeciesParams.from_config(jcfg, jnp.float64)
    tsp = tdist.SpeciesParams.from_config(tcfg, torch.float64, "cpu")
    # two-stream-1's -f0'/f0 is singular at v = 0: keep v away from it
    v = np.stack([RNG.uniform(0.2, 8.0, 2048) * RNG.choice([-1.0, 1.0], 2048)
                  for _ in range(2)])
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    npinit = np.array([[4096.0], [3000.0]])
    for name, a, b in (
            ("f0", tdist.f0(Equilibrium(eq), tsp, tv), jdist.f0(JEquilibrium(eq), jsp, jv)),
            ("minus_dlnf0_dv", tdist.minus_dlnf0_dv(Equilibrium(eq), tsp, tv),
             jdist.minus_dlnf0_dv(JEquilibrium(eq), jsp, jv)),
            ("loader_weight_uniform",
             tdist.loader_weight_uniform(Equilibrium(eq), tsp, tv, LX, 8.0,
                                         torch.from_numpy(npinit)),
             jdist.loader_weight_uniform(JEquilibrium(eq), jsp, jv, LX, 8.0,
                                         jnp.asarray(npinit))),
            ("equilibrium_energy", tdist.equilibrium_energy(Equilibrium(eq), tsp, LX),
             jdist.equilibrium_energy(JEquilibrium(eq), jsp, LX))):
        assert_rel(a, b, 1e-12, f"{eq}:{name}")


@pytest.mark.parametrize("modes", [(1,), (1, 2, 3)], ids=["single", "multimode"])
def test_spectral_operator_matches(modes):
    jop = jspec.SpectralOperator.create(NX, modes, LX, jnp.float64)
    top = tspec.SpectralOperator.create(NX, modes, LX, torch.float64, "cpu")
    for f in ("fre", "fim", "grad_inv"):
        assert_rel(getattr(top, f), getattr(jop, f), 1e-15, f)
    rho = RNG.normal(size=NX)
    for a, b, name in zip(top.solve(torch.from_numpy(rho)),
                          jop.solve(jnp.asarray(rho)), ("E", "mode_re", "mode_im")):
        assert_rel(a, b, 1e-12, f"solve:{name}")
    pc, ps = RNG.normal(size=len(modes)), RNG.normal(size=len(modes))
    assert_rel(top.rho_grid_from_projections(torch.from_numpy(pc), torch.from_numpy(ps), LX),
               jop.rho_grid_from_projections(jnp.asarray(pc), jnp.asarray(ps), LX),
               1e-12, "rho_grid")
    assert_rel(top.e_grid(torch.from_numpy(pc), torch.from_numpy(ps)),
               jop.e_grid(jnp.asarray(pc), jnp.asarray(ps)), 1e-12, "e_grid")


@pytest.mark.parametrize("modes", [(1,), (1, 2, 3)], ids=["single", "multimode"])
def test_matrix_free_ops_match(modes):
    x, val = _x(), RNG.normal(size=4096)
    jt = jspec.mode_trig(jnp.asarray(x), LX, NX, modes)
    tt = tspec.mode_trig(torch.from_numpy(x), LX, NX, modes)
    assert_rel(tt[0], jt[0], 1e-12, "w0")
    assert_rel(tt[1], jt[1], 1e-12, "w1")
    for m, (ta, ja) in enumerate(zip(tt[2], jt[2])):
        for i in range(4):
            assert_rel(ta[i], ja[i], 1e-12, f"mode {modes[m]} trig {i}")
    jpc, jps = jspec.project_modes(jt, jnp.asarray(val))
    tpc, tps = tspec.project_modes(tt, torch.from_numpy(val))
    assert_rel(tpc, jpc, 1e-12, "p_c")
    assert_rel(tps, jps, 1e-12, "p_s")
    jop = jspec.SpectralOperator.create(NX, modes, LX, jnp.float64)
    jre, jim = jspec.solve_modes_from_projections(jpc, jps, jop.grad_inv, LX)
    tre, tim = tspec.solve_modes_from_projections(
        tpc, tps, torch.from_numpy(np.array(jop.grad_inv)), LX)
    assert_rel(tre, jre, 1e-12, "mode_re")
    assert_rel(tim, jim, 1e-12, "mode_im")
    assert_rel(tspec.efield_at(tt, tre, tim), jspec.efield_at(jt, jre, jim), 1e-12, "E_p")


class TestSpectralConventions:
    """tests/test_ops.py::TestSpectral, on the port."""

    def _op(self, modes):
        return tspec.SpectralOperator.create(NX, modes, LX, torch.float64, "cpu")

    def _grid(self):
        return np.arange(NX) / NX * LX

    def test_cosine_charge(self):
        for mode in (1, 3):
            k = 2.0 * np.pi * mode / LX
            e, _, _ = self._op((1, 2, 3)).solve(torch.from_numpy(np.cos(k * self._grid())))
            np.testing.assert_allclose(host(e), np.sin(k * self._grid()) / k, atol=1e-10)

    def test_sine_charge(self):
        k = 2.0 * np.pi * 2 / LX
        e, _, _ = self._op((2,)).solve(torch.from_numpy(np.sin(k * self._grid())))
        np.testing.assert_allclose(host(e), -np.cos(k * self._grid()) / k, atol=1e-10)

    def test_unkept_mode_filtered(self):
        k5 = 2.0 * np.pi * 5 / LX
        e, _, _ = self._op((1,)).solve(torch.from_numpy(np.cos(k5 * self._grid())))
        np.testing.assert_allclose(host(e), 0.0, atol=1e-10)

    def test_mode_component_conventions(self):
        k, amp = 2.0 * np.pi / LX, 0.7
        _, mre, mim = self._op((1,)).solve(torch.from_numpy(amp * np.sin(k * self._grid())))
        np.testing.assert_allclose(host(mre)[0], -amp / (2 * k), rtol=1e-10)
        np.testing.assert_allclose(host(mim)[0], 0.0, atol=1e-12)


def test_f32_stays_f32():
    """Every constant is built at the caller's dtype: an f32 chain must not
    be promoted (the hazard of pic1dp_tpu/ops/spectral.py:122-127)."""
    op = tspec.SpectralOperator.create(NX, (1, 2), LX, torch.float32, "cpu")
    x = torch.from_numpy(_x().astype(np.float32))
    trig = tspec.mode_trig(x, LX, NX, (1, 2))
    pc, ps = tspec.project_modes(trig, x)
    mre, mim = tspec.solve_modes_from_projections(pc, ps, op.grad_inv, LX)
    outs = [trig[0], trig[1], *trig[2][0], pc, ps, mre, mim,
            tspec.efield_at(trig, mre, mim), op.e_grid(mre, mim),
            op.rho_grid_from_projections(pc, ps, LX), tinterp.wrap_x(x - 1.0, LX)]
    assert all(t.dtype == torch.float32 for t in outs)


@pytest.mark.parametrize("variant", ["deltaf", "linear", "fullf"])
def test_diagnostics_match(variant):
    """energies and ptcldist on one state, with dead slots, every branch."""
    change = dict(linear=dict(linear=True), fullf=dict(deltaf=False), deltaf={})[variant]
    sp = dict(charge=-1.0, mass=1.0, temperature=1.0, density=1.0, v0=0.0,
              nparticle_init=3000)
    jcfg, tcfg = (dataclasses.replace(
        preset(nx=64, nparticle=4096, amp=1e-2, dtype="float64"),
        species=(spc(**sp),), **change) for preset, spc in (
            (jax_landau, JSpeciesConfig), (landau_damping, SpeciesConfig)))
    js = jax_load(jcfg, jax.random.PRNGKey(9))
    ts = to_port(js)
    jsp = jdist.SpeciesParams.from_config(jcfg, jnp.float64)
    tsp = tdist.SpeciesParams.from_config(tcfg, torch.float64, "cpu")
    # v past v_max exercises the |v| < v_max mask of the x-v deposit
    ts.v[0, :64] = 7.5
    js = dataclasses.replace(js, v=jnp.asarray(host(ts.v)))
    for name, a, b in zip(tdiag.Energies._fields, tdiag.energies(tcfg, tsp, ts),
                          jdiag.energies(jcfg, jsp, js)):
        assert_rel(a, b, 1e-12, f"{variant}:energies.{name}")
    for name, a, b in zip(tdiag.PtclDist._fields, tdiag.ptcldist(tcfg, tsp, ts),
                          jdiag.ptcldist(jcfg, jsp, js)):
        assert_rel(a, b, 1e-12, f"{variant}:ptcldist.{name}")
