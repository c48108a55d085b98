"""The port's torch.Generator loader.  It draws other numbers than
jax.random, so it is held to the JAX loader's formulas on its own draws and
to the statistics of the distributions it samples."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu import distributions as jdist
from pic1dp_tpu.core.loading import _initial_w as jax_initial_w
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.loading import load_particles

N = 8192


def _bot(mod, **kw):
    cfg = mod.bump_on_tail_default(nx=192, nparticle_max=N, dtype="float64",
                                   verbosity=0, **kw)
    sp = dataclasses.replace(cfg.species[0], nparticle_init=6000)
    return dataclasses.replace(cfg, species=(sp,))


def test_live_count_and_dead_slots():
    cfg = _bot(tcfg_mod)
    s = load_particles(cfg, "cpu")
    assert host(s.nparticles()).tolist() == [6000]
    dead = ~s.live
    assert torch.all(s.p[dead] == 0) and torch.all(s.w[dead] == 0)
    assert torch.all(s.p[s.live] != 0)


def test_ranges():
    cfg = _bot(tcfg_mod)
    s = load_particles(cfg, "cpu")
    x, v = host(s.x), host(s.v)
    assert np.all((x >= 0) & (x < cfg.lx))
    assert np.all((v >= -cfg.v_max) & (v < cfg.v_max))


def test_weights_follow_the_jax_formulas():
    """p (before the nonlinear p += w) is JAX's loader_weight_uniform at the
    port's v; w is JAX's _initial_w at the port's x and v."""
    tcfg, jcfg = _bot(tcfg_mod), _bot(jcfg_mod)
    s = load_particles(tcfg, "cpu")
    x, v = jnp.asarray(host(s.x)), jnp.asarray(host(s.v))
    sp = jdist.SpeciesParams.from_config(jcfg, jnp.float64)
    p0 = jdist.loader_weight_uniform(jcfg.equilibrium, sp, v, jcfg.lx,
                                     jcfg.v_max, jnp.asarray([[6000.0]]))
    w = np.where(host(s.live), np.asarray(jax_initial_w(jcfg, x, p0, v, None)), 0.0)
    assert_rel(s.w, w, 1e-12, "w")
    assert_rel(s.p, np.where(host(s.live), np.asarray(p0) + w, 0.0), 1e-12, "p")


def test_same_seed_same_state():
    cfg = _bot(tcfg_mod)
    a, b = load_particles(cfg, "cpu"), load_particles(cfg, "cpu")
    c = load_particles(dataclasses.replace(cfg, rng=tcfg_mod.RngConfig(seed=1)), "cpu")
    for f in ("x", "v", "p", "w"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.x, c.x)


def test_uniform_loading_statistics():
    """x ~ U[0, lx), v ~ U[-v_max, v_max): means and variances within 5 sigma."""
    cfg = _bot(tcfg_mod)
    s = load_particles(cfg, "cpu")
    for vals, lo, hi in ((host(s.x), 0.0, cfg.lx), (host(s.v), -cfg.v_max, cfg.v_max)):
        vals = vals.ravel()
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(vals.mean() - mean) < 5 * np.sqrt(var / vals.size)
        # the variance of a uniform sample's variance is (hi - lo)^4 / 180 / n
        assert abs(vals.var() - var) < 5 * (hi - lo) ** 2 / np.sqrt(180 * vals.size)


def test_physical_loading_statistics():
    """PHYSICAL markers ~ the shifted Maxwellian f0, with p = n lx / N."""
    cfg = dataclasses.replace(
        tcfg_mod.landau_damping(nx=64, nparticle=N, dtype="float64",
                                marker=tcfg_mod.MarkerLoading.PHYSICAL),
        species=(tcfg_mod.SpeciesConfig(temperature=2.0, density=1.0, v0=0.5),))
    s = load_particles(cfg, "cpu")
    v = host(s.v).ravel()
    vth = np.sqrt(2.0)
    assert abs(v.mean() - 0.5) < 5 * vth / np.sqrt(N)
    assert abs(v.std() - vth) < 5 * vth / np.sqrt(2 * N)
    p0 = host(s.p - s.w)
    np.testing.assert_allclose(p0, cfg.lx / N, rtol=1e-12)


def test_generator_is_used_and_on_the_device():
    cfg = _bot(tcfg_mod)
    g = torch.Generator(device="cpu").manual_seed(cfg.rng.seed)
    a = load_particles(cfg, "cpu", generator=g)
    b = load_particles(cfg, "cpu")
    assert torch.equal(a.x, b.x)
    assert a.x.device.type == "cpu" and a.x.dtype == torch.float64


def test_multirand_backend_ignores_the_generator():
    """The multirand backend loads the same markers whatever generator is
    passed, and other ones than the generator's."""
    cfg = dataclasses.replace(_bot(tcfg_mod), rng=tcfg_mod.RngConfig(backend="multirand"))
    a = load_particles(cfg, "cpu")
    b = load_particles(cfg, "cpu", generator=torch.Generator().manual_seed(99))
    assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    assert host(a.nparticles()).tolist() == [6000]
    assert not torch.equal(a.x, load_particles(_bot(tcfg_mod), "cpu").x)
