"""The port's copy of the multirand engines (pic1dp_tpu_torch/rng) against
the original, and its multirand loader against the JAX package's.

Engines: integer and uniform streams bit for bit; native Gaussians within
1e-13 of the Python oracle's (libm's log rounds differently from numpy's).
Loader, float64: positions, velocities and the live set bit for bit, for 1,
2 and 4 emulated ranks; the weights p and w within 4 float64 ulp (1e-15
relative to max), since they pass through exp, cos and sin, whose last bit
differs between XLA's and torch's CPU math libraries (p under PHYSICAL
loading uses none of them and is bit for bit)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.rng.multirand import MultiRand as JaxMultiRand
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.loading import _reference_live_mask, load_particles
from pic1dp_tpu_torch.rng import native
from pic1dp_tpu_torch.rng.multirand import MultiRand

REPO = Path(__file__).resolve().parent.parent
N = 6000


# ---- the engines ----

@pytest.mark.parametrize("algorithm", [1, 2, 3])
def test_selftest_passes(algorithm):
    assert MultiRand(algorithm=algorithm, seed_type=1, warmup=0).selftest() == []


def test_kiss64_head_values():
    eng = MultiRand(algorithm=1, seed_type=1, warmup=0)
    eng.seeds = [0] * 20635
    eng.seeds[0:4] = [1234567890987654321, 362436362436362436,
                      1066149217761810, 123456123456123456]
    assert [eng.int64_signed() for _ in range(3)] == [
        8932985056925012148, 5710300428094272059, -104233206776033023]


@pytest.mark.parametrize("algorithm", [1, 2, 3])
@pytest.mark.parametrize("mype", [None, 0, 3])
def test_copy_draws_what_the_original_draws(algorithm, mype):
    """Every stream of the copy against the original, same seeding: 64- and
    32-bit integers, uniforms, Gaussians (odd lengths leave a carry)."""
    a = MultiRand(algorithm=algorithm, seed_type=1, mype=mype, warmup=5)
    b = JaxMultiRand(algorithm=algorithm, seed_type=1, mype=mype, warmup=5)
    assert [a.int64() for _ in range(20)] == [b.int64() for _ in range(20)]
    assert [a.int32() for _ in range(5)] == [b.int32() for _ in range(5)]
    np.testing.assert_array_equal(a.real_array(257), b.real_array(257))
    np.testing.assert_array_equal(a.gaussian_array(101), b.gaussian_array(101))
    np.testing.assert_array_equal(a.gaussian_array(100), b.gaussian_array(100))
    np.testing.assert_array_equal(a.real_array32(7), b.real_array32(7))
    np.testing.assert_array_equal(a.gaussian_array32(9), b.gaussian_array32(9))


def test_copy_source_matches_the_original():
    """The copies differ from the originals in their header comments only."""
    def body(path, skip):
        return (REPO / path).read_text().splitlines()[skip:]

    a = body("pic1dp_tpu_torch/rng/multirand.py", 25)
    b = body("pic1dp_tpu/rng/multirand.py", 24)
    assert a == b
    strip = lambda t: [ln for ln in t if not ln.startswith("//")]   # noqa: E731
    assert strip(body("pic1dp_tpu_torch/rng/native/multirand.cpp", 0)) == \
        strip(body("pic1dp_tpu/rng/native/multirand.cpp", 0))


def test_rank_decorrelation_and_urandom():
    a = MultiRand(algorithm=3, seed_type=1, mype=0, warmup=5)
    b = MultiRand(algorithm=3, seed_type=1, mype=1, warmup=5)
    assert [a.int64() for _ in range(10)] != [b.int64() for _ in range(10)]
    assert isinstance(MultiRand(algorithm=1, seed_type=3, warmup=1).int64(), int)


@pytest.fixture(scope="module")
def native_engine():
    if not native.available():
        pytest.skip(f"no native build: {native.build_error()}")
    return native


@pytest.mark.parametrize("algorithm", [1, 2, 3])
def test_native_matches_python(native_engine, algorithm):
    a = native_engine.NativeMultiRand(algorithm=algorithm, seed_type=1, mype=3, warmup=5)
    b = MultiRand(algorithm=algorithm, seed_type=1, mype=3, warmup=5)
    assert [a.int64() for _ in range(10)] == [b.int64() for _ in range(10)]
    np.testing.assert_array_equal(a.real_array(1001), b.real_array(1001))
    np.testing.assert_allclose(a.gaussian_array(501), b.gaussian_array(501),
                               rtol=1e-13, atol=1e-15)
    # odd-length call leaves a buffered partner; next call must consume it
    np.testing.assert_allclose(a.gaussian_array(500), b.gaussian_array(500),
                               rtol=1e-13, atol=1e-15)


def test_native_no_rank_and_bad_algorithm(native_engine):
    a = native_engine.NativeMultiRand(3, 1, None, 5)
    b = MultiRand(3, 1, None, 5)
    assert [a.int64() for _ in range(5)] == [b.int64() for _ in range(5)]
    with pytest.raises(ValueError, match="bad multirand algorithm"):
        native_engine.NativeMultiRand(algorithm=9)


def test_native_library_is_built_in_the_ports_build_directory(native_engine):
    path = native_engine.library_path()
    assert path.exists()
    assert path.parent == REPO / "pic1dp_tpu_torch" / "_build"
    assert native_engine.build_error() is None
    assert not list((REPO / "pic1dp_tpu_torch" / "rng").rglob("*.so"))


def test_selftest_knob_runs():
    eng = native.make_multirand(algorithm=3, seed_type=1, mype=0, warmup=5, selftest=True)
    assert eng.int64() > 0


# ---- the loader ----

def _cfg(mod, physical: bool, dtype="float64"):
    if physical:
        cfg = mod.landau_damping(nx=32, nparticle=N, dtype=dtype, verbosity=0,
                                 marker=mod.MarkerLoading.PHYSICAL)
    else:
        cfg = mod.bump_on_tail_default(nx=192, nparticle_max=N, dtype=dtype, verbosity=0)
    sp = dataclasses.replace(cfg.species[0], nparticle_init=N - 333)
    return dataclasses.replace(cfg, rng=mod.RngConfig(backend="multirand"), species=(sp,))


def _assert_loaded_states_agree(got, want, physical: bool, msg: str):
    for f in ("x", "v", "live"):
        np.testing.assert_array_equal(host(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f"{msg}: {f}")
    if physical:
        np.testing.assert_array_equal(host(got.p - got.w), np.asarray(want.p - want.w),
                                      err_msg=f"{msg}: p0")
    for f in ("p", "w"):
        assert_rel(getattr(got, f), getattr(want, f), 1e-15, f"{msg}: {f}")


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("physical", [False, True], ids=["uniform", "physical"])
def test_multirand_load_matches_jax(ranks, physical):
    want = jax_load(_cfg(jcfg_mod, physical), emulate_ranks=ranks)
    got = load_particles(_cfg(tcfg_mod, physical), "cpu", emulate_ranks=ranks)
    assert int(got.live.sum()) == N - 333
    _assert_loaded_states_agree(got, want, physical, f"ranks {ranks}")


def test_multirand_load_with_pertb_shape_matches_jax():
    import jax.numpy as jnp

    want = jax_load(_cfg(jcfg_mod, False), emulate_ranks=2,
                    pertb_shape=lambda v, s: jnp.exp(-0.5 * (v - 4.0) ** 2) * (s + 1))
    got = load_particles(_cfg(tcfg_mod, False), "cpu", emulate_ranks=2,
                         pertb_shape=lambda v, s: torch.exp(-0.5 * (v - 4.0) ** 2) * (s + 1))
    plain = load_particles(_cfg(tcfg_mod, False), "cpu", emulate_ranks=2)
    _assert_loaded_states_agree(got, want, False, "pertb_shape")
    assert not torch.equal(got.w, plain.w) and torch.equal(got.x, plain.x)


def test_pertb_shape_reaches_the_generator_loader_and_the_simulation():
    cfg = tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=2048, dtype="float64", verbosity=0)
    shaped = Simulation(cfg, pertb_shape=lambda v, s: (v > 0).to(v.dtype), device="cpu").load()
    plain = Simulation(cfg, device="cpu").load()
    assert torch.equal(shaped.x, plain.x) and torch.equal(shaped.v, plain.v)
    assert torch.equal(shaped.w, torch.where(plain.v > 0, plain.w, 0.0))


def test_multirand_deterministic_and_rank_layout_matters():
    """tests/test_tools.py:157-174 on the port."""
    cfg = dataclasses.replace(
        tcfg_mod.landau_damping(nx=32, nparticle=8192, dtype="float64", verbosity=0),
        rng=tcfg_mod.RngConfig(backend="multirand"))
    a = load_particles(cfg, "cpu", emulate_ranks=4)
    b = load_particles(cfg, "cpu", emulate_ranks=4)
    assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    c = load_particles(cfg, "cpu", emulate_ranks=2)
    assert not torch.equal(a.x, c.x)


def test_tail_unload_per_rank():
    """tests/test_multirand.py:165-186 on the port: each rank drops the LAST
    (nmax - ninit)/npe slots of its block, remainder on rank 0."""
    cfg = tcfg_mod.landau_damping(nx=32, nparticle=1000, dtype="float64", verbosity=0)
    cfg = dataclasses.replace(
        cfg, rng=tcfg_mod.RngConfig(backend="multirand"),
        species=(dataclasses.replace(cfg.species[0], nparticle_init=900),))
    live = host(load_particles(cfg, "cpu", emulate_ranks=4).live[0])
    blocks = live.reshape(4, 250)
    for r in range(4):
        assert blocks[r, :225].all() and not blocks[r, 225:].any(), r
    assert live.sum() == 900
    # a remainder goes to rank 0: 1000 - 897 = 103 = 4 x 25 + 3
    mask = _reference_live_mask(1000, 897, np.array([0, 250, 500, 750, 1000]))
    assert [int(b.sum()) for b in mask.reshape(4, 250)] == [222, 225, 225, 225]


def test_multirand_load_does_not_fold_x_equal_lx():
    """The engines' uniform includes 1, so x may be lx itself; the JAX
    loader keeps it (hat_x clamps it into the last cell) and so does this
    one.  Every x lies in [0, lx]."""
    cfg = _cfg(tcfg_mod, False)
    x = host(load_particles(cfg, "cpu").x)
    assert np.all((x >= 0.0) & (x <= cfg.lx))


def test_multirand_f32_state():
    cfg = _cfg(tcfg_mod, False, "float32")
    want = jax_load(_cfg(jcfg_mod, False, "float32"))
    got = load_particles(cfg, "cpu")
    assert got.x.dtype == got.w.dtype == torch.float32
    for f in ("x", "v", "live"):
        np.testing.assert_array_equal(host(getattr(got, f)), np.asarray(getattr(want, f)))


def test_simulation_emulate_ranks():
    cfg = dataclasses.replace(_cfg(tcfg_mod, False), time_max=0.2, output_interval=0.1)
    a = Simulation(cfg, emulate_ranks=2, device="cpu")
    a.run()
    assert a.itime == 4 and bool(torch.isfinite(a.state.w).all())
    b = load_particles(cfg, "cpu", emulate_ranks=2)
    c = Simulation(cfg, emulate_ranks=2, device="cpu").load()
    assert torch.equal(b.x, c.x) and torch.equal(b.live, c.live)
