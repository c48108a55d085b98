"""The port's EXPLICIT grid path (ops/shape_matrix.py, ops/deposit.py,
ops/gather.py, Stepper._step_grid) against the JAX package and against the
port's own matrix-free path, in float64 on the CPU.  Tolerances: 1e-12
relative to each field's max for steps (the sums run in another order), and
1e-13 for a single deposit or gather."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CASES, assert_rel, host, to_port

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops import deposit as jdeposit
from pic1dp_tpu.ops import gather as jgather
from pic1dp_tpu.ops.shape_matrix import ShapeMatrix as JaxShapeMatrix
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops.deposit import deposit
from pic1dp_tpu_torch.ops.gather import gather
from pic1dp_tpu_torch.ops.shape_matrix import ShapeMatrix

GRID_CASES = ["bot_nonlinear_deltaf", "landau_linear", "landau_fullf",
              "two_species_maxwellian"]
STEP_FIELDS = ("x", "v", "w", "mode_re", "mode_im", "electric", "rho")
LX, NX, N = 17.4, 48, 5000


def _explicit(mod, name, dtype="float64"):
    return dataclasses.replace(CASES[name](mod, dtype), shape=mod.ParticleShape.EXPLICIT)


def _particles(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, LX, (2, N))
    x[0, :3] = [0.0, LX * (1 - 1e-16), LX - LX / NX]   # the wrap cell
    return x, rng.normal(size=(2, N)), rng.normal(size=NX)


@pytest.mark.parametrize("method", ["segment", "onehot", "twolevel"])
def test_deposit_matches_every_jax_method(method):
    x, val, _ = _particles()
    want = jdeposit.deposit(jnp.asarray(x.ravel()), jnp.asarray(val.ravel()), LX, NX,
                            method=method)
    assert_rel(deposit(torch.from_numpy(x), torch.from_numpy(val), LX, NX), want, 1e-13,
               method)


@pytest.mark.parametrize("method", ["take", "twolevel"])
def test_gather_matches_every_jax_method(method):
    x, _, grid = _particles(1)
    want = jgather.gather(jnp.asarray(x.ravel()), jnp.asarray(grid), LX, NX, method=method)
    got = gather(torch.from_numpy(x), torch.from_numpy(grid), LX, NX)
    assert got.shape == x.shape
    assert_rel(got.reshape(-1), want, 1e-13, method)


def test_shape_matrix_matches_jax():
    x, val, grid = _particles(2)
    s = ShapeMatrix.assemble(torch.from_numpy(x), LX, NX)
    j = JaxShapeMatrix.assemble(jnp.asarray(x), LX, NX)
    for f in ("ix0", "ix1"):
        np.testing.assert_array_equal(host(getattr(s, f)), np.asarray(getattr(j, f)))
    for f in ("w0", "w1"):
        np.testing.assert_array_equal(host(getattr(s, f)), np.asarray(getattr(j, f)))
    for method in ("segment", "onehot"):
        assert_rel(s.deposit(torch.from_numpy(val)), j.deposit(jnp.asarray(val), method=method),
                   1e-13, f"deposit {method}")
    for method in ("take", "twolevel"):
        assert_rel(s.gather(torch.from_numpy(grid)), j.gather(jnp.asarray(grid), method=method),
                   1e-13, f"gather {method}")
    np.testing.assert_array_equal(host(s.todense()), np.asarray(j.todense()))


def test_shape_matrix_is_the_transposed_pair():
    """deposit is S^T val and gather is S grid for the dense S."""
    x, val, grid = _particles(3)
    s = ShapeMatrix.assemble(torch.from_numpy(x[0]), LX, NX)
    dense = s.todense()
    assert dense.shape == (N, NX)
    assert torch.equal(dense.sum(dim=1), s.w0 + s.w1)
    assert_rel(s.deposit(torch.from_numpy(val[0])), dense.T @ torch.from_numpy(val[0]), 1e-13)
    assert_rel(s.gather(torch.from_numpy(grid)), dense @ torch.from_numpy(grid), 1e-13)


@pytest.mark.parametrize("name", GRID_CASES)
def test_explicit_steps_match_jax(name):
    """5 EXPLICIT steps from one JAX-loaded state in both packages."""
    jcfg, tcfg = _explicit(jcfg_mod, name), _explicit(tcfg_mod, name)
    jst, st = JaxStepper(jcfg), Stepper(tcfg, "cpu")
    raw = jax_load(jcfg, jax.random.PRNGKey(5))
    a, t = jst.initial_field(raw), st.initial_field(to_port(raw))
    for field in ("rho", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(t, field), getattr(a, field), 1e-12, f"{name}:initial {field}")
    for _ in range(5):
        a, t = jst.step(a), st.step(t)
    for field in STEP_FIELDS:
        assert_rel(getattr(t, field), getattr(a, field), 1e-12, f"{name}:{field}")


@pytest.mark.parametrize("name", GRID_CASES + ["multimode"])
def test_spectral_matches_grid(name):
    """tests/test_spectral_path.py:33-47 inside the port: the matrix-free
    and the grid path are one operator up to summation order.  rho is left
    out: the grid path's holds every mode, the spectral path's the kept
    ones."""
    cfg = CASES[name](tcfg_mod, "float64")
    st_s = Stepper(cfg, "cpu")
    st_g = Stepper(dataclasses.replace(cfg, shape=tcfg_mod.ParticleShape.EXPLICIT), "cpu")
    raw = to_port(jax_load(CASES[name](jcfg_mod, "float64"), jax.random.PRNGKey(0)))
    a, b = st_s.initial_field(raw.clone()), st_g.initial_field(raw.clone())
    a, b = st_s.multi_step(a, 5), st_g.multi_step(b, 5)
    for field in ("x", "v", "w", "mode_re", "mode_im", "electric"):
        assert_rel(getattr(a, field), getattr(b, field), 1e-12, f"{name}:{field}")


def test_push_pair_spectral_matches_grid():
    """tests/test_spectral_path.py:50-60 inside the port, and both against
    the JAX package's push_pair, midpoint field included."""
    jcfg = CASES["bot_nonlinear_deltaf"](jcfg_mod, "float64")
    cfg = CASES["bot_nonlinear_deltaf"](tcfg_mod, "float64")
    grid = tcfg_mod.ParticleShape.EXPLICIT
    st_s, st_g = Stepper(cfg, "cpu"), Stepper(dataclasses.replace(cfg, shape=grid), "cpu")
    jst = JaxStepper(jcfg)
    jstate = jst.initial_field(jax_load(jcfg, jax.random.PRNGKey(1)))
    want = jst.push_pair(jstate)
    a, b = st_s.push_pair(to_port(jstate)), st_g.push_pair(to_port(jstate))
    for field in ("x", "v", "w", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(a, field), getattr(want, field), 1e-12, f"spectral {field}")
        assert_rel(getattr(b, field), getattr(want, field), 1e-12, f"grid {field}")
    assert_rel(a.rho, want.rho, 1e-12, "rho")
    for field in ("mode_re", "mode_im"):   # the step-start modes come back
        np.testing.assert_array_equal(host(getattr(a, field)), np.asarray(getattr(jstate, field)))


def test_explicit_step_returns_new_tensors_and_multi_step_is_eager():
    cfg = _explicit(tcfg_mod, "bot_nonlinear_deltaf")
    st = Stepper(cfg, "cpu")
    s0 = st.initial_field(to_port(jax_load(_explicit(jcfg_mod, "bot_nonlinear_deltaf"),
                                           jax.random.PRNGKey(2))))
    x0 = s0.x.clone()
    s1 = st.step(s0)
    assert torch.equal(s0.x, x0) and s1.x.data_ptr() != s0.x.data_ptr()
    a = st.multi_step(s0, 3)
    b = s0
    for _ in range(3):
        b = st.step(b)
    for field in STEP_FIELDS:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    with pytest.raises(ValueError, match="CUDA graphs replay on a CUDA state"):
        st.graph_steps(s0, 2)


@pytest.mark.parametrize("method", list(tcfg_mod.DepositMethod))
def test_every_deposit_method_selects_the_one_path(method):
    base = _explicit(tcfg_mod, "landau_linear")
    cfg = dataclasses.replace(base, deposit_method=method, deposit_chunk=7)
    raw = to_port(jax_load(_explicit(jcfg_mod, "landau_linear"), jax.random.PRNGKey(3)))
    a = Stepper(base, "cpu")
    b = Stepper(cfg, "cpu")
    sa = a.step(a.initial_field(raw.clone()))
    sb = b.step(b.initial_field(raw.clone()))
    assert torch.equal(sa.w, sb.w) and torch.equal(sa.rho, sb.rho)


def test_explicit_f32_state_stays_f32():
    cfg = _explicit(tcfg_mod, "bot_nonlinear_deltaf", "float32")
    st = Stepper(cfg, "cpu")
    s = st.initial_field(to_port(jax_load(_explicit(jcfg_mod, "bot_nonlinear_deltaf", "float32"),
                                          jax.random.PRNGKey(4))))
    s = st.multi_step(s, 2)
    for field in ("x", "v", "p", "w", "mode_re", "mode_im", "electric", "rho"):
        assert getattr(s, field).dtype == torch.float32, field
    assert np.isfinite(host(s.w)).all()
