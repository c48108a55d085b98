"""The port's Stepper against the JAX Stepper: 5 steps from one state, in
float64 at 1e-12 relative to max, against both the XLA spectral path and
the Pallas path in interpret mode, for the default cases and every variant
of tests/test_spectral_path.py's _pallas_cases (linear, full-f, two-stream,
two species) and TWO_STREAM1."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import CASES, assert_rel, host, to_port

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.config import DepositMethod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk

_CASES = {
    "bump_on_tail": ("bump_on_tail_default", dict(nx=192, nparticle_max=4096)),
    "landau": ("landau_damping", dict(nx=64, nparticle=4096)),
}


STEP_CASES = sorted(_CASES) + [n for n in CASES if n not in (
    "bot_nonlinear_deltaf", "bot_density_1", "bot_density_0")]


def _pair(name, dtype="float64"):
    if name in CASES:
        return CASES[name](jcfg_mod, dtype), CASES[name](tcfg_mod, dtype)
    preset, kw = _CASES[name]
    kw = dict(kw, dtype=dtype, verbosity=0)
    return getattr(jcfg_mod, preset)(**kw), getattr(tcfg_mod, preset)(**kw)


@pytest.mark.parametrize("name", STEP_CASES)
def test_stepper_matches_jax_paths(name):
    jcfg, tcfg = _pair(name)
    st_x = JaxStepper(jcfg)
    st_p = JaxStepper(dataclasses.replace(jcfg, deposit_method=DepositMethod.PALLAS))
    assert st_p.deposit_method == DepositMethod.PALLAS
    raw = jax_load(jcfg, jax.random.PRNGKey(3))
    a = b = st_x.initial_field(raw)
    stepper = Stepper(tcfg, "cpu")
    t = stepper.initial_field(to_port(raw))
    for field in ("rho", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(t, field), getattr(a, field), 1e-12, f"{name}:initial {field}")
    for _ in range(5):
        a, b, t = st_x.step(a), st_p.step(b), stepper.step(t)
    for field in ("x", "v", "w", "mode_re", "mode_im", "electric", "rho"):
        got = getattr(t, field)
        assert_rel(got, getattr(a, field), 1e-12, f"{name}:{field} vs XLA")
        assert_rel(got, getattr(b, field), 1e-12, f"{name}:{field} vs Pallas")


def test_multi_step_bitwise_equals_steps():
    """tests/test_spectral_path.py:63-73 on the port: k steps in one call are
    k single steps exactly."""
    jcfg, tcfg = _pair("landau")
    stepper = Stepper(tcfg, "cpu")
    state = stepper.initial_field(to_port(jax_load(jcfg, jax.random.PRNGKey(2))))
    a = stepper.multi_step(state.clone(), 4)
    b = state.clone()
    for _ in range(4):
        b = stepper.step(b)
    for field in ("x", "v", "w", "mode_re", "mode_im", "electric", "rho"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_f32_state_stays_f32():
    jcfg, tcfg = _pair("bump_on_tail", "float32")
    stepper = Stepper(tcfg, "cpu")
    state = stepper.initial_field(to_port(jax_load(jcfg, jax.random.PRNGKey(17))))
    state = stepper.multi_step(state, 2)
    for field in ("x", "v", "p", "w", "mode_re", "mode_im", "electric", "rho"):
        assert getattr(state, field).dtype == torch.float32, field
    assert np.isfinite(host(state.w)).all()


def test_plain_stepper_on_cpu_is_the_default():
    """On the CPU `plain=True` changes nothing: both run the plain versions
    and launch no kernel."""
    jcfg, tcfg = _pair("landau")
    state = to_port(jax_load(jcfg, jax.random.PRNGKey(4)))
    a = Stepper(tcfg, "cpu")
    b = Stepper(tcfg, "cpu", plain=True)
    sa = a.multi_step(a.initial_field(state.clone()), 2)
    sb = b.multi_step(b.initial_field(state.clone()), 2)
    assert torch.equal(sa.w, sb.w) and torch.equal(sa.mode_re, sb.mode_re)
    assert [k.launches for k in sk.KERNELS] == [0] * len(sk.KERNELS)


def test_fullf_initial_field_deposits_p():
    """Full-f deposits charge * p, as JAX's _initial_field does
    (pic1dp_tpu/core/step.py:210-213); a w deposit would be the delta-f
    field."""
    jcfg, tcfg = _pair("landau_fullf")
    raw = jax_load(jcfg, jax.random.PRNGKey(6))
    want = JaxStepper(jcfg).initial_field(raw)
    got = Stepper(tcfg, "cpu").initial_field(to_port(raw))
    for field in ("rho", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(got, field), getattr(want, field), 1e-12, field)
    wrong = Stepper(dataclasses.replace(tcfg, deltaf=True), "cpu").initial_field(to_port(raw))
    assert not torch.allclose(wrong.mode_im, got.mode_im)


def test_graph_steps_refuse_a_cpu_state():
    """CUDA graphs replay over CUDA buffers only; on the CPU multi_step is
    the loop of steps (test_multi_step_bitwise_equals_steps)."""
    jcfg, tcfg = _pair("landau")
    stepper = Stepper(tcfg, "cpu")
    state = stepper.initial_field(to_port(jax_load(jcfg, jax.random.PRNGKey(2))))
    with pytest.raises(ValueError, match="CUDA graphs replay on a CUDA state"):
        stepper.graph_steps(state, 2)
    assert stepper._graphs == {}


def test_explicit_grid_path_steps():
    """The EXPLICIT grid path builds and steps (tests/test_torch_grid.py
    holds it against the JAX package)."""
    cfg = dataclasses.replace(tcfg_mod.bump_on_tail_default(nparticle_max=1024,
                                                            dtype="float64"),
                              shape=tcfg_mod.ParticleShape.EXPLICIT)
    stepper = Stepper(cfg, "cpu")
    assert stepper.explicit
    from pic1dp_tpu_torch.core.loading import load_particles

    state = stepper.step(stepper.initial_field(load_particles(cfg, "cpu")))
    assert np.isfinite(host(state.w)).all() and np.isfinite(host(state.electric)).all()


def test_multirand_loaded_state_steps():
    """The multirand backend loads (tests/test_torch_multirand.py holds it
    against the JAX package) and the loaded state steps."""
    from pic1dp_tpu_torch.core.loading import load_particles

    cfg = dataclasses.replace(tcfg_mod.bump_on_tail_default(nparticle_max=1024,
                                                            dtype="float64"),
                              rng=tcfg_mod.RngConfig(backend="multirand"))
    stepper = Stepper(cfg, "cpu")
    state = stepper.step(stepper.initial_field(load_particles(cfg, "cpu")))
    assert np.isfinite(host(state.w)).all()
