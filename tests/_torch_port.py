"""Helpers for the tests of the PyTorch port (tests/test_torch_*.py).

One state enters both packages through numpy: the JAX package loads it, and
`SimState.from_numpy` carries it into the port.  Comparisons are relative to
the largest magnitude of the expected field, as in tests/test_spectral_path.py.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import torch

from pic1dp_tpu.core.state import SimState as JaxSimState
from pic1dp_tpu_torch.core.state import SimState

# tier-1 runs six xdist workers on one machine: keep each one's torch small
torch.set_num_threads(2)


def to_port(jax_state, device="cpu") -> SimState:
    return SimState.from_numpy(jax_state, device)


def to_jax(state: SimState) -> JaxSimState:
    return JaxSimState(**{k: jnp.asarray(v) for k, v in state.to_numpy().items()})


def host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_rel(actual, expected, atol: float, msg: str = "") -> None:
    """|actual - expected| <= atol * max|expected|, elementwise."""
    a, e = host(actual), host(expected)
    assert a.shape == e.shape, f"{msg}: shape {a.shape} != {e.shape}"
    scale = np.max(np.abs(e)) + 1e-300
    np.testing.assert_allclose(a / scale, e / scale, rtol=0, atol=atol, err_msg=msg)


def assert_bf16_close(got, want, eta: float, msg: str) -> None:
    """|got - want| <= one bfloat16 ulp of max(|got|, |want|) + eta * max|want|."""
    a = torch.as_tensor(np.asarray(host(got), np.float32))
    b = torch.as_tensor(np.asarray(want, np.float32))
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    bad = (a - b).abs() > ulp + eta * float(b.abs().max())
    assert not bool(bad.any()), f"{msg}: {int(bad.sum())} markers beyond one bf16 ulp + {eta}"


# ---- the variants of tests/test_spectral_path.py's _pallas_cases, plus
# TWO_STREAM1 and degenerate bump-on-tail densities, at test size ----

def _bot(m, dtype, nx=192, **kw):
    return m.bump_on_tail_default(nx=nx, nparticle_max=4096, dtype=dtype, verbosity=0, **kw)


def _lan(m, dtype, **kw):
    return m.landau_damping(nx=64, nparticle=4096, dtype=dtype, verbosity=0, **kw)


def _species(cfg, m, *params):
    return dataclasses.replace(cfg, species=tuple(m.SpeciesConfig(**s) for s in params))


def _two_species_maxwellian(m, dtype):
    return _species(dataclasses.replace(
        m.two_stream(nx=64, nparticle=4096, dtype=dtype, verbosity=0),
        equilibrium=m.Equilibrium.MAXWELLIAN),
        m, dict(charge=-1.0, mass=1.0, temperature=1.0, density=0.6, v0=2.5),
        dict(charge=-0.5, mass=2.0, temperature=0.5, density=0.4, v0=-3.0))


# name -> config in either config module (pic1dp_tpu.config or the port's copy)
CASES = {
    "bot_nonlinear_deltaf": lambda m, dt: _bot(m, dt),
    "landau_linear": lambda m, dt: dataclasses.replace(_lan(m, dt), linear=True),
    "landau_fullf": lambda m, dt: dataclasses.replace(_lan(m, dt, amp=1e-2), deltaf=False),
    "two_stream2": lambda m, dt: m.two_stream(nx=64, nparticle=4096, dtype=dt, verbosity=0),
    "multimode": lambda m, dt: dataclasses.replace(
        _lan(m, dt), modes=(1, 2, 3), init_modes=(1, 2), init_amp_cos=(1e-5, 0.0),
        init_amp_sin=(1e-4, 5e-5)),
    "two_species_maxwellian": _two_species_maxwellian,
    "two_species_bump_mixed": lambda m, dt: _species(
        _bot(m, dt, nx=64), m,
        dict(charge=-1.0, mass=1.0, temperature=1.0, temperature2=0.25, density=0.9, v0=4.0),
        dict(charge=-1.0, mass=1.0, temperature=1.5, temperature2=0.25, density=1.0, v0=0.0)),
    "two_stream1": lambda m, dt: m.Config(
        lx=2.0 * math.pi / 0.5, equilibrium=m.Equilibrium.TWO_STREAM1,
        species=(m.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0,
                                 v0=0.0),),
        nx=64, nparticle_max=4096, v_max=8.0, dtype=dt, verbosity=0).validate(),
    "bot_density_1": lambda m, dt: _species(
        _bot(m, dt, nx=64), m, dict(dataclasses.asdict(m.SpeciesConfig()), density=1.0)),
    "bot_density_0": lambda m, dt: _species(
        _bot(m, dt, nx=64), m, dict(dataclasses.asdict(m.SpeciesConfig()), density=0.0)),
}
