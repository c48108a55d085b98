"""Helpers for the tests of the PyTorch port (tests/test_torch_*.py).

One state enters both packages through numpy: the JAX package loads it, and
`SimState.from_numpy` carries it into the port.  Comparisons are relative to
the largest magnitude of the expected field, as in tests/test_spectral_path.py.
"""

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
