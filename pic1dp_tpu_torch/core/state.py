"""Simulation state (port of pic1dp_tpu/core/state.py).

The reference holds particle data in PETSc distributed Vecs of fixed length
nparticle_max per species (reference src/pic1dp_particle.F90:34-54) plus a
per-rank live count `particle_np`.  As in the JAX package, the state is
fixed-capacity (nspecies, nparticle_max) tensors with a boolean `live` mask.

Weight conventions (reference src/pic1dp_particle.F90:28-32):
    p = f / g   (nonlinear)  or  f0 / g  (linear)   — constant along orbits
    w = delta f / g
where f is the total distribution, delta f the perturbation, g the marker
distribution.
"""

from __future__ import annotations

import dataclasses
import importlib.util

import numpy as np
import torch

from pic1dp_tpu_torch.config import Config

FIELDS = ("x", "v", "p", "w", "live", "rho", "electric", "mode_re", "mode_im")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a Config dtype string ("float32", "float64", ...)."""
    return getattr(torch, name)


@dataclasses.dataclass
class SimState:
    """All per-run tensor state.  Shapes:
    x, v, p, w, live: (nspecies, nparticle_max)
    rho, electric:    (nx,)
    mode_re, mode_im: (nmode,)  — E-field Fourier components (the quantities
                      the reference writes to output, src/pic1dp_output.F90:177-181)

    Invariant: p = w = 0 wherever live is False (established by the loader).
    Dead markers then deposit nothing and their weights stay zero under the
    push equations, so the hot kernels never read the mask; only diagnostics
    that count markers (marker energy/distribution) use `live`.
    """

    x: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    live: torch.Tensor
    rho: torch.Tensor
    electric: torch.Tensor
    mode_re: torch.Tensor
    mode_im: torch.Tensor

    def nparticles(self) -> torch.Tensor:
        """Live marker count per species (reference particle_np,
        src/pic1dp_particle.F90:54)."""
        return torch.sum(self.live, dim=1)

    @classmethod
    def zeros(cls, cfg: Config, device: torch.device | str) -> "SimState":
        dtype = torch_dtype(cfg.dtype)
        ns, n = cfg.nspecies, cfg.nparticle_max

        def z(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(x=z((ns, n)), v=z((ns, n)), p=z((ns, n), torch_dtype(cfg.p_dtype)),
                   w=z((ns, n)), live=z((ns, n), torch.bool),
                   rho=z((cfg.nx,)), electric=z((cfg.nx,)),
                   mode_re=z((cfg.nmode,)), mode_im=z((cfg.nmode,)))

    @classmethod
    def from_numpy(cls, arrays, device: torch.device | str) -> "SimState":
        """A state from host arrays: a mapping of the field names, or any
        object with those attributes (a pic1dp_tpu SimState included); each
        field goes through np.array, so the source is copied, not shared.
        An ml_dtypes bfloat16 array (p under bf16_weights) becomes a
        torch.bfloat16 tensor with the same bits."""
        get = arrays.__getitem__ if isinstance(arrays, dict) else \
            (lambda f: getattr(arrays, f))
        return cls(**{f: _tensor(np.array(get(f))).to(device) for f in FIELDS})

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field, keyed by name.  A bfloat16 tensor
        comes back as an ml_dtypes bfloat16 array with the same bits where
        ml_dtypes is installed, else as its exact float32 upcast."""
        return {f: _array(getattr(self, f).detach().cpu()) for f in FIELDS}

    def clone(self) -> "SimState":
        """A deep copy (the CUDA step updates x, v and w in place)."""
        return SimState(**{f: getattr(self, f).clone() for f in FIELDS})


def _tensor(a: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16 of its own: ml_dtypes' type (JAX's) is named
    # "bfloat16" and torch.from_numpy refuses it, so carry its bits
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if importlib.util.find_spec("ml_dtypes") is None:
        return t.float().numpy()
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def balanced_live_mask(nparticle_max: int, nparticle_init: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Evenly-spread live mask with exactly nparticle_init True entries.

    The reference "unloads" the surplus (nparticle_max - nparticle_init)
    markers by shrinking each rank's live count (reference
    src/pic1dp_particle.F90:239-248); spreading the dead slots evenly keeps
    the work balanced however the particle axis is later split.
    """
    mask = np.zeros(nparticle_max, dtype=bool)
    # Bresenham spread: exactly nparticle_init evenly spaced indices.
    idx = (np.arange(nparticle_init, dtype=np.int64) * nparticle_max) // nparticle_init
    mask[idx] = True
    return torch.from_numpy(mask).to(device)
