"""pic1dp_tpu_torch — the pic1dp_tpu simulator on PyTorch and CUDA.

A port of pic1dp_tpu (the JAX/Pallas package beside it, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU: the same delta-f
Vlasov-Poisson particle-in-cell step, with the TPU's fused substep kernels
rewritten by hand in CUDA C++ (csrc/substep_kernels.cu), and the TPU's
stream-ceiling probes likewise (csrc/stream_probes.cu, run by the probes/
entry points).  It imports torch and never jax or pic1dp_tpu.

Public API:
    Config     — runtime configuration (a copy of pic1dp_tpu.config)
    SimState   — the per-run tensor state
    Simulation — end-to-end driver on an explicit device
"""

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.simulation import Simulation
from pic1dp_tpu_torch.core.state import SimState

__version__ = "0.1.0"

__all__ = ["Config", "SimState", "Simulation", "__version__"]
