"""Multi-process launch (port of pic1dp_tpu/parallel/launch.py).

The reference launches with `mpiexec -n NPE_RUN ./pic1dp` over MPI
(reference run/Makefile:38-48).  The PyTorch equivalent is one process per
device, started by torchrun, which gives each process RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `initialize` joins them into one
torch.distributed job (NCCL between CUDA devices, gloo between CPU
processes).  Per step the processes exchange the (2, nmode) mode
projections, a few hundred bytes, twice.

Typical entry point, run by `torchrun --nproc-per-node N script.py`:

    from pic1dp_tpu_torch.parallel import launch
    launch.initialize()                      # no-op without torchrun's environment
    sim = Simulation(cfg, mesh=launch.global_mesh(), out_path="run")
    sim.run()                                # only rank 0 writes output
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pic1dp_tpu_torch.parallel.mesh import AXIS, Mesh, make_mesh

__all__ = ["AXIS", "Mesh", "global_mesh", "initialize", "is_io_process"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device: torch.device | str = "cuda") -> None:
    """torch.distributed.init_process_group over NCCL when `device` is a
    CUDA device, gloo otherwise.  Without arguments it reads torchrun's
    environment and is a no-op where that is absent (a single-process run),
    as the JAX version is without a coordinator."""
    if init_method is None and world_size is None:
        if not all(os.environ.get(k) for k in _ENV):
            return
        init_method = "env://"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world_size if world_size is not None else -1,
                            rank=rank if rank is not None else -1)


def global_mesh(device: torch.device | str = "cuda") -> Mesh:
    """The 1-D particle-parallel mesh over every process of the job."""
    return make_mesh(device=device)


def is_io_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
