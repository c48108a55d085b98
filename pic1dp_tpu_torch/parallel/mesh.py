"""Particle-axis sharding over processes (port of
pic1dp_tpu/parallel/mesh.py).

The reference's only distributed strategy is particle data-parallelism with
a replicated grid over flat MPI: each rank owns a contiguous block of the
particle Vecs (src/pic1dp_particle.F90:89-130), deposits onto a private
full grid, and MPI_Allreduces the grid (src/pic1dp_interaction.F90:130-135);
particles never migrate.

The PyTorch equivalent is one process per device in a torch.distributed job
(parallel/launch.py): each rank keeps one contiguous block of the particle
axis of every (nspecies, nparticle_max) array, and every field array is
replicated.  The ranks run the same Stepper code; its sums over markers
end in an all_reduce over the job's process group where the JAX package's
shard_map body has its psums: the (2, nmode) mode projections of each
substep and of the initial field, the EXPLICIT path's grid deposit, the
energies' partial sums, ptcldist's raw histograms and the |delta f|(v)
profile of particle optimization.  Those are the only collectives.

With one rank the sharded step is the unsharded step bit for bit: the
all_reduce of one rank returns its input.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch
import torch.distributed as dist

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.state import FIELDS, SimState
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.utils.timers import PhaseTimers

AXIS = "p"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D particle mesh: this process's place in it and its device.
    `group` is the torch.distributed process group the collectives run
    over; None for a mesh of one process outside any job (no collectives)."""

    group: object | None
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: int | None = None, device: torch.device | str = "cuda") -> Mesh:
    """The particle-parallel mesh over the processes of the torch.distributed
    job (the default group), one device each, or a mesh of one process
    outside a job.  `n_devices`, where given, must be the job's size.  A
    CUDA device without an index is cuda:LOCAL_RANK (torchrun's local rank);
    an explicit index is kept, so that several ranks may share one card."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, size, rank = None, 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"a mesh of {n_devices} devices needs a torch.distributed job of "
            f"{n_devices} processes, one a device (torchrun --nproc-per-node "
            f"{n_devices} ... with parallel.launch.initialize()); this job has {size}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(group=group, rank=rank, size=size, device=device)


def state_specs() -> dict[str, str | None]:
    """The mesh axis each SimState field's particle axis is split over:
    AXIS for the (nspecies, nparticle_max) particle arrays, None for the
    replicated field arrays."""
    return {f: AXIS if f in ("x", "v", "p", "w", "live") else None for f in FIELDS}


def local_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of this rank's contiguous block of n particle slots."""
    if n % mesh.size:
        raise ValueError(f"nparticle_max={n} must be divisible by the mesh size {mesh.size}")
    width = n // mesh.size
    return mesh.rank * width, (mesh.rank + 1) * width


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """This rank's part of a global state, on the mesh's device: its block
    of every particle array (a copy of its own) and the field arrays whole."""
    start, stop = local_block(state.x.shape[1], mesh)
    specs = state_specs()
    return SimState(**{
        f: (getattr(state, f)[:, start:stop] if specs[f] else getattr(state, f))
        .to(mesh.device).clone(memory_format=torch.contiguous_format)
        for f in FIELDS})


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s optimization dice in a mesh of more than one
    rank (cfg.rng.seed * 1,000,003 + 7,919 (rank + 1), mod 2^63): the ranks
    draw different dice, as the JAX package folds the axis index into the
    key (pic1dp_tpu/core/optimize.py:229-231).  A mesh of one rank keeps the
    single-device generator, and with it the single-device run's bits."""
    return (seed * 1_000_003 + 7_919 * (rank + 1)) % 2**63


class ShardedStepper(Stepper):
    """Stepper over this rank's block of the particle axis, every sum over
    markers all-reduced over the mesh's group (Stepper's `group`), so the
    single-device and multi-device paths share every line of physics.

    On a CUDA device with an NCCL group, multi_step replays CUDA graphs that
    hold the two all_reduces of each step (captured after the first eager
    call has made the communicator).  A gloo group's collectives cannot be
    captured: multi_step then runs eager steps, the kernels all the same."""

    def __init__(self, cfg: Config, mesh: Mesh, timers: PhaseTimers | None = None):
        if cfg.nparticle_max % mesh.size:
            raise ValueError(
                f"nparticle_max={cfg.nparticle_max} must be divisible by the "
                f"mesh size {mesh.size}")
        super().__init__(cfg, mesh.device, group=mesh.group, timers=timers)
        self.mesh = mesh

    def make_multi_step(self, k: int):
        """k steps as one call on a state (Stepper.multi_step)."""
        return functools.partial(self.multi_step, k=k)
