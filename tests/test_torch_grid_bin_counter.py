"""The Stepper counts each substep of the grid bin (more than 4 kept modes,
FusedSubsteps.uses_grid_bin) as "grid-bin substeps": both substeps of every
step and of push_pair (a step with an optimization event), and, in a CUDA
graph, both of every replayed step; and those that deposit in the grid
bin's lane form (FusedSubsteps.uses_grid_lanes: nx 192 in f32) as
"grid-bin lane deposits".

On the CPU: a run counts two a step at 32 modes, the steps with an event
included, and none in the register bins (1 and 4 modes); two lane deposits
a step in the lane form (nx 192 in f32, nx 64 in f64) and none in the warp
form (nx 192 in f64, nx 1024) or with one kept mode.  The test
marked `chip` runs on a CUDA device only: eager steps and a graph's replays
count two a step, as many as the grid-bin substep kernels launched.  This file
imports no jax, so the card's machine runs it:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grid_bin_counter.py -m chip"""

import dataclasses

import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import OptimizationConfig
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper

# several test workers share the machine (as tests/_torch_port.py)
torch.set_num_threads(2)

SMALL = dict(nx=192, nparticle_max=4096, time_max=1.0, dtype="float64", verbosity=0)


def _modes(nmode: int, **kw):
    return dataclasses.replace(bot(**dict(SMALL, **kw)),
                               modes=tuple(range(1, nmode + 1))).validate()


# (config, whether its substeps run the grid bin)
RUNS = {
    "modes_32": (lambda: _modes(32), True),
    "modes_32_events": (lambda: _modes(32, optimization=OptimizationConfig(
        tmerge=(0.3, 0.7), thshmerge=(0.3, 0.3))), True),
    "modes_5": (lambda: _modes(5), True),
    "modes_4": (lambda: _modes(4), False),
    "modes_1": (lambda: _modes(1), False),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_a_run_counts_two_grid_bin_substeps_a_step(case, tmp_path):
    """"grid-bin substeps" is twice the steps run in the grid bin, the
    steps of the optimization path (push_pair) included, and 0 in the
    register bins."""
    make, grid = RUNS[case]
    sim = Simulation(make(), out_path=str(tmp_path), device="cpu")
    assert sim.stepper.substeps.uses_grid_bin() == grid
    sim.run()
    assert sim.itime == 20
    assert sim.timers.counter("grid-bin substeps") == (2 * sim.itime if grid else 0)


# (config, whether its substeps deposit in the grid bin's lane form)
LANE_RUNS = {
    "nx_192_f32": (lambda: _modes(32, dtype="float32"), True),
    "nx_192_f32_events": (lambda: _modes(32, dtype="float32", optimization=OptimizationConfig(
        tmerge=(0.3, 0.7), thshmerge=(0.3, 0.3))), True),
    "nx_64": (lambda: _modes(32, nx=64), True),
    "nx_192_f64": (lambda: _modes(32), False),
    "nx_1024_f32": (lambda: _modes(32, nx=1024, dtype="float32"), False),
    "modes_1": (lambda: _modes(1, dtype="float32"), False),
}


@pytest.mark.parametrize("case", list(LANE_RUNS))
def test_a_run_counts_two_lane_deposits_a_step(case, tmp_path):
    """"grid-bin lane deposits" is twice the steps run in the grid bin's lane
    form (nx 192 in f32, nx 64 in f64), push_pair's steps included, beside
    "grid-bin substeps", and 0 in its warp form (nx 192 in f64, nx 1024)
    and in the register bins."""
    make, lanes = LANE_RUNS[case]
    sim = Simulation(make(), out_path=str(tmp_path), device="cpu")
    subs = sim.stepper.substeps
    assert subs.uses_grid_lanes(1) == subs.uses_grid_lanes(2) == lanes
    sim.run()
    assert sim.itime == 20
    assert sim.timers.counter("grid-bin lane deposits") == (2 * sim.itime if lanes else 0)
    assert sim.timers.counter("grid-bin substeps") == (
        2 * sim.itime if subs.uses_grid_bin() else 0)


# ---- on a CUDA device ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the substep kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.chip
def test_graph_replays_count_two_grid_bin_substeps_a_step(cuda):
    """Eager steps and a CUDA graph's replayed steps at 32 kept modes each
    count two "grid-bin substeps" and, at nx 192, two "grid-bin lane
    deposits", as many as the substep kernels launched, and the replays are
    the eager steps bit for bit."""
    cfg = dataclasses.replace(bot(nparticle_max=1 << 21, verbosity=0),
                              modes=tuple(range(1, 33))).validate()
    graphed, eager = Stepper(cfg, cuda), Stepper(cfg, cuda)
    assert graphed.substeps.uses_grid_bin()
    s0 = graphed.initial_field(load_particles(cfg, cuda))
    a, b = s0.clone(), s0.clone()
    kernels = graphed.substeps.counters
    before = sum(k.launches for k in kernels)
    a = graphed.multi_step(a, 3)              # eager: loads the kernels
    a = graphed.multi_step(a, 7)              # one graph of 7 steps, replayed
    a = graphed.multi_step(a, 7)
    for _ in range(17):
        b = eager.step(b)
    torch.cuda.synchronize()
    t = graphed.timers
    assert t.counter("graph replays") == 2
    assert t.counter("grid-bin substeps") == 2 * 17 == eager.timers.counter("grid-bin substeps")
    assert t.counter("grid-bin lane deposits") == 2 * 17 == eager.timers.counter(
        "grid-bin lane deposits")
    assert sum(k.launches for k in kernels) - before == 2 * 2 * 17
    for f in ("x", "v", "w", "mode_re", "mode_im"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
