"""The Stepper counts each substep of the species loop (the (bps, ns) grid of
one species a block: the grid bin, more than one species, a drive form
above 1, or a layout outside nonlinear delta-f;
FusedSubsteps.uses_species_loop) as "species-loop substeps": both substeps
of every step and of push_pair (a step with an optimization event), and, in
a CUDA graph, both of every replayed step.

On the CPU: a run counts two a step for two species, for one species at 32
modes, for the two-stream drive and in the linear and full-f layouts, and
none for one bump-on-tail or Maxwellian species in the register bins.  The
tests marked `chip` run on a CUDA device only: eager steps and a graph's
replays count two a step, as many as the substep kernels launched, and the
kernels a profiler records carry the template argument kSpecies as the
predicate says, in a case of each branch of the C dispatch (two species,
the two-stream drive, the linear and full-f layouts, and the main path's
kernel), so the Python predicate and the C dispatch cannot drift apart.  This
file imports no jax, so the card's machine runs it:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_species_loop_counter.py -m chip"""

import dataclasses
import json
import re

import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import OptimizationConfig, landau_damping, two_stream
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.examples import ion_acoustic

# several test workers share the machine (as tests/_torch_port.py)
torch.set_num_threads(2)

SMALL = dict(nparticle_max=4096, time_max=1.0, dtype="float64", verbosity=0)


def _ions(n: int = 4096, **kw):
    return dataclasses.replace(ion_acoustic.config(n, 1.0), verbosity=0, **kw).validate()


def _modes(nmode: int, **kw):
    return dataclasses.replace(bot(**dict(SMALL, nx=192, **kw)),
                               modes=tuple(range(1, nmode + 1))).validate()


def _full_f(n: int, **kw):
    return dataclasses.replace(landau_damping(nparticle=n, time_max=1.0, verbosity=0, **kw),
                               deltaf=False).validate()


# (config, whether its substeps run the species loop)
RUNS = {
    "two_species": (lambda: _ions(dtype="float64"), True),
    "two_species_f32": (lambda: _ions(), True),
    "modes_32": (lambda: _modes(32), True),
    "modes_32_events": (lambda: _modes(32, optimization=OptimizationConfig(
        tmerge=(0.3, 0.7), thshmerge=(0.3, 0.3))), True),
    "two_stream": (lambda: two_stream(nx=64, nparticle=4096, time_max=1.0, dtype="float64",
                                      verbosity=0), True),
    "linear": (lambda: bot(linear=True, **SMALL), True),
    "full_f": (lambda: _full_f(4096, dtype="float64"), True),
    "bump_on_tail": (lambda: bot(**SMALL), False),
    "bump_on_tail_events": (lambda: bot(optimization=OptimizationConfig(
        tmerge=(0.3, 0.7), thshmerge=(0.3, 0.3)), **SMALL), False),
    "maxwellian": (lambda: landau_damping(nparticle=4096, time_max=1.0, dtype="float64",
                                          verbosity=0), False),
    "modes_4": (lambda: _modes(4), False),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_a_run_counts_two_species_loop_substeps_a_step(case, tmp_path):
    """"species-loop substeps" is twice the steps run in the species loop,
    the steps of the optimization path (push_pair) included, and 0 where the
    main path's kernel runs."""
    make, loop = RUNS[case]
    sim = Simulation(make(), out_path=str(tmp_path), device="cpu")
    assert sim.stepper.substeps.uses_species_loop() == loop
    sim.run()
    assert sim.itime == 20
    assert sim.timers.counter("species-loop substeps") == (2 * sim.itime if loop else 0)


# ---- on a CUDA device ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the substep kernels run on the card only")
    return torch.device("cuda")


def _species_flags(names) -> list[bool]:
    """The template argument kSpecies of each substep kernel among the
    device kernels' names, demangled ("substep1_kernel<float, float, float,
    1, 3, true, false>") or mangled ("substep1_kernelIfffLi1ELi3ELb1ELb0E")."""
    flags = []
    for name in names:
        m = re.search(r"substep[12]_kernel<([^<>]*)>", name)
        if m:
            flags.append([a.strip() for a in m.group(1).split(",")][5] == "true")
            continue
        m = re.search(r"substep[12]_kernelI\w*?Li\d+ELi\d+ELb([01])ELb[01]E", name)
        if m:
            flags.append(m.group(1) == "1")
    return flags


# the chip's configs, one for each branch of launch_species
# (csrc/substep_kernels.cu): two species at 2 x 2^20 markers (the recompute
# layout, as the cell's 2 x 2^22), the two-stream drive (drive form 2), the
# linear and full-f layouts, and one bump-on-tail species at 2^21 (the main
# path's kernel)
CHIP_RUNS = {
    "two_species": (lambda: _ions(1 << 20), True),
    "two_stream": (lambda: two_stream(nx=64, nparticle=1 << 20, time_max=1.0, verbosity=0),
                   True),
    "linear": (lambda: bot(linear=True, nparticle_max=1 << 20, verbosity=0), True),
    "full_f": (lambda: _full_f(1 << 20), True),
    "bump_on_tail": (lambda: bot(nparticle_max=1 << 21, verbosity=0), False),
}


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CHIP_RUNS))
def test_graph_replays_count_the_species_loops_launches(case, cuda, tmp_path):
    """Eager steps and a CUDA graph's replayed steps each count two
    "species-loop substeps" in the species loop, as many as the substep
    kernels launched, none on the main path's kernel; the replays are the
    eager steps bit for bit; and every substep kernel a profiler records
    carries kSpecies as uses_species_loop says."""
    make, loop = CHIP_RUNS[case]
    cfg = make()
    graphed, eager = Stepper(cfg, cuda), Stepper(cfg, cuda)
    assert graphed.substeps.uses_species_loop() == loop
    assert not graphed.substeps.uses_grid_bin()
    s0 = graphed.initial_field(load_particles(cfg, cuda))
    a, b = s0.clone(), s0.clone()
    kernels = graphed.substeps.counters
    before = sum(k.launches for k in kernels)
    a = graphed.multi_step(a, 3)              # eager: loads the kernels
    a = graphed.multi_step(a, 7)              # one graph of 7 steps, replayed
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        a = graphed.multi_step(a, 7)
        torch.cuda.synchronize()
    for _ in range(17):
        b = eager.step(b)
    torch.cuda.synchronize()
    t = graphed.timers
    assert t.counter("graph replays") == 2
    counted = t.counter("species-loop substeps")
    assert counted == eager.timers.counter("species-loop substeps") == (2 * 17 if loop else 0)
    assert sum(k.launches for k in kernels) - before == 2 * 2 * 17
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    flags = _species_flags(ev.get("name", "") for ev in events if ev.get("cat") == "kernel")
    assert len(flags) == 2 * 7, flags
    assert set(flags) == {loop}
    for f in ("x", "v", "w", "mode_re", "mode_im"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
