"""The mesh path's all_reduces in the port's timers (Stepper.reduce_sum):
counted ("all_reduces", "all_reduce bytes") and, where they run eagerly,
timed as the host phase "reduce".  A whole run on four gloo processes
counts two a step, two a snapshot and one more a snapshot at verbosity 3,
each of the bytes it sums; a run without a group counts none; what a CUDA
graph's capture counts is carried into its replays (CountedGraph, on the
card only).  This file imports no jax, so the card's machine runs its
`chip` test:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_reduce_counters.py -m chip"""

import json
import multiprocessing
import os

import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.utils.timers import PhaseTimers

WORLD = 4
KW = dict(nx=32, nparticle_max=WORLD * 1024, time_max=1.0, output_interval=0.25)
VERBOSITIES = (0, 3)
TIMEOUT = 300


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pic1dp_tpu_torch.parallel import launch

    launch.initialize(f"file://{os.path.join(workdir, 'rendezvous')}", WORLD, rank, "cpu")
    info = {}
    for verbosity in VERBOSITIES:
        sim = Simulation(bot(**dict(KW, verbosity=verbosity)), device="cpu", mesh=WORLD,
                         out_path=os.path.join(workdir, f"run{verbosity}"))
        sim.load()
        loaded = sim.timers.counters()
        snaps = []
        sim.run(snapshot_callback=snaps.append)
        info[verbosity] = {"steps": sim.itime, "snapshots": len(snaps), "loaded": loaded,
                           "counters": sim.timers.counters(),
                           "reduce_calls": sim.timers.calls("reduce"),
                           "report": sim.timers.report()}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's counts of a run at each verbosity, on four gloo processes."""
    workdir = str(tmp_path_factory.mktemp("reduce_counters"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, workdir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            out.append({int(v): info for v, info in json.load(fh).items()})
    return out


def _ran(info: dict) -> dict:
    """The counters a run added after its load."""
    return {name: n - info["loaded"].get(name, 0) for name, n in info["counters"].items()}


@pytest.mark.parametrize("verbosity", VERBOSITIES)
def test_two_all_reduces_a_step_and_two_a_snapshot(ranks, verbosity):
    for info in (r[verbosity] for r in ranks):
        steps, snaps = info["steps"], info["snapshots"]
        assert (steps, snaps) == (20, 5)
        assert info["loaded"]["all_reduces"] == 1          # the initial field's projections
        per_snapshot = 2 + (verbosity >= 3)                # + the live count at verbosity 3
        assert _ran(info)["all_reduces"] == 2 * steps + per_snapshot * snaps


@pytest.mark.parametrize("verbosity", VERBOSITIES)
def test_all_reduce_bytes_are_the_buffers(ranks, verbosity):
    cfg = bot(**dict(KW, verbosity=verbosity))
    item, ns, nmode = 4, cfg.nspecies, cfg.nmode
    projections = 2 * nmode * item
    energies = 3 * ns * item
    hists = 3 * ns * cfg.nv_opd * (cfg.nx_opd + 1) * item
    live = ns * 8 if verbosity >= 3 else 0
    for info in (r[verbosity] for r in ranks):
        assert info["loaded"]["all_reduce bytes"] == projections
        assert _ran(info)["all_reduce bytes"] == \
            2 * projections * info["steps"] + (energies + hists + live) * info["snapshots"]


@pytest.mark.parametrize("verbosity", VERBOSITIES)
def test_each_eager_all_reduce_is_a_reduce_phase(ranks, verbosity):
    for info in (r[verbosity] for r in ranks):
        assert info["reduce_calls"] == info["counters"]["all_reduces"]
        table = info["report"].splitlines()
        assert any(line.split()[:1] == ["reduce"] for line in table)
        assert any(line.startswith("all_reduces ") for line in table)
        assert any(line.startswith("all_reduce bytes ") for line in table)


def test_a_run_without_a_group_counts_none(tmp_path):
    sim = Simulation(bot(**dict(KW, verbosity=3)), out_path=str(tmp_path), device="cpu")
    sim.run()
    assert sim.timers.counter("all_reduces") == sim.timers.counter("all_reduce bytes") == 0
    assert sim.timers.calls("reduce") == 0 and "all_reduces" not in sim.timers.report()


def test_take_back_returns_what_the_counters_gained():
    t = PhaseTimers()
    t.count("kept", 2)
    before = t.counters()
    t.count("kept", 3)
    t.count("new", 7)
    assert t.take_back(before) == {"kept": 3, "new": 7}
    assert t.counters() == {"kept": 2}
    assert t.take_back(t.counters()) == {}


@pytest.mark.chip
def test_a_count_captured_in_a_graph_is_carried_into_its_replays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")
    from pic1dp_tpu_torch.core.step import CountedGraph

    t = PhaseTimers()
    buf = torch.zeros(4, device="cuda")

    def work():
        t.count("captured", 2)
        buf.add_(1.0)

    work()
    graph = CountedGraph(work, t)
    assert t.counter("captured") == 2 and graph.counts == {"captured": 2}
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert t.counter("captured") == 8 and t.counter("graph replays") == 3
    assert buf.tolist() == [4.0] * 4
