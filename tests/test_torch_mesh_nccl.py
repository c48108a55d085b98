"""The particle-sharded run on four NCCL ranks, one card each (chip only;
skips with fewer than four CUDA devices): the step graphs' replays equal
eager steps bit for bit, the snapshot graph's replays equal the eager
snapshot bit for bit, a run with graphs writes the pic1dp.out of a run
without them byte for byte, and the all_reduces the program counts over a
profiled run are rank 0's NCCL kernels in the trace.  Four processes are
spawned once for the module (about a minute with the kernels built).  This
file imports no jax, so the card's machine runs it:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_nccl.py -m chip"""

import hashlib
import json
import multiprocessing
import os
import time
import traceback

import pytest
import torch

from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.core.state import FIELDS

WORLD = 4
STEPS = 10
TIMEOUT = 600
# the benchmark's bot_1e9_share at a 2^20-marker share a card, to t = 2
KW = dict(nx=4096, nparticle_max=WORLD << 20, time_max=2.0, verbosity=0)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit: dtype, shape and bytes."""
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.cpu().view(torch.uint8).equal(b.cpu().view(torch.uint8))


def _same_state(a, b) -> bool:
    return all(_same(getattr(a, f).contiguous(), getattr(b, f).contiguous()) for f in FIELDS)


def _nccl_kernels(prof, path: str) -> int:
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for ev in events
               if ev.get("cat") == "kernel" and "nccl" in ev.get("name", "").lower())


def _checks(rank: int, workdir: str) -> dict:
    from pic1dp_tpu_torch import Simulation

    cfg = bot(**KW)
    out = {}

    # the step graphs: captured over one state, replayed twice, against
    # eager steps (advance) from the same start
    sim = Simulation(cfg, device="cuda", mesh=WORLD)
    sim.load()
    st = sim.stepper
    eager = st.advance(sim.state.clone(), STEPS)
    st.multi_step(sim.state.clone(), STEPS)            # the eager first call
    graphed = st.multi_step(sim.state.clone(), STEPS)  # a capture and a replay
    out["step_replay"] = [_same_state(eager, graphed)]
    eager = st.advance(eager, STEPS)
    graphed = st.multi_step(graphed, STEPS)
    out["step_replay"].append(_same_state(eager, graphed))
    out["step_captures"] = st.timers.calls("step: capture")

    # the snapshot graph: its replays against the eager chain on the same
    # state, at two states
    layout = sim.snapshot_layout
    out["snapshot_replay"] = []
    for _ in range(2):
        want = st.snapshot(graphed, layout).cpu()
        graph = st.snapshot_graph(graphed, layout)
        graph.replay()
        out["snapshot_replay"].append(_same(graph.out, want))
        graphed = st.multi_step(graphed, STEPS)
    out["snapshot_captures"] = st.timers.counter("snapshot graph captures")
    del sim, st, eager, graphed, graph

    # whole runs: graphs against eager steps and snapshots, and a profiled
    # graph run whose NCCL kernels rank 0 counts in the trace
    digests = {}
    for kind in ("graph", "eager"):
        run = Simulation(cfg, out_path=os.path.join(workdir, kind), device="cuda", mesh=WORLD)
        if kind == "eager":
            run.stepper.snapshot_graph = lambda *args: None
            run.stepper.multi_step = run.stepper.advance
        run.run()
        if rank == 0:
            with open(os.path.join(workdir, kind, "pic1dp.out"), "rb") as fh:
                digests[kind] = hashlib.sha256(fh.read()).hexdigest()
        del run
    out["out_sha256"] = digests

    run = Simulation(cfg, out_path=os.path.join(workdir, "profiled"), device="cuda",
                     mesh=WORLD)
    run.load()
    torch.cuda.synchronize()
    before = run.timers.counter("all_reduces")
    if rank == 0:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run.run()
            torch.cuda.synchronize()
        out["nccl_kernels"] = _nccl_kernels(prof, os.path.join(workdir, "trace.json"))
    else:
        run.run()
    out["all_reduces"] = run.timers.counter("all_reduces") - before
    out["steps"], out["snapshots"] = run.itime, run.timers.calls("output")
    out["reduce_calls"] = run.timers.calls("reduce")
    out["report"] = run.timers.report()
    return out


def _rank_main(rank: int, workdir: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        import torch.distributed as dist

        from pic1dp_tpu_torch.parallel import launch

        launch.initialize(f"file://{os.path.join(workdir, 'rendezvous')}", WORLD, rank,
                          "cuda")
        out = _checks(rank, workdir)
        torch.cuda.synchronize()
        dist.barrier()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        # end at once: the other ranks would wait in a collective
        traceback.print_exc()
        os._exit(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices: the NCCL mesh runs one rank a card")
    from pic1dp_tpu_torch.utils import nvcc

    nvcc.load_all(["substep_kernels", "hist_kernels"])   # built once, before the ranks
    workdir = str(tmp_path_factory.mktemp("mesh_nccl"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, workdir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    print(json.dumps({k: v for k, v in out[0].items() if k != "report"}))
    print(out[0]["report"])
    return out


@pytest.mark.chip
def test_step_graph_replays_are_eager_steps_bit_for_bit(ranks):
    for r in ranks:
        assert r["step_replay"] == [True, True] and r["step_captures"] == 1


@pytest.mark.chip
def test_snapshot_graph_replays_are_the_eager_snapshot_bit_for_bit(ranks):
    for r in ranks:
        assert r["snapshot_replay"] == [True, True] and r["snapshot_captures"] == 1


@pytest.mark.chip
def test_a_graph_run_writes_the_eager_runs_pic1dp_out(ranks):
    digests = ranks[0]["out_sha256"]
    assert digests["graph"] == digests["eager"]


@pytest.mark.chip
def test_all_reduces_are_rank_0s_nccl_kernels(ranks):
    r0 = ranks[0]
    assert r0["snapshots"] == 5 and r0["steps"] == 40
    # the chain's two a snapshot and the step's two, eager or replayed
    assert r0["all_reduces"] == 2 * r0["steps"] + 2 * r0["snapshots"]
    assert r0["nccl_kernels"] == r0["all_reduces"]
    for r in ranks:
        assert r["all_reduces"] == r0["all_reduces"]
        assert 0 < r["reduce_calls"] < r["all_reduces"]   # the eager ones only
