"""A snapshot's record reaches pic1dp.out after the next chunk is queued
(Simulation.run, SnapshotWriter.defer_snapshot / write_pending): the file
holds the bytes of a run that writes each record inside its snapshot, in
every case and however the run ends (its last snapshot, an exception from a
callback, the divergence check, an interrupt); a checkpoint finds the
snapshot's record on disk; "deferred writes" counts the records less the
last.  On four gloo processes, with the benchmark's stop flag an all_reduce
in every rank's callback, all ranks stop at one snapshot and rank 0's file
is the first records of the whole run.  This file imports no jax."""

import dataclasses
import datetime
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import OptimizationConfig, SpeciesConfig
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.config import landau_damping
from pic1dp_tpu_torch.io.writer import SnapshotWriter

# 9 snapshots a run, 40 steps
SMALL = dict(nx=32, nparticle_max=4096, time_max=2.0, output_interval=0.25, verbosity=0)
NSNAP = 9
THREE = (SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0, v0=0.0),
         SpeciesConfig(charge=1.0, mass=100.0, temperature=0.5, density=0.5, v0=0.0),
         SpeciesConfig(charge=1.0, mass=400.0, temperature=0.25, density=0.5, v0=0.0))


def _three_species():
    cfg = landau_damping(nx=SMALL["nx"], nparticle=SMALL["nparticle_max"],
                         time_max=SMALL["time_max"])
    return dataclasses.replace(cfg, species=THREE, dtype="float64", verbosity=0,
                               output_interval=SMALL["output_interval"]).validate()


CASES = {
    "one_species": lambda: bot(**SMALL),
    "three_species": _three_species,
    "diag_full_rho": lambda: bot(**dict(SMALL, diag_full_rho=True, dtype="float64")),
    "verbosity3": lambda: bot(**dict(SMALL, verbosity=3)),
    # merges at steps that follow a snapshot and that end at one
    "optimization": lambda: bot(**dict(SMALL, dtype="float64", optimization=OptimizationConfig(
        tmerge=(0.3, 1.0), thshmerge=(0.3, 0.3)))),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Stop(Exception):
    """Raised by a callback to end a run early."""


def _run(cfg, out_dir, at_once=False, callback=None, **kw) -> Simulation:
    """A run writing to out_dir/pic1dp.out; `at_once` writes each record
    inside its snapshot, as runs did before records were deferred."""
    sim = Simulation(cfg, out_path=str(out_dir), device="cpu", **kw)
    if at_once:
        sim.writer.defer_snapshot = sim.writer.write_snapshot
    sim.run(snapshot_callback=callback)
    return sim


def _header(cfg, tmp_path) -> int:
    with SnapshotWriter(cfg, str(tmp_path / "header")):
        pass
    return os.path.getsize(tmp_path / "header" / "pic1dp.out")


def _records(data: bytes, header: int, nrec: int, k: int) -> bytes:
    """The header and the first k of data's nrec records."""
    size = (len(data) - header) // nrec
    assert header + nrec * size == len(data)
    return data[:header + k * size]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_run_writes_the_bytes_of_records_written_at_once(tmp_path, case, capsys):
    cfg = CASES[case]()
    _run(cfg, tmp_path / "at_once", at_once=True)
    sim = _run(cfg, tmp_path / "deferred")
    want = (tmp_path / "at_once" / "pic1dp.out").read_bytes()
    assert (tmp_path / "deferred" / "pic1dp.out").read_bytes() == want
    assert sim.timers.calls("output") == NSNAP == sim.timers.calls("output: write")
    assert sim.timers.counter("deferred writes") == NSNAP - 1
    assert sim.timers.counter("bytes written") == len(want) - _header(cfg, tmp_path)


def test_a_callback_that_writes_to_its_arrays_leaves_the_records_as_they_were(tmp_path):
    def scribble(snap):
        for key in ("marker", "total", "pertb", "mode_re", "mode_im"):
            snap[key] *= 2.0

    cfg = bot(**SMALL)
    _run(cfg, tmp_path / "at_once", at_once=True, callback=scribble)
    _run(cfg, tmp_path / "deferred", callback=scribble)
    assert (tmp_path / "deferred" / "pic1dp.out").read_bytes() == \
        (tmp_path / "at_once" / "pic1dp.out").read_bytes()


def test_the_counter_sits_beside_bytes_written_and_is_0_without_a_writer(tmp_path):
    sim = _run(bot(**SMALL), tmp_path)
    names = [line.split()[0] + " " + line.split()[1] for line in
             sim.timers.report().split("Info: counters:")[1].strip().splitlines()]
    at = names.index("bytes written")
    assert names[at + 1] == "deferred writes"
    quiet = Simulation(bot(**SMALL), device="cpu")
    quiet.run()
    assert quiet.timers.counter("deferred writes") == 0
    assert "deferred writes" not in quiet.timers.report()


@pytest.mark.parametrize("exc", [Stop, KeyboardInterrupt])
@pytest.mark.parametrize("k", [0, 4, NSNAP - 1])
def test_a_callback_that_raises_leaves_the_records_up_to_its_snapshot(tmp_path, k, exc):
    cfg = bot(**SMALL)
    header = _header(cfg, tmp_path)
    whole = _run(cfg, tmp_path / "whole")
    full = (tmp_path / "whole" / "pic1dp.out").read_bytes()
    seen = []

    def callback(snap):
        # while a callback runs the file holds the records before its snapshot
        on_disk = (tmp_path / "stopped" / "pic1dp.out").read_bytes()
        assert on_disk == _records(full, header, NSNAP, len(seen))
        seen.append(snap["time"])
        if len(seen) == k + 1:
            raise exc

    sim = Simulation(cfg, out_path=str(tmp_path / "stopped"), device="cpu")
    with pytest.raises(exc):
        sim.run(snapshot_callback=callback)
    sim.writer.close()
    assert (tmp_path / "stopped" / "pic1dp.out").read_bytes() == \
        _records(full, header, NSNAP, k + 1)
    assert sim.timers.counter("deferred writes") == k
    assert whole.timers.counter("deferred writes") == NSNAP - 1


def test_a_checkpoint_finds_the_snapshots_record_on_disk(tmp_path):
    cfg = bot(**dict(SMALL, dtype="float64"))
    header = _header(cfg, tmp_path)
    _run(cfg, tmp_path / "at_once", at_once=True)
    full = (tmp_path / "at_once" / "pic1dp.out").read_bytes()
    seen, saved = [], []
    sim = Simulation(cfg, out_path=str(tmp_path / "run"), device="cpu",
                     checkpoint_interval=0.5, checkpoint_path=str(tmp_path / "ck"))
    os.makedirs(tmp_path / "ck")
    save = sim.save_checkpoint

    def save_checkpoint(*args, **kwargs):
        on_disk = (tmp_path / "run" / "pic1dp.out").read_bytes()
        saved.append(on_disk == _records(full, header, NSNAP, len(seen)))
        return save(*args, **kwargs)

    sim.save_checkpoint = save_checkpoint
    sim.run(snapshot_callback=seen.append)
    assert saved == [True] * 4       # t = 0.5, 1.0, 1.5, 2.0
    assert (tmp_path / "run" / "pic1dp.out").read_bytes() == full
    # a record a checkpoint wrote first is not written again after the chunk
    assert sim.timers.counter("deferred writes") == NSNAP - 4
    assert sim.timers.calls("output: write") == NSNAP


def test_a_diverged_run_leaves_its_non_finite_record_on_disk(tmp_path):
    cfg = bot(**dict(SMALL, dtype="float64"))

    def poison(sim):
        def callback(snap):
            if snap["time"] == pytest.approx(0.5):
                sim.state.w[0, 0] = float("nan")
        return callback

    files = {}
    for at_once in (True, False):
        out = tmp_path / str(at_once)
        sim = Simulation(cfg, out_path=str(out), device="cpu")
        if at_once:
            sim.writer.defer_snapshot = sim.writer.write_snapshot
        with pytest.raises(FloatingPointError, match="non-finite field energy"):
            sim.run(snapshot_callback=poison(sim))
        assert sim.time == pytest.approx(0.75)
        files[at_once] = (out / "pic1dp.out").read_bytes()
    assert files[False] == files[True]
    header = _header(cfg, tmp_path)
    size = (len(files[False]) - header) // 4          # t = 0, 0.25, 0.5, 0.75
    assert header + 4 * size == len(files[False])
    # the last record's scalars: its time, then the field energy
    time_, field = np.frombuffer(files[False][-size:][:16], dtype=">f8")
    assert time_ == pytest.approx(0.75) and not np.isfinite(field)


# ---- four gloo processes, the benchmark's stop flag in every callback ----

WORLD = 4
STOP_AT = 2
MESH_KW = dict(nx=32, nparticle_max=WORLD * 1024, time_max=1.0, output_interval=0.25,
               verbosity=0)
TIMEOUT = 240


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import json

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'rdv')}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT // 2))
    cfg = bot(**MESH_KW)
    info = {}
    whole = Simulation(cfg, out_path=os.path.join(workdir, "whole"), device="cpu", mesh=WORLD)
    whole.run()
    info["whole"] = {"steps": whole.itime, "counters": whole.timers.counters()}

    sim = Simulation(cfg, out_path=os.path.join(workdir, "stopped"), device="cpu", mesh=WORLD)
    flag = torch.zeros(1, dtype=torch.float64)
    count = [0]

    def window_over(snap):
        # as benchmark/session.py's stop: rank 0 decides, every rank agrees
        flag.fill_(1.0 if rank == 0 and count[0] == STOP_AT else 0.0)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        count[0] += 1
        if flag.item() > 0:
            raise Stop

    try:
        sim.run(snapshot_callback=window_over)
        info["stopped_at"] = None
    except Stop:
        info["stopped_at"] = count[0] - 1
        if sim.writer is not None:
            sim.writer.close()
    info["stopped"] = {"steps": sim.itime, "counters": sim.timers.counters()}
    dist.barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import json

    workdir = str(tmp_path_factory.mktemp("deferred_mesh"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, workdir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.1)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(timeout=30)
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return workdir, out


def test_every_rank_stops_at_the_snapshot_rank_0_chose(ranks):
    _, out = ranks
    assert [r["stopped_at"] for r in out] == [STOP_AT] * WORLD
    assert [r["stopped"]["steps"] for r in out] == [STOP_AT * 5] * WORLD
    assert [r["whole"]["steps"] for r in out] == [20] * WORLD


def test_rank_0s_file_is_the_whole_runs_first_records(ranks, tmp_path):
    workdir, _ = ranks
    full = open(os.path.join(workdir, "whole", "pic1dp.out"), "rb").read()
    stopped = open(os.path.join(workdir, "stopped", "pic1dp.out"), "rb").read()
    header = _header(bot(**MESH_KW), tmp_path)
    assert stopped == _records(full, header, 5, STOP_AT + 1)


def test_the_mesh_counts_its_all_reduces_and_rank_0_its_deferred_writes(ranks):
    _, out = ranks
    for rank, r in enumerate(out):
        for run, snaps in (("whole", 5), ("stopped", STOP_AT + 1)):
            c, steps = r[run]["counters"], r[run]["steps"]
            # the initial field's, two a step and two a snapshot: the
            # callback's stop flag is the harness's, not the program's
            assert c["all_reduces"] == 1 + 2 * steps + 2 * snaps, (rank, run)
            assert c.get("deferred writes", 0) == ((snaps - 1 if run == "whole" else STOP_AT)
                                                   if rank == 0 else 0), (rank, run)
