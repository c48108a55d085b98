"""The four-card cell bot_1e9_share.out05.x4 as BENCHMARK.json holds it, at
the CPU size of test_bench_faults.py in four gloo processes (the program's
plain versions stand where the cards run their kernels), judged by the
cell's own limits: a sound run is correct, a run whose all_reduces are left
out is not."""

import copy
import dataclasses
import json
import multiprocessing
import os

import pytest

from benchmark import run as brun, spec
from benchmark.tests.test_bench_faults import SEED, SMALL, _rank_main

CELL = "bot_1e9_share.out05.x4"


def test_the_cell_runs_four_processes_through_the_mesh():
    bench = spec.load()
    wl = spec.workload(bench, CELL)
    assert wl["chips"] == 4 and spec.traffic(wl["traffic"])["mesh"] is True
    # a configuration of its own (four of the sixteen shares), whose cards
    # each run one card's share as the one-card cell runs it
    base = spec.workload(bench, "bot_1e9_share.out05")["config"]
    assert wl["config"] != base
    assert spec.config(bench, wl["config"])["program"] == spec.config(bench, base)["program"]
    assert spec.config(bench, wl["config"])["chips"] == wl["chips"]
    assert [m["name"] for m in spec.cell_metrics(bench, CELL, True)
            if m.get("workloads") == [CELL]] == ["allreduce_ms_per_step"]


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_the_cell_is_correct_and_not_without_its_all_reduces(fault, tmp_path):
    bench = spec.load()
    cfg = copy.deepcopy(spec.config(bench, spec.workload(bench, CELL)["config"]))
    cfg["program"].update(SMALL)
    job = brun.make_job(bench, CELL, SEED, 0.5, False, False, "cpu", str(tmp_path), config=cfg)
    job.init_method = f"tcp://localhost:{brun._free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(dataclasses.asdict(job), r, fault))
             for r in range(job.ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert [p.exitcode for p in procs] == [0] * 4
    results = []
    for r in range(job.ranks):
        with open(os.path.join(job.out_dir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    line = brun.result_line(bench, job, results)     # the cell file's limits
    assert line["correct"] == (fault is None), line["compared"]
    assert line["device"]["count"] == 4
    assert results[0]["markers"] == 4 * SMALL["nparticle_max"]
