"""BENCHMARK.json keeps its rules, and every configuration, traffic mix,
cell and metric is found by its name."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def bench():
    return spec.load()


def test_benchmark_json_keeps_the_rules(bench):
    raw = spec.BENCHMARK_JSON.read_bytes()
    assert spec.problems(json.loads(raw), len(raw)) == []


def test_everything_is_found_by_name(bench):
    for wl in bench["workloads"]:
        cfg = spec.config(bench, wl["config"])
        assert cfg["name"] == wl["config"]
        assert "program" in cfg and "reference" in cfg
        traffic = spec.traffic(wl["traffic"])
        assert traffic["output_interval"] > 0
        assert traffic.get("mesh", False) or wl["chips"] == 1
        limits = spec.cell(wl["name"])["limits"]
        assert set(limits) == {"state_rel", "record_rel", "bad_records"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_each_cell_reports_its_metrics(bench):
    for wl in bench["workloads"]:
        e2e = {m["name"] for m in spec.cell_metrics(bench, wl["name"], traced=False)}
        layers = {m["name"] for m in spec.cell_metrics(bench, wl["name"], traced=True)}
        assert e2e == {"pushes_per_s", "setup_s"}
        assert {"snapshot_ms", "push_roofline", "device_idle_pct"} <= layers
        assert ("allreduce_ms_per_step" in layers) == (wl["chips"] == 4)


def _broken(bench, edit):
    b = copy.deepcopy(bench)
    edit(b)
    return spec.problems(b)


@pytest.mark.parametrize("edit, words", [
    (lambda b: b["end_to_end"][0].update(unit="pushes per second"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="nothing_s"), "moves"),
    (lambda b: b["per_layer"][0].update(name="snapshot ms"), "name"),
    (lambda b: [w.update(chips=4) for w in b["workloads"]], "4 chips"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"][0].update(workloads=["bot_pre83.out05"]), "does not report"),
    (lambda b: b["per_layer"][1].update(why="a metric has no why"), "keys"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="again")), "pair repeats"),
    (lambda b: b["configs"][0].update(file="elsewhere/bot_pre83.json"), "under no path"),
    (lambda b: b["end_to_end"].pop(1), "setup_s"),
    (lambda b: b["per_layer"].append(dict(b["per_layer"][0], name="x_roofline", unit="ms")),
     "in %"),
])
def test_broken_copies_are_refused(bench, edit, words):
    found = _broken(bench, edit)
    assert any(words in p for p in found), found


def test_no_card_gives_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "bot_pre83.out05", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "bot_pre83.out05", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
