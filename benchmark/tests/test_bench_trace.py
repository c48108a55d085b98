"""The trace reducers and the per-layer readers on a recorded sample trace
(benchmark/tests/sample_trace.json: one profiled run from 1000 to 1100 us,
device ops and the benchmark's spans)."""

import os

import pytest

from benchmark import spec, trace
from benchmark.run import Reading

HERE = os.path.dirname(__file__)


@pytest.fixture
def summary():
    return trace.load(os.path.join(HERE, "sample_trace.json"))


def test_idle_share_is_the_union_of_device_ops_over_the_run(summary):
    # busy: [1015, 1027] + [1030, 1031] + [1050, 1070] + [1085, 1091] = 39 us
    assert summary.window_s == pytest.approx(100e-6)
    assert summary.busy_s == pytest.approx(39e-6)
    assert len(summary.ops) == 8             # the late kernel lies outside the run


def test_idle_gaps_are_named_by_the_span_the_host_was_in(summary):
    gaps = dict(summary.idle_gaps())
    assert gaps == pytest.approx({"bench.run": 24e-6, "bench.callback": 19e-6,
                                  "bench.run_start": 15e-6, "bench.output_snapshot": 3e-6})
    assert sum(gaps.values()) == pytest.approx(summary.window_s - summary.busy_s)


def test_device_ops_are_summed_by_name(summary):
    ops = dict(summary.device_ops())
    assert ops["void substep2_kernel<float, float, float, 1, 3, false, false>"] == \
        pytest.approx(12e-6)
    assert ops["void hist_kernel<float, 0>"] == pytest.approx(15e-6)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(1e-6)


def _reading(summary, steps=2):
    prog = spec.config(spec.load(), "bot_pre83")["program"]
    result = {"markers": 1000, "steps": 7, "window_s": 2.0, "setup_s": 3.0,
              "intervals": [0.001 * k for k in range(1, 101)], "output_s": 0.5,
              "output_calls": 100, "trace": {"steps": steps, "snapshots": 2}}
    return Reading(prog=prog, results=[result], traces=[summary])


@pytest.mark.parametrize("name, expected", [
    ("pushes_per_s", 1000 * 7 / 2.0),
    ("setup_s", 3.0),
    ("snapshot_ms", 5.0),
    ("kernels_per_step", 7 / 2),
    ("device_idle_pct", 61.0),
    ("allreduce_ms_per_step", 2e-6 / 2 * 1e3),
    ("push_roofline", 100.0 * (44 * 1000 / 3.35e12) / (20e-6 / 2)),
    ("hist_xv_roofline", 100.0 * ((20 * 1000 + 3 * 4096 * 4) / 3.35e12) / (18e-6 / 2)),
])
def test_each_metric_reader(summary, name, expected):
    assert spec.metric_reader(name)(_reading(summary)) == pytest.approx(expected)


def test_readers_that_find_nothing_return_none(summary):
    empty = trace.TraceSummary(window_s=1.0, busy_s=0.0, ops=[], idle_by_span={})
    for name in ("kernels_per_step", "device_idle_pct", "allreduce_ms_per_step",
                 "push_roofline", "hist_xv_roofline"):
        assert spec.metric_reader(name)(_reading(empty)) is None
