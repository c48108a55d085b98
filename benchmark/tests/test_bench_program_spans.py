"""The device's idle time split at span edges and given to the innermost
host span (benchmark/host_spans.py), on the recorded sample trace and on a
sample with the program's own nested spans (sample_trace_program.json: one
run from 0 to 100 us)."""

import json
import os

import pytest

from benchmark import spec, trace
from benchmark.host_spans import idle_by_host_span

HERE = os.path.dirname(__file__)


def _events(name):
    with open(os.path.join(HERE, name)) as fh:
        return json.load(fh)["traceEvents"]


@pytest.mark.parametrize("name, expected", [
    ("sample_trace.json", {"bench.run_start": 10e-6, "bench.output_snapshot": 26e-6,
                           "bench.run": 18e-6, "bench.multi_step": 5e-6,
                           "bench.callback": 2e-6}),
    ("sample_trace_program.json", {
        "bench.run": 18e-6, "bench.output_snapshot": 2e-6, "pic1dp.output": 2e-6,
        "pic1dp.output: energies": 5e-6, "pic1dp.output: ptcldist": 10e-6,
        "pic1dp.output: fields": 4e-6, "pic1dp.output: write": 13e-6,
        "bench.callback": 2e-6, "bench.multi_step": 1e-6,
        "pic1dp.step: capture": 14e-6, "pic1dp.step": 2e-6}),
])
def test_idle_pieces_go_to_the_innermost_span(name, expected):
    idle = idle_by_host_span(_events(name))
    assert idle == pytest.approx(expected)
    summary = trace.load(os.path.join(HERE, name))
    assert sum(idle.values()) == pytest.approx(summary.window_s - summary.busy_s)


def test_idle_outside_every_run_is_not_counted():
    events = _events("sample_trace.json")
    # the late kernel at 1200 us lies outside the run; an idle stretch
    # before it, outside the run too, counts nowhere
    assert sum(idle_by_host_span(events).values()) == pytest.approx(61e-6)
    assert idle_by_host_span([ev for ev in events if ev["name"] != "bench.run"]) == {}


def test_a_traced_run_is_freed_when_it_ends(tmp_path):
    """With the program's tracer on (set by attribute, as a traced window
    would), the harness's spans and the tracer's events hold nothing of a
    finished run: it is freed at once, never by the cyclic collector."""
    import gc
    import weakref

    import torch

    from benchmark import session
    from pic1dp_tpu_torch.config import Config
    from pic1dp_tpu_torch.core.simulation import Simulation

    cfg = Config.from_dict(dict(spec.config(spec.load(), "bot_pre83")["program"],
                                nparticle_max=8192, time_max=1.0, verbosity=0))
    sim = Simulation(cfg, out_path=str(tmp_path / "run"), device="cpu")
    sim.timers.tracing = True
    session._span_method(sim, "output_snapshot", "bench.output_snapshot")
    session._span_method(sim.stepper, "multi_step", "bench.multi_step")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sim.run()
    assert sim.timers.calls("step") == sim.itime
    alive = [weakref.ref(sim), weakref.ref(sim.stepper)]
    gc.disable()
    try:
        del sim
        assert [ref() for ref in alive] == [None, None]
    finally:
        gc.enable()
