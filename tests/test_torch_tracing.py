"""The port's timers and tracer (utils/timers.py) and where a run uses them:
phases nested with their self time, counters, the snapshot split into its
parts with its one device-to-host copy counted, the device-timed "step" phase
and its timing events, the pic1dp.* spans under torch.profiler, and that
tracing changes nothing a run writes."""

import gc
import json
import os
import time
import weakref

import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import OptimizationConfig
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.io.writer import SnapshotWriter
from pic1dp_tpu_torch.utils.timers import PhaseTimers

KW = dict(nx=64, nparticle_max=8192, time_max=1.0, dtype="float64", verbosity=0)
PARTS = ("output: device", "output: write")


def _run(tmp_path, trace, **kw):
    sim = Simulation(bot(**dict(KW, **kw)), out_path=str(tmp_path), device="cpu",
                     trace=trace)
    sim.run()
    return sim


def _spans(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [ev for ev in events if ev.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_nested_phases_and_self_time():
    t = PhaseTimers()
    for _ in range(2):
        with t.phase("output"):
            time.sleep(0.002)
            with t.phase("output: write"):
                time.sleep(0.001)
    with t.phase("output: write"):      # outside "output": not its child now
        pass
    with t.phase("step", count=10):
        pass
    assert t.calls("output") == 2 and t.calls("output: write") == 3
    assert t.calls("step") == 10
    inner = t.seconds("output: write")
    assert t.seconds("output") > inner > 0.002
    # self time: the parent's seconds less what ran inside it, and only that
    assert t.self_seconds("output") < t.seconds("output") - 0.002
    assert t.self_seconds("output: write") == t.seconds("output: write")
    rows = t.report().splitlines()
    assert rows[0] == "Info: timers:"
    assert [row.split()[0] for row in rows[2:]] == ["output", "output:", "step", "total"]
    assert rows[3].startswith("  output: write")


def test_counters():
    t = PhaseTimers()
    t.count("graph replays")
    t.count("graph replays", 3)
    t.count("bytes written", 100)
    assert t.counter("graph replays") == 4 and t.counter("bytes written") == 100
    assert t.counter("never") == 0
    rows = t.report().splitlines()
    cut = rows.index("Info: counters:")
    assert [row.split() for row in rows[cut + 1:]] == [["graph", "replays", "4"],
                                                       ["bytes", "written", "100"]]


class _Event:
    """A stand-in for torch.cuda.Event: each pair reads 2 ms."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.stream = None

    def record(self, stream):
        self.stream = stream

    def elapsed_time(self, end):
        assert self.stream is not None and end.stream is not None
        return 2.0


def test_device_phases_use_a_pool_of_events_and_wait_for_a_flush(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")

    def no_sync(*args):
        raise AssertionError("the tracer synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    _Event.made = 0
    cuda = torch.device("cuda", 0)
    t = PhaseTimers(tracing=True)
    for _ in range(3):
        with t.device_phase("step", cuda, 10):
            pass
    assert t.calls("step") == 0           # nothing read before a flush
    t.flush()
    assert t.calls("step") == 30 and t.seconds("step") == pytest.approx(0.006)
    for _ in range(3):
        with t.device_phase("step", cuda, 10):
            pass
    t.flush()
    assert _Event.made == 6               # three pairs, made once, used twice
    assert t.calls("step") == 60
    off = PhaseTimers()
    with off.device_phase("step", cuda, 10):
        pass
    off.flush()
    assert off.calls("step") == 0 and _Event.made == 6


def test_tracing_off_makes_no_span_and_no_event(tmp_path, monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim = _run(tmp_path / "out", trace=False)
    names = {ev["name"] for ev in _spans(prof, tmp_path / "trace.json")}
    assert not any(name.startswith("pic1dp.") for name in names)
    assert sim.timers.calls("step") == 0 and sim.itime == 20
    assert all(sim.timers.calls(part) == 3 for part in PARTS)


def test_tracing_on_nests_the_spans_in_the_callers(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            _run(tmp_path / "out", trace=True)
    spans = _spans(prof, tmp_path / "trace.json")
    caller = [ev for ev in spans if ev["name"] == "caller"]
    outputs = [ev for ev in spans if ev["name"] == "pic1dp.output"]
    assert len(caller) == 1 and len(outputs) == 3
    assert all(_inside(ev, caller[0]) for ev in outputs)
    found = {part: sorted((ev for ev in spans if ev["name"] == f"pic1dp.{part}"),
                          key=lambda ev: ev["ts"]) for part in PARTS}
    assert all(len(found[part]) == 3 for part in PARTS)
    assert all(any(_inside(ev, out) for out in outputs) for ev in found["output: device"])
    # a record is written outside its snapshot: after the next chunk is
    # queued, the last as the run ends
    writes = found["output: write"]
    assert all(_inside(ev, caller[0]) for ev in writes)
    assert not any(_inside(ev, out) for ev in writes for out in outputs)
    steps = sorted((ev for ev in spans if ev["name"] == "pic1dp.step"), key=lambda ev: ev["ts"])
    assert len(steps) == 2 and not any(_inside(ev, out) for ev in steps for out in outputs)
    outputs.sort(key=lambda ev: ev["ts"])
    for write, step, out in zip(writes, steps, outputs[1:]):
        assert step["ts"] + step["dur"] <= write["ts"]
        assert write["ts"] + write["dur"] <= out["ts"]
    assert outputs[-1]["ts"] + outputs[-1]["dur"] <= writes[-1]["ts"]


@pytest.mark.parametrize("verbosity, copies", [(0, 1), (3, 1)])
def test_every_snapshot_copy_is_counted(tmp_path, verbosity, copies, capsys):
    """One packed buffer a snapshot, the live counts in it at verbosity 3;
    on the CPU every snapshot runs the chain eagerly."""
    sim = _run(tmp_path, trace=False, verbosity=verbosity)
    snaps = sim.timers.calls("output")
    assert snaps == 3
    assert sim.timers.counter("snapshot d2h copies") == copies * snaps
    assert sim.timers.counter("snapshot d2h bytes") > 0
    assert sim.timers.counter("snapshot eager") == snaps
    assert sim.timers.counter("snapshot graph replays") == 0
    # the marker pass is the CUDA path's; the CPU runs energies and ptcldist
    assert sim.timers.counter("snapshot marker passes") == 0


def test_bytes_written_are_the_records(tmp_path):
    with SnapshotWriter(bot(**KW), str(tmp_path / "header")):
        pass
    header = os.path.getsize(tmp_path / "header" / "pic1dp.out")
    sim = _run(tmp_path / "run", trace=False)
    size = os.path.getsize(tmp_path / "run" / "pic1dp.out")
    assert sim.timers.counter("bytes written") == size - header
    assert sim.timers.calls("output: write") == 3


def test_tracing_writes_the_same_bytes(tmp_path):
    for trace in (False, True):
        _run(tmp_path / str(trace), trace=trace)
    off = (tmp_path / "False" / "pic1dp.out").read_bytes()
    assert off == (tmp_path / "True" / "pic1dp.out").read_bytes()


def test_the_step_phase_holds_the_steps_only_with_tracing(tmp_path):
    off = _run(tmp_path / "off", trace=False)
    assert "step" not in off.timers.report().split()
    on = _run(tmp_path / "on", trace=True)
    assert on.itime == 20 and on.timers.calls("step") == 20
    assert on.timers.seconds("step") > 0.0


def test_an_optimization_step_keeps_its_phases_with_tracing(tmp_path):
    """A step with a scheduled event runs outside multi_step: its parts are
    timed on the host, and "step" counts the other steps."""
    sim = _run(tmp_path, trace=True,
               optimization=OptimizationConfig(tmerge=(0.5,), thshmerge=(0.3,)))
    for phase in ("step: push pair", "optimize particle", "step: collect + solve"):
        assert sim.timers.calls(phase) == 1, phase
    assert sim.timers.calls("step") == sim.itime - 1


def test_a_traced_run_is_freed_when_it_ends(tmp_path):
    """The tracer holds nothing of the run, so a finished run goes at once,
    never by the cyclic collector."""
    sim = _run(tmp_path, trace=True)
    alive = [weakref.ref(sim), weakref.ref(sim.stepper), weakref.ref(sim.writer)]
    gc.disable()
    try:
        del sim
        assert [ref() for ref in alive] == [None, None, None]
    finally:
        gc.enable()
