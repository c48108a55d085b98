"""The run's phase timers and counters, and its tracer (grown from a copy of
pic1dp_tpu/utils/timers.py).

A re-design of the reference's 40-slot wtimer module (src/wtimer.F90:40-171)
and its end-of-run percentage table (src/pic1dp_output.F90:576-627):

  * phases are named, not numbered slots;
  * a context manager interface (`with timers.phase("push"):`) replaces
    start/stop pairs, which also fixes the reference's broken field-solve
    timer (src/pic1dp_field.F90:268 calls wtimer_start where wtimer_stop was
    intended — the context manager cannot make that mistake);
  * a phase opened inside another is its child (the code names it
    "<parent>: <part>", as "output: device" inside "output"); the table
    prints each phase's seconds and its self time, its seconds less those
    of its children;
  * counters (`count`) add up what the run did: copies, bytes, replays,
    all_reduces; what is counted while a CUDA graph is captured is taken
    back (`take_back`) and counted again at each of its replays;
  * sums and counts are kept per name, never a record per call.

Host phases are on the host clock, which sees asynchronous device work only
where a phase ends in a synchronization.  `tracing` (off by default; a
Simulation's `trace`, run.py's --profile) adds two things:

  * device phases (`device_phase`, the Stepper's "step"): on a CUDA device
    the device seconds between two timing events recorded around the
    enqueued work, read by `flush` after a synchronization the caller makes
    anyway (the tracer never synchronizes); on the CPU, where the work runs
    as it is called, host seconds.  With tracing off a device phase records
    nothing;
  * while a torch.profiler records, every phase is also a record_function
    span named "pic1dp.<phase>", on the profiler's clock beside the
    device's kernels and copies.

With tracing off a phase costs a pair of perf_counter calls and a few adds.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import torch


class _Phase:
    """One call of a host phase (PhaseTimers.phase)."""

    __slots__ = ("timers", "name", "count", "span", "start")

    def __init__(self, timers: "PhaseTimers", name: str, count: int):
        self.timers, self.name, self.count = timers, name, count
        self.span = timers._span(name)

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        self.timers._open.append(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.start
        t = self.timers
        t._open.pop()
        parent = t._open[-1] if t._open else None
        if parent == self.name:     # a phase inside itself counts once
            parent = None
        t._parent.setdefault(self.name, parent)
        if parent is not None:
            t._inner[parent] = t._inner.get(parent, 0.0) + dt
        t.add(self.name, dt, self.count)
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


class _DevicePhase:
    """One call of a device phase on a CUDA device: a pair of timing events
    from the tracer's pool recorded around the work (PhaseTimers.device_phase)."""

    __slots__ = ("timers", "name", "count", "stream", "span", "events")

    def __init__(self, timers: "PhaseTimers", name: str, device: torch.device, count: int):
        self.timers, self.name, self.count = timers, name, count
        self.stream = torch.cuda.current_stream(device)
        self.span = timers._span(name)
        self.events = timers._events.pop() if timers._events else (
            torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.events[1].record(self.stream)
            self.timers._pending.append((self.name, *self.events, self.count))
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


class PhaseTimers:
    def __init__(self, tracing: bool = False):
        self.tracing = tracing
        self._acc: "OrderedDict[str, float]" = OrderedDict()
        self._count: dict[str, int] = {}
        self._inner: dict[str, float] = {}       # seconds of the phases run inside
        self._parent: dict[str, str | None] = {}  # the phase a phase first ran in
        self._open: list[str] = []               # the host phases open, innermost last
        self._counters: "OrderedDict[str, int]" = OrderedDict()
        self._events: list = []                  # free pairs of timing events
        self._pending: list = []                 # (name, start, end, count) to flush
        self._t0 = time.perf_counter()

    def _span(self, name: str):
        if self.tracing and torch.autograd._profiler_enabled():
            return torch.profiler.record_function(f"pic1dp.{name}")
        return None

    def phase(self, name: str, count: int = 1) -> _Phase:
        """A host-clock phase: `with timers.phase(name):`; `count` is what
        one call adds to its calls."""
        return _Phase(self, name, count)

    def device_phase(self, name: str, device: torch.device, count: int = 1):
        """`with timers.device_phase(name, device, count):` the device's
        time for the work enqueued inside (module docstring); nothing with
        tracing off.  A CUDA device's reading waits in the tracer until
        `flush`."""
        if not self.tracing:
            return _OFF
        if device.type != "cuda":
            return self.phase(name, count)
        return _DevicePhase(self, name, device, count)

    def flush(self) -> None:
        """Add the device phases recorded since the last flush.  Call it
        only after a synchronization that covers their work."""
        for name, start, end, count in self._pending:
            self.add(name, start.elapsed_time(end) * 1e-3, count)
            self._events.append((start, end))
        self._pending.clear()

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._count[name] = self._count.get(name, 0) + count

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name`."""
        self._counters[name] = self._counters.get(name, 0) + n

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def self_seconds(self, name: str) -> float:
        """A phase's seconds less those of the phases run inside it."""
        return self.seconds(name) - self._inner.get(name, 0.0)

    def calls(self, name: str) -> int:
        return self._count.get(name, 0)

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> dict[str, int]:
        """A copy of every counter."""
        return dict(self._counters)

    def take_back(self, before: dict[str, int]) -> dict[str, int]:
        """What the counters gained since `before` (a copy by `counters`),
        taken back out of them: the counts of work captured in a CUDA
        graph, which runs only when the graph is replayed."""
        gained = {name: n - before.get(name, 0) for name, n in self._counters.items()
                  if n != before.get(name, 0)}
        for name in gained:
            if name in before:
                self._counters[name] = before[name]
            else:
                del self._counters[name]
        return gained

    def report(self) -> str:
        """Percentage table in the spirit of reference output_wtimer
        (src/pic1dp_output.F90:576-627): each phase with its children
        indented below it, then the counters."""
        total = self.total()
        lines = ["Info: timers:",
                 f"{'phase':<28} {'seconds':>12} {'self':>12} {'% of total':>11} {'calls':>8}"]

        def rows(parent, depth):
            for name, sec in self._acc.items():
                if self._parent.get(name) == parent:
                    pct = 100.0 * sec / total if total > 0 else 0.0
                    label = "  " * depth + name
                    lines.append(f"{label:<28} {sec:12.3f} {self.self_seconds(name):12.3f} "
                                 f"{pct:10.1f}% {self._count[name]:8d}")
                    rows(name, depth + 1)

        rows(None, 0)
        lines.append(f"{'total':<28} {total:12.3f} {'':>12} {100.0:10.1f}%")
        if self._counters:
            lines.append("Info: counters:")
            lines += [f"{name:<28} {n:12d}" for name, n in self._counters.items()]
        return "\n".join(lines)
