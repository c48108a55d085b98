"""Reduce a torch.profiler chrome trace to what the per-layer metrics read.

The profiler records the device's kernels, copies and sets and the
benchmark's own spans (record_function, names starting "bench."): one a
run, and inside it one per call of Simulation.output_snapshot, of
Stepper.multi_step and of the snapshot callback.  The profiled part is the
union of the "bench.run" spans.  The profiler now and then loses a batch of
device records, so what is read from it are sums and shares, never a count
that has to match.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUN_SPAN = "bench.run"
TOP = 10


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float   # us, the trace's clock
    dur: float     # us


@dataclasses.dataclass
class TraceSummary:
    window_s: float            # the profiled part's wall
    busy_s: float              # time in it with a device op running
    ops: list[DeviceOp]        # the device ops in it, by start
    idle_by_span: dict         # span name -> idle seconds of the device in it

    def kernels(self, pattern: str) -> list[DeviceOp]:
        rx = re.compile(pattern)
        return [op for op in self.ops if op.cat == "kernel" and rx.search(op.name)]

    def seconds(self, ops) -> float:
        return sum(op.dur for op in ops) * 1e-6

    def device_ops(self) -> list[list]:
        """The TOP device ops by total time: [[name, seconds], ...]."""
        total: dict[str, float] = {}
        for op in self.ops:
            name = short_name(op.name)
            total[name] = total.get(name, 0.0) + op.dur * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        return [[k, v] for k, v in sorted(self.idle_by_span.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list (template
    arguments may hold parentheses of their own), at most 200 characters."""
    if name.endswith(")") and not name.startswith("Memcpy"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:200]


def _union(intervals):
    """Merged [a, b) intervals of sorted (a, b) pairs."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list[dict]) -> TraceSummary:
    spans = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
             and str(ev.get("name", "")).startswith("bench.")]
    runs = _union(sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in spans
                         if ev["name"] == RUN_SPAN))
    if not runs:
        raise ValueError("the trace holds no bench.run span")
    ops = sorted((DeviceOp(str(ev.get("name", "")), ev["cat"], float(ev["ts"]),
                           float(ev["dur"]))
                  for ev in events if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS),
                 key=lambda op: op.start)
    inside = [op for op in ops
              if any(a <= op.start < b for a, b in runs)]
    window = sum(b - a for a, b in runs)
    busy_parts = []
    for a, b in runs:
        clipped = sorted((max(op.start, a), min(op.start + op.dur, b)) for op in inside
                         if op.start < b and op.start + op.dur > a)
        busy_parts += _union(clipped)
    busy = sum(b - a for a, b in busy_parts)

    # the spans inside a run, which do not overlap one another, by start, to
    # name each gap by what the host was doing
    leaves = sorted(((ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in spans
                     if ev["name"] != RUN_SPAN), key=lambda s: s[0])
    starts = [s[0] for s in leaves]
    idle: dict[str, float] = {}

    def name_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= leaves[i][1]:
            return leaves[i][2]
        return RUN_SPAN

    for a, b in runs:
        edges = [a] + [x for part in busy_parts if a <= part[0] < b for x in part] + [b]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                name = name_at(0.5 * (g0 + g1))
                idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return TraceSummary(window_s=window * 1e-6, busy_s=busy * 1e-6, ops=inside,
                        idle_by_span=idle)


def load(path: str) -> TraceSummary:
    with open(path) as fh:
        return summarize(json.load(fh)["traceEvents"])
