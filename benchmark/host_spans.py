"""The device's idle time in the profiled run, split by what the host was
doing: every idle interval is cut at the edges of the host's spans, and each
piece goes to the innermost span that covers it, one of the benchmark's
("bench.*") or one of the program's own ("pic1dp.*", which the program
records when its timers' tracing is on); a piece that no span but the run
covers goes to "bench.run".  The shares sum to the run's wall less its busy
time.

trace.summarize names each whole gap by the span that holds its midpoint
instead; it does not call this yet.
"""

from __future__ import annotations

from benchmark.trace import DEVICE_CATS, RUN_SPAN

PREFIXES = ("bench.", "pic1dp.")


def idle_by_host_span(events: list[dict]) -> dict:
    """Span name -> idle seconds of the device inside the "bench.run"
    spans of a chrome trace's events."""
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), str(ev["name"]))
             for ev in events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
             and str(ev.get("name", "")).startswith(PREFIXES)]
    ops = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
           for ev in events if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    # a sweep over every edge: the open spans in the order they opened, the
    # runs and device ops open
    edges = [(a, 1, k) for k, (a, _, _) in enumerate(spans)] + \
        [(b, -1, k) for k, (_, b, _) in enumerate(spans)] + \
        [(a, 1, None) for a, _ in ops] + [(b, -1, None) for _, b in ops]
    edges.sort(key=lambda e: e[0])
    open_spans: list[int] = []
    runs = busy = 0
    idle: dict[str, float] = {}
    last = None
    for t, step, k in edges:
        if last is not None and t > last and runs and not busy:
            name = spans[open_spans[-1]][2]
            idle[name] = idle.get(name, 0.0) + (t - last) * 1e-6
        last = t
        if k is None:
            busy += step
            continue
        if spans[k][2] == RUN_SPAN:
            runs += step
        if step > 0:
            open_spans.append(k)
        else:
            open_spans.remove(k)
    return idle
