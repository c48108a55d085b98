"""Cumulative wall-clock phase timers (a copy of pic1dp_tpu/utils/timers.py).

A re-design of the reference's 40-slot wtimer module (src/wtimer.F90:40-171)
and its end-of-run percentage table (src/pic1dp_output.F90:576-627):

  * phases are named, not numbered slots;
  * a context manager interface (`with timers.phase("push"):`) replaces
    start/stop pairs, which also fixes the reference's broken field-solve
    timer (src/pic1dp_field.F90:268 calls wtimer_start where wtimer_stop was
    intended — the context manager cannot make that mistake);
  * the host clock sees asynchronous device work only where a phase ends in
    a synchronisation; kernel times come from CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


class PhaseTimers:
    def __init__(self):
        self._acc: "OrderedDict[str, float]" = OrderedDict()
        self._count: dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._count[name] = self._count.get(name, 0) + count

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def report(self) -> str:
        """Percentage table in the spirit of reference output_wtimer
        (src/pic1dp_output.F90:576-627)."""
        total = self.total()
        lines = ["Info: timers:",
                 f"{'phase':>20} {'seconds':>12} {'% of total':>11} {'calls':>8}"]
        for name, sec in self._acc.items():
            pct = 100.0 * sec / total if total > 0 else 0.0
            lines.append(f"{name:>20} {sec:12.3f} {pct:10.1f}% {self._count[name]:8d}")
        lines.append(f"{'total':>20} {total:12.3f} {100.0:10.1f}%")
        return "\n".join(lines)
