"""Share of the profiled run's wall in which the card ran no kernel, copy
or set (the union of the device ops' intervals), averaged over the cards."""


def read(r):
    if not r.traces or not all(t.ops for t in r.traces):
        return None
    return sum(100.0 * (1.0 - t.busy_s / t.window_s) for t in r.traces) / len(r.traces)
