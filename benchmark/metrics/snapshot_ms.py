"""Milliseconds a snapshot: the "output" phase of each run's
Simulation.timers (energies, x-v histograms, the host copies and the
record written; it ends in host copies, so its host clock covers the
device work), summed over the window's runs, over the snapshots taken."""


def read(r):
    first = r.results[0]
    if not first["output_calls"]:
        return None
    return first["output_s"] / first["output_calls"] * 1e3
