"""Marker pushes a second through whole runs: the job's live markers times
the steps completed in the window, summed over its runs (the last one
partial), over the window's wall seconds (host clock, from the first run's
start to the snapshot that closed the window)."""


def read(r):
    first = r.results[0]
    return first["markers"] * first["steps"] / first["window_s"]
