"""Device kernels in the profiled run (rank 0), snapshots' included, over
the steps it took."""


def read(r):
    if not r.traces:
        return None
    kernels = r.traces[0].kernels(".")
    steps = r.results[0]["trace"]["steps"]
    return len(kernels) / steps if kernels and steps else None
