"""Device milliseconds of NCCL's kernels a step on rank 0 in the profiled
run: the all_reduces of the mode projections (two a step) and of the
snapshots' sums."""


def read(r):
    if not r.traces:
        return None
    nccl = r.traces[0].kernels(r"(?i)nccl")
    steps = r.results[0]["trace"]["steps"]
    return r.traces[0].seconds(nccl) / steps * 1e3 if nccl and steps else None
