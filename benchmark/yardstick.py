"""The yardstick: the H100's published peaks, what a step and a snapshot
histogram need whatever implements them, and the statistics the metrics
and bounds use.  Frozen here so that a change to the program cannot move
it.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
(the run prints the card's own limit beside them).

The step's need.  A step solves the field twice (the two RK2 substeps), so
whatever implements it reads each marker's x, v, w and p twice and writes
x, v and w once: 2 (3 f + p) + 3 f bytes a marker, f the state's itemsize
and p the weights' (44 B in float32, 40 with bfloat16 weights).  Its
operations are the smaller form of the two ways the repository's kernels
have counted them (chip_smoke.substep_ops at the time this benchmark was
written, an FMA counted as two): per marker per kept mode a gather and a
deposit of 4 + 13 nmode each plus the two pushes' 32 + 40, or the grid form's
7 + 9 a substep plus the pushes and 2 x 2 x 4 nx nmode a step for forming
and projecting the grids; bytes bound every configuration here by far.

The x-v histogram's need (D1): the marker streams x, v and its k value
channels read once, and the k (nv_opd x nx_opd) histograms written once;
14 + 8 k operations a marker.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 34e12}      # float32 and float64, outside the tensor cores
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_ops_per_s": OPS_PER_S[4],
         "f64_ops_per_s": OPS_PER_S[8], "source": "NVIDIA H100 SXM data sheet, 700 W"}


def least_seconds(n_bytes: float, n_ops: float, itemsize: int) -> tuple[float, str]:
    """The least time the card could take and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S[itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_need(markers: int, nmode: int, nx: int, itemsize: int, p_itemsize: int
              ) -> tuple[float, float]:
    """(bytes, operations) one RK2 step of `markers` markers needs."""
    n_bytes = markers * (2 * (3 * itemsize + p_itemsize) + 3 * itemsize)
    per_mode = 2 * (4 + 13 * nmode) * 2 + 32 + 40
    grid = 2 * (7 + 9) + 32 + 40
    n_ops = min(markers * per_mode, markers * grid + 16 * nx * nmode)
    return float(n_bytes), float(n_ops)


def hist_xv_need(markers: int, k: int, nbins: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of one x-v histogram of k channels over nbins."""
    return (float(markers * (2 + k) * itemsize + k * nbins * itemsize),
            float(markers * (14 + 8 * k)))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks (numpy's
    default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(values, n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
