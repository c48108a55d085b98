"""The x-v snapshot histogram's (D1: hist_kernel of kind 0 and the row sum
that follows it) least time over its device time a call, in %: the marker
streams and the three channels read once and the histograms written once
(yardstick.hist_xv_need) for this card's markers of one species."""

import re

from benchmark.yardstick import hist_xv_need, least_seconds

DEPOSIT = re.compile(r"\bhist_kernel<[^,>]+,\s*0>")
ROW_SUM = re.compile(r"\bhist_sum_kernel<")
HIST = re.compile(r"\bhist_(sum_)?kernel<")


def read(r):
    if not r.traces:
        return None
    calls, seconds, last_was_xv = 0, 0.0, False
    for op in r.traces[0].kernels(HIST.pattern):
        if DEPOSIT.search(op.name):
            calls += 1
            seconds += op.dur * 1e-6
            last_was_xv = True
        elif ROW_SUM.search(op.name):
            if last_was_xv:
                seconds += op.dur * 1e-6
            last_was_xv = False
        else:
            last_was_xv = False
    if not calls:
        return None
    p = r.prog
    item = 8 if p["dtype"] == "float64" else 4
    n_bytes, n_ops = hist_xv_need(r.local_markers // len(p["species"]), 3,
                                  p["nx_opd"] * p["nv_opd"], item)
    need, _ = least_seconds(n_bytes, n_ops, item)
    return 100.0 * need / (seconds / calls)
