"""The step's least time over the substep kernels' device time a step, in
%.  The least time counts what a step needs whatever implements it
(yardstick.step_need: 44 B a marker in float32, 40 with bfloat16 weights),
for this card's markers; the device time is the sum of the profiled run's
substep kernels (rank 0), by name, over its steps."""

from benchmark.yardstick import least_seconds, step_need

SUBSTEP_KERNELS = r"\bsubstep[12]_kernel<"


def read(r):
    if not r.traces:
        return None
    ops = r.traces[0].kernels(SUBSTEP_KERNELS)
    steps = r.results[0]["trace"]["steps"]
    if not ops or not steps:
        return None
    p = r.prog
    item = 8 if p["dtype"] == "float64" else 4
    p_item = 2 if p.get("bf16_weights") else item
    n_bytes, n_ops = step_need(r.local_markers, len(p["modes"]), p["nx"], item, p_item)
    need, _ = least_seconds(n_bytes, n_ops, item)
    return 100.0 * need / (r.traces[0].seconds(ops) / steps)
