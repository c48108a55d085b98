"""Time the substep kernels and the Stepper of two checkouts in turns.

    python -m pic1dp_tpu_torch.probes.turns OTHER_ROOT [THIS_ROOT=.]

Each turn is one process started in a checkout's root, which times that
checkout's own code with its own chip_smoke.py and kernel probe: every
substep kernel per call at the main case (6.4M markers, nx 192, f32 and
bf16_weights) and at each layout's verification case
(chip_smoke.time_kernels, CUDA-graph replays), at bench.py's headline (2^26
markers, nx 1024, f32 and bf16_weights; kernel_probe.substep_rows), and
the eager and graph Stepper at the main case and the headline
(chip_smoke.time_steppers); and the host's ms per wrapper call of each
substep at 2^16 markers (enqueue only: the card finishes each call first).  The turns run OTHER, THIS, THIS, OTHER on one
card, so a drift of the card over the call falls on both; the last lines
give each row's two turns per checkout and the ratio THIS / OTHER of their
means, beside the spread between a checkout's own turns.  Both checkouts
build their kernels first, at once.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# what one turn runs, from the root of the checkout it times
_TURN = r"""
import dataclasses, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pic1dp_tpu_torch.config import bump_on_tail_default
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps
from pic1dp_tpu_torch.probes import kernel_probe

cs.say = lambda *a: print(*a, file=sys.stderr, flush=True)
smi = cs.card()
main = bump_on_tail_default(time_max=100.0, verbosity=0)
head = bump_on_tail_default(nparticle_max=cs.BENCH_N, nx=cs.BENCH_NX, verbosity=0)
rows = {}
cases = [("main f32", main, None), ("main bf16", dataclasses.replace(main, bf16_weights=True), None)]
for c in (cs.landau_cfg(linear=True), cs.landau_cfg(linear=True, bf16=True),
          cs.two_stream_cfg(), cs.two_stream_cfg(deltaf=False), cs.two_species_cfg(),
          cs.two_species_cfg(bf16=True)):
    cases.append((f"{c.nspecies}x{c.nparticle_max}", c, "loaded"))
for label, cfg, inputs in cases:
    ms, _ = cs.time_kernels(cfg, cs._loaded_inputs(cfg) if inputs else None)
    rows.update({f"{label} {k}": v for k, v in ms.items() if not k.endswith("_plain")})
for bf16 in (False, True):
    for r in kernel_probe.substep_rows(cs.BENCH_N, torch.device("cuda"), bf16):
        rows[f"headline {r.label}"] = r.ms
# host time of one wrapper call (enqueue only) at a size the card finishes first
x, v, p, w, (m0, m1, m2, m3), sp = cs._inputs(main, 1 << 16, "cuda")
subs = FusedSubsteps(main, sp)
w1, v1, _ = subs.substep1(x, v, p, w, m0, m1)
for name, fn in (("substep1", lambda: subs.substep1(x, v, p, w, m0, m1)),
                 ("substep2", lambda: subs.substep2(x, v, p, w, w1, v1, m2, m3))):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        fn()
    rows[f"host {name} wrapper call"] = (time.perf_counter() - t0) / 500 * 1e3
    torch.cuda.synchronize()
for label, cfg in (("main f32", main), ("headline f32", head),
                   ("headline bf16", dataclasses.replace(head, bf16_weights=True))):
    mean = cs.time_steppers(cfg, smi)
    rows.update({f"{label} step {k}": mean[k] for k in ("eager", "graph")})
print(json.dumps({"card": smi, "rows": rows}))
"""

_BUILD = ("import sys; sys.path.insert(0, '.'); from pic1dp_tpu_torch.utils import nvcc; "
          "[print(l.path.name, 'nvcc', round(l.build_seconds, 1)) "
          "for l in nvcc.load_all(['substep_kernels', 'stream_probes'])]")


def turn(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=root, capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    other = os.path.abspath(argv[0])
    this = os.path.abspath(argv[1] if len(argv) > 1 else ".")
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=root) for root in (other, this)]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("a build failed")
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        runs[name].append(turn(root))
        print(f"turn {name} ({root}) done on {runs[name][-1]['card']}", flush=True)
    out = {}
    for row in runs["this"][0]["rows"]:
        if row not in runs["other"][0]["rows"]:
            continue
        o = [r["rows"][row] for r in runs["other"]]
        t = [r["rows"][row] for r in runs["this"]]
        ratio = (sum(t) / 2) / (sum(o) / 2)
        spread = max(abs(o[0] - o[1]) / min(o), abs(t[0] - t[1]) / min(t))
        out[row] = dict(other=o, this=t, ratio=ratio, spread=spread)
        print(f"{row:<36} other {o[0]:.4f} {o[1]:.4f}  this {t[0]:.4f} {t[1]:.4f} ms  "
              f"this/other {ratio:.4f}  spread {spread:.2%}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
