"""Time the substep kernels and the Stepper of two checkouts in turns.

    python -m pic1dp_tpu_torch.probes.turns OTHER_ROOT [THIS_ROOT=.]

Each turn is one process started in a checkout's root, which times that
checkout's own code with its own chip_smoke.py and kernel probe: every
substep kernel per call at the main case (6.4M markers, nx 192, f32 and
bf16_weights) and at each layout's verification case
(chip_smoke.time_kernels, CUDA-graph replays), with 16, 32 and 64 kept
modes at the main case in both nonlinear delta-f layouts, at bench.py's
headline (2^26 markers, nx 1024, f32 and bf16_weights;
kernel_probe.substep_rows) and with 32 kept modes there (the config's
layout, CUDA events), and the eager and graph Stepper at the main case,
with 32 kept modes and at the headline (chip_smoke.time_steppers); and
the host's ms per wrapper call of each
substep at 2^16 markers (enqueue only: the card finishes each call first).  The turns run OTHER, THIS, THIS, OTHER on one
card, so a drift of the card over the call falls on both; the last lines
give each row's two turns per checkout and the ratio THIS / OTHER of their
means, beside the spread between a checkout's own turns.  Both checkouts
build their kernels first, at once, and the substep source's ptxas lines
(registers, spills, shared memory) of every entry function the two builds
share by name are compared first.  Needs a CUDA card.
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
from pic1dp_tpu_torch.probes import kernel_probe, time_ms

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
for nmode in (16, 32, 64):
    for stream_v1, lay in ((True, "streamed"), (False, "recompute")):
        ms, _ = cs.time_kernels(cs.many_modes_cfg(nmode), None, stream_v1)
        for k, v in ms.items():
            if not k.endswith("_plain"):
                rows[f"{nmode} modes {lay} substep{k[7]}"] = v
for bf16 in (False, True):
    for r in kernel_probe.substep_rows(cs.BENCH_N, torch.device("cuda"), bf16):
        rows[f"headline {r.label}"] = r.ms
# 32 kept modes at the headline, the config's layout, CUDA events (no plain
# version: its per-mode temporaries take tens of GB at 2^26 markers)
cfg = cs.many_modes_cfg(32, nparticle_max=cs.BENCH_N, nx=cs.BENCH_NX)
x, v, p, w, (m0, m1, m2, m3), sp = cs._inputs(cfg, cs.BENCH_N, "cuda")
subs = FusedSubsteps(cfg, sp)
w1, v1, _ = subs.substep1(x, v, p, w, m0, m1)
dev = torch.device("cuda")
rows["headline 32 modes substep1"] = time_ms(lambda: subs.substep1(x, v, p, w, m0, m1), dev)
rows["headline 32 modes substep2"] = time_ms(
    lambda: subs.substep2(x, v, p, w, w1, v1, m2, m3, m0, m1), dev)
del x, v, p, w, w1, v1, subs
# host time of one wrapper call (enqueue only) at a size the card finishes first
x, v, p, w, (m0, m1, m2, m3), sp = cs._inputs(main, 1 << 16, "cuda")
subs = FusedSubsteps(main, sp)
w1, v1, _ = subs.substep1(x, v, p, w, m0, m1)
for name, fn in (("substep1", lambda: subs.substep1(x, v, p, w, m0, m1)),
                 ("substep2", lambda: subs.substep2(x, v, p, w, w1, v1, m2, m3, m0, m1))):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        fn()
    rows[f"host {name} wrapper call"] = (time.perf_counter() - t0) / 500 * 1e3
    torch.cuda.synchronize()
for label, cfg in (("main f32", main), ("32 modes f32", cs.many_modes_cfg(32)),
                   ("headline f32", head),
                   ("headline bf16", dataclasses.replace(head, bf16_weights=True))):
    mean = cs.time_steppers(cfg, smi)
    rows.update({f"{label} step {k}": mean[k] for k in ("eager", "graph")})
print(json.dumps({"card": smi, "rows": rows}))
"""

_BUILD = r"""
import json, re, sys
sys.path.insert(0, ".")
from pic1dp_tpu_torch.utils import nvcc
built = nvcc.load_all(["substep_kernels", "stream_probes"])
for lib in built:
    print(lib.path.name, "nvcc", round(lib.build_seconds, 1), file=sys.stderr)
entries, name = {}, None
for ln in built[0].log.splitlines():
    if "Compiling entry" in ln:
        # the anonymous namespace's name carries a hash of the file
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", re.search(r"'(\w+)'", ln).group(1))
        entries[name] = []
    elif name is not None and ("Used" in ln or "spill" in ln):
        entries[name].append(ln.split(":", 1)[-1].strip())
print(json.dumps(entries))
"""


def ptxas_diff(other: dict, this: dict) -> tuple[int, list]:
    """Entry functions both builds have: how many have equal ptxas lines,
    and the names of those that differ."""
    both = sorted(set(other) & set(this))
    return sum(other[k] == this[k] for k in both), [k for k in both if other[k] != this[k]]


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
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=root, stdout=subprocess.PIPE,
                               text=True) for root in (other, this)]
    logs = [b.communicate()[0] for b in builds]
    if any(b.returncode != 0 for b in builds):
        raise SystemExit("a build failed")
    ptxas = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    equal, differ = ptxas_diff(*ptxas)
    print(f"ptxas, substep_kernels: {len(ptxas[0])} entry functions in {other}, "
          f"{len(ptxas[1])} in {this}; of the {equal + len(differ)} they share by name "
          f"{equal} have equal lines, {len(differ)} differ: {differ}", flush=True)
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
