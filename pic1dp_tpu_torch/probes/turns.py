"""Time the substep kernels and the Stepper, the bulk-copy ring, or the hat
deposits, of two checkouts in turns.

    python -m pic1dp_tpu_torch.probes.turns OTHER_ROOT [THIS_ROOT=.] [--ring | --hist | --tail]

Each turn is one process started in a checkout's root, which times that
checkout's own code with its own chip_smoke.py and kernel probe: every
substep kernel per call at the main case (6.4M markers, nx 192, f32 and
bf16_weights) and at each layout's verification case
(chip_smoke.time_kernels, CUDA-graph replays), at nine Landau species of
102,400 markers and at two of 102,400 (the species loop, one species per
block), with 16, 32 and 64 kept
modes at the main case in both nonlinear delta-f layouts, at bench.py's
headline (2^26 markers, nx 1024, f32 and bf16_weights;
kernel_probe.substep_rows) and with 32 kept modes there (the config's
layout, CUDA events), and the eager and graph Stepper at the main case,
with 32 kept modes, at the headline and at the nine and two species
(chip_smoke.time_steppers); and
the host's ms per wrapper call of each
substep at 2^16 markers (enqueue only: the card finishes each call first).
Each turn also hashes what both substeps write from one fresh state for
every timed case (SHA-256 of the outputs' bytes): a checksum equal in all
four turns shows the two checkouts' kernels give the same bits there.
The turns run OTHER, THIS, THIS, OTHER on one
card, so a drift of the card over the call falls on both; the last lines
give each row's two turns per checkout and the ratio THIS / OTHER of their
means, beside the spread between a checkout's own turns.  Both checkouts
build their kernels first, at once, and the substep source's ptxas lines
(registers, spills, shared memory) of every entry function the two builds
share by name are compared first.  Needs a CUDA card.

With --ring the turns time the stream kernels' ring instead, at 2^26
elements: overlap_probe's three ring rows (4 KB x 4, 8 KB x 4, 16 KB x 3)
at trig x0 and x4 and their compute rows, and pipeline_probe's rings
(stream_bulk at K = 0; "bulk 8 KB x 4 aliased" is the one the kernels line
reports), each at the checkout's own defaults, beside the direct-load rows
of the same probes as a control; only the stream source is built, and its
ptxas lines are compared.

With --hist the turns time the hat deposits of ops/hist_kernels.py at
chip_smoke.time_hists' shapes, in f32 (D1 hist_xv: 6.4M markers, the 64 x
64 grid, three channels; D2 profile: 2^21, nv 128; D3 grid_charge: 6.4M,
nx 192): each call (CUDA-graph replays) and its deposit and row-sum
kernels apart (probes.kernel_ms), with a SHA-256 of each output; a
snapshot of the main run (output_snapshot, CUDA events) with and without
diag_full_rho; the main run to t = 100 (host clock); the main graph step
(chip_smoke.time_steppers); and the SHA-256 of both substeps at every
case of the default turns, which must equal the other checkout's.  The
substep and hist sources are built, and both sources' ptxas lines are
compared.

With --tail the turns time the step around its two kernels: the graph
step (a STEPS-step graph replay, CUDA events, the least of three), the
idle share and the kernels a step of one replay under torch.profiler, for
the main case in f32 and bf16_weights, the headline, Landau damping at
102,400 markers, two-stream, nine species of 102,400 and 32 kept modes;
the phase table's step minus its two kernels (utils/phase_split.py) at
the main case, the headline and Landau; the main run to t = 100 (host
clock) in f32, bf16_weights and with diag_full_rho, with the SHA-256 of
each pic1dp.out; the SHA-256 of every case's state (x, v, w, the modes,
E, rho) after one eager step and a STEPS-step graph; and the substep
checksums of the default turns.  The substep and hist sources are built
first (the runs deposit snapshots), and the ptxas lines of every entry
function whose lines differ are printed for both checkouts.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

from pic1dp_tpu_torch.probes import kernel_ms

# the substep cases both turn scripts hash, and the hash (after `main`, the
# main case's config, is set)
_CASES = r"""
electron = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5, v0=0.0)
two = dataclasses.replace(cs.landau_damping_cfg(), species=(electron,) * 2).validate()


def checksum(cfg, inputs, stream_v1=None):
    # both substeps from one fresh state: SHA-256 of every output's bytes
    x, v, p, w, (m0, m1, m2, m3), sp = inputs
    subs = FusedSubsteps(cfg, sp, stream_v1=stream_v1)
    w1, v1, proj1 = subs.substep1(x, v, p, w, m0, m1)
    x2, v2, w2, proj2 = subs.substep2(x.clone(), v.clone(), p, w.clone(), w1, v1, m2, m3, m0, m1)
    h = hashlib.sha256()
    for t in (w1, v1, *proj1, x2, v2, w2, *proj2):
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


cases = [("main f32", main, None), ("main bf16", dataclasses.replace(main, bf16_weights=True), None)]
for c in (cs.landau_cfg(linear=True), cs.landau_cfg(linear=True, bf16=True),
          cs.two_stream_cfg(), cs.two_stream_cfg(deltaf=False), cs.two_species_cfg(),
          cs.two_species_cfg(bf16=True), cs.nine_species_cfg(), two):
    cases.append((f"{c.nspecies}x{c.nparticle_max}", c, "loaded"))
"""

# what one turn runs, from the root of the checkout it times
_TURN = r"""
import dataclasses, hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pic1dp_tpu_torch.config import SpeciesConfig, bump_on_tail_default
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps
from pic1dp_tpu_torch.probes import kernel_probe, time_ms

cs.say = lambda *a: print(*a, file=sys.stderr, flush=True)
smi = cs.card()
main = bump_on_tail_default(time_max=100.0, verbosity=0)
head = bump_on_tail_default(nparticle_max=cs.BENCH_N, nx=cs.BENCH_NX, verbosity=0)
rows, sums = {}, {}
""" + _CASES + r"""
for label, cfg, inputs in cases:
    make = (lambda: cs._loaded_inputs(cfg)) if inputs else (
        lambda: cs._inputs(cfg, cfg.nparticle_max, "cuda"))
    ms, _ = cs.time_kernels(cfg, make())
    rows.update({f"{label} {k}": v for k, v in ms.items() if not k.endswith("_plain")})
    sums[f"{label} {'bf16_weights' if cfg.bf16_weights else cfg.dtype} ns={cfg.nspecies}"] = \
        checksum(cfg, make())
    torch.cuda.empty_cache()
for nmode in (16, 32, 64):
    for stream_v1, lay in ((True, "streamed"), (False, "recompute")):
        cfg = cs.many_modes_cfg(nmode)
        ms, _ = cs.time_kernels(cfg, None, stream_v1)
        for k, v in ms.items():
            if not k.endswith("_plain"):
                rows[f"{nmode} modes {lay} substep{k[7]}"] = v
        sums[f"{nmode} modes {lay} ns=1"] = checksum(
            cfg, cs._inputs(cfg, cfg.nparticle_max, "cuda"), stream_v1)
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
                   ("headline bf16", dataclasses.replace(head, bf16_weights=True)),
                   ("9x102400 f32", cs.nine_species_cfg()), ("2x102400 f32", two)):
    mean = cs.time_steppers(cfg, smi)
    rows.update({f"{label} step {k}": mean[k] for k in ("eager", "graph")})
print(json.dumps({"card": smi, "rows": rows, "checksums": sums}))
"""

# what one turn of --ring runs: the ring rows and their direct-load controls
_RING_TURN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pic1dp_tpu_torch.ops import stream_probes as sp
from pic1dp_tpu_torch.probes import fresh_streams, overlap_probe, pipeline_probe, time_ms
from pic1dp_tpu_torch.probes.compute_probe import compute_ms, unit_row

smi = cs.card()
dev, n, k4 = torch.device("cuda"), 2**26, overlap_probe.K_TRIG
rows = {}
for c, (label, kernel, kw) in enumerate(overlap_probe.CASES):
    if kernel is sp.stream_bulk_units or label == "direct 4 blocks/SM":
        for k in (0, k4):
            rows[f"overlap {label} trig x{k}"] = unit_row(
                label, "trig", k, n, dev, 200 + 10 * k + c, kernel, **kw).ms
        rows[f"overlap {label} compute"] = compute_ms("trig", k4, n, dev, 220 + c, kernel, **kw)
for c, (label, kernel, kw, alias) in enumerate(pipeline_probe.CASES):
    if kernel is sp.stream_bulk or label == "default 4 blocks/SM aliased":
        ins = fresh_streams(pipeline_probe.N_READ, n, dev, seed=100 + c)
        rows[f"pipeline {label}"] = time_ms(
            lambda: kernel(ins, pipeline_probe.N_WRITE, alias, **kw), dev)
        del ins
print(json.dumps({"card": smi, "rows": rows}))
"""

# what one turn of --hist runs: the hat deposits, a snapshot, the main run,
# the main graph step and the substep checksums
_HIST_TURN = r"""
import dataclasses, hashlib, json, os, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import SpeciesConfig, bump_on_tail_default
from pic1dp_tpu_torch.ops import hist_kernels as hk
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps
from pic1dp_tpu_torch.probes import graph_ms

""" + inspect.getsource(kernel_ms).replace("REPS", "20") + r"""

cs.say = lambda *a: print(*a, file=sys.stderr, flush=True)
smi = cs.card()
dev = torch.device("cuda")
cfg = bump_on_tail_default()
lx, vm = cfg.lx, cfg.v_max
rows, sums = {}, {}


def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


for name, n in (("D1 hist_xv", cs.FULL_N), ("D2 profile", cs.OPT_N), ("D3 grid_charge", cs.FULL_N)):
    x, v, p, w, live = cs.hist_markers(n, 1, "float32", lx, vm, cs.SEED)
    if name.startswith("D1"):
        vals = cs.hist_vals(x[0], p[0], w[0], live[0])
        fn = lambda: hk.hist_xv(x[0], v[0], vals, lx, vm, cfg.nx_opd, cfg.nv_opd)
    elif name.startswith("D2"):
        fn = lambda: hk.profile(v, w, live, vm, cfg.nv)
    else:
        val = torch.where(live, w, 0.0) * -1.0
        fn = lambda: hk.grid_charge(x, val, lx, cfg.nx)
    sums[name] = digest(fn())
    rows[f"{name} kernel"] = graph_ms(fn, dev)
    split = kernel_ms(fn, dev)
    rows[f"{name} deposit"] = sum(m for k, m in split.items() if "hist_kernel" in k)
    rows[f"{name} row sum"] = sum(m for k, m in split.items() if "hist_sum_kernel" in k)
    del x, v, p, w, live
    torch.cuda.empty_cache()
main = bump_on_tail_default(time_max=100.0, verbosity=0)
with tempfile.TemporaryDirectory() as out:
    for flag in (False, True):
        sim = Simulation(dataclasses.replace(main, diag_full_rho=flag),
                         out_path=os.path.join(out, str(flag)), device="cuda")
        sim.load()
        sim.state = sim.stepper.multi_step(sim.state, 20)
        sim.output_snapshot()
        torch.cuda.synchronize()
        rows[f"snapshot{' diag_full_rho' if flag else ''}"] = cs._events_ms(sim.output_snapshot, 10)
        sim.writer.close()
        del sim
    sim = Simulation(main, out_path=os.path.join(out, "run"), device="cuda")
    start = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    rows["main run to t = 100 (s)"] = time.perf_counter() - start
    with open(os.path.join(out, "run", "pic1dp.out"), "rb") as fh:
        sums["main run pic1dp.out"] = hashlib.sha256(fh.read()).hexdigest()[:16]
    del sim
torch.cuda.empty_cache()
mean = cs.time_steppers(main, smi)
rows.update({f"main step {k}": mean[k] for k in ("eager", "graph")})
""" + _CASES + r"""
for label, c, inputs in cases:
    make = (lambda: cs._loaded_inputs(c)) if inputs else (
        lambda: cs._inputs(c, c.nparticle_max, "cuda"))
    sums[f"substeps {label} {'bf16_weights' if c.bf16_weights else c.dtype} ns={c.nspecies}"] = \
        checksum(c, make())
    torch.cuda.empty_cache()
for nmode in (16, 32, 64):
    for stream_v1, lay in ((True, "streamed"), (False, "recompute")):
        c = cs.many_modes_cfg(nmode)
        sums[f"substeps {nmode} modes {lay} ns=1"] = checksum(
            c, cs._inputs(c, c.nparticle_max, "cuda"), stream_v1)
print(json.dumps({"card": smi, "rows": rows, "checksums": sums}))
"""

# what one turn of --tail runs: graph steps, idle shares, the phase table's
# rest, the main runs' outputs, states after a graph and the substep
# checksums
_TAIL_TURN = r"""
import dataclasses, hashlib, json, os, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import SpeciesConfig, bump_on_tail_default
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps
from pic1dp_tpu_torch.utils.phase_split import measure_phase_split

cs.say = lambda *a: print(*a, file=sys.stderr, flush=True)
smi = cs.card()
STEPS = 50
rows, sums = {}, {}


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def profiled(st, state):
    # idle share and kernels a step of one STEPS-step graph replay
    with tempfile.TemporaryDirectory() as out:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            st.graph_steps(state, STEPS)
            torch.cuda.synchronize()
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return 1.0 - busy / (spans[-1][1] - spans[0][0]), len(spans) / STEPS


main = bump_on_tail_default(time_max=100.0, verbosity=0)
head = bump_on_tail_default(nparticle_max=cs.BENCH_N, nx=cs.BENCH_NX, verbosity=0)
bf16 = dataclasses.replace(main, bf16_weights=True)
for label, cfg in (("main f32", main), ("main bf16", bf16), ("headline f32", head),
                   ("landau 102400", cs.landau_damping_cfg()), ("two-stream", cs.two_stream_cfg()),
                   ("9x102400", cs.nine_species_cfg()), ("32 modes", cs.many_modes_cfg(32))):
    st = Stepper(cfg, "cuda")
    state = st.multi_step(st.initial_field(load_particles(cfg, "cuda")), 1)
    state = st.graph_steps(state, STEPS)
    torch.cuda.synchronize()
    sums[f"{label} state after 1 + {STEPS} graph steps"] = digest(
        state.x, state.v, state.w, state.mode_re, state.mode_im, state.electric, state.rho)
    rows[f"{label} graph step"] = min(
        cs._events_ms(lambda: st.graph_steps(state, STEPS), 1) / STEPS for _ in range(3))
    rows[f"{label} idle share"], rows[f"{label} kernels a step"] = profiled(st, state)
    if label in ("main f32", "headline f32", "landau 102400"):
        table = measure_phase_split(st, state, steps=10)
        rows[f"{label} step minus the two kernels"] = 1e3 * (
            table["full step (measured)"] - table["substep-1 kernel (fused)"]
            - table["substep-2 kernel (fused)"])
    del st, state
    torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as out:
    for label, cfg in (("f32", main), ("bf16_weights", bf16),
                       ("diag_full_rho", dataclasses.replace(main, diag_full_rho=True))):
        sim = Simulation(cfg, out_path=os.path.join(out, label), device="cuda")
        start = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        rows[f"main run {label} to t = 100 (s)"] = time.perf_counter() - start
        with open(os.path.join(out, label, "pic1dp.out"), "rb") as fh:
            sums[f"main run {label} pic1dp.out"] = hashlib.sha256(fh.read()).hexdigest()[:16]
        del sim
        torch.cuda.empty_cache()
""" + _CASES + r"""
for label, c, inputs in cases:
    make = (lambda: cs._loaded_inputs(c)) if inputs else (
        lambda: cs._inputs(c, c.nparticle_max, "cuda"))
    sums[f"substeps {label} {'bf16_weights' if c.bf16_weights else c.dtype} ns={c.nspecies}"] = \
        checksum(c, make())
    torch.cuda.empty_cache()
for nmode in (16, 32, 64):
    for stream_v1, lay in ((True, "streamed"), (False, "recompute")):
        c = cs.many_modes_cfg(nmode)
        sums[f"substeps {nmode} modes {lay} ns=1"] = checksum(
            c, cs._inputs(c, c.nparticle_max, "cuda"), stream_v1)
print(json.dumps({"card": smi, "rows": rows, "checksums": sums}))
"""

_BUILD = r"""
import json, re, sys
sys.path.insert(0, ".")
from pic1dp_tpu_torch.utils import nvcc
built = nvcc.load_all(sys.argv[1:])
for lib in built:
    print(lib.path.name, "nvcc", round(lib.build_seconds, 1), file=sys.stderr)
out = {}
for src, lib in zip(sys.argv[1:], built):
    entries, name = out.setdefault(src, {}), None
    for ln in lib.log.splitlines():
        if "Compiling entry" in ln:
            # the anonymous namespace's name carries a hash of the file
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", re.search(r"'(\w+)'", ln).group(1))
            entries[name] = []
        elif name is not None and ("Used" in ln or "spill" in ln):
            entries[name].append(ln.split(":", 1)[-1].strip())
print(json.dumps(out))
"""


def ptxas_diff(other: dict, this: dict) -> tuple[int, list]:
    """Entry functions both builds have: how many have equal ptxas lines,
    and the names of those that differ."""
    both = sorted(set(other) & set(this))
    return sum(other[k] == this[k] for k in both), [k for k in both if other[k] != this[k]]


def turn(root: str, script: str = _TURN) -> dict:
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = ("--ring", "--hist", "--tail")
    mode = next((a for a in argv if a in flags), None)
    argv = [a for a in argv if a not in flags]
    if not argv:
        raise SystemExit(__doc__)
    other = os.path.abspath(argv[0])
    this = os.path.abspath(argv[1] if len(argv) > 1 else ".")
    sources, script = {"--ring": (["stream_probes"], _RING_TURN),
                       "--hist": (["substep_kernels", "hist_kernels"], _HIST_TURN),
                       "--tail": (["substep_kernels", "hist_kernels"], _TAIL_TURN),
                       None: (["substep_kernels", "stream_probes"], _TURN)}[mode]
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD, *sources], cwd=root,
                               stdout=subprocess.PIPE, text=True) for root in (other, this)]
    logs = [b.communicate()[0] for b in builds]
    if any(b.returncode != 0 for b in builds):
        raise SystemExit("a build failed")
    ptxas = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    for src in sources:
        for root, built in zip((other, this), ptxas):
            if not built[src]:
                print(f"ptxas: no lines from {root}: its {src} library was built before this "
                      f"run (remove its pic1dp_tpu_torch/_build/ to compare)", flush=True)
        equal, differ = ptxas_diff(ptxas[0][src], ptxas[1][src])
        print(f"ptxas, {src}: {len(ptxas[0][src])} entry functions in {other}, "
              f"{len(ptxas[1][src])} in {this}; of the {equal + len(differ)} they share by "
              f"name {equal} have equal lines, {len(differ)} differ: {differ}", flush=True)
        if mode == "--tail":
            for name in differ:
                print(f"ptxas {name}\n  other {ptxas[0][src][name]}\n  this  "
                      f"{ptxas[1][src][name]}", flush=True)
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        runs[name].append(turn(root, script))
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
    sums = {}
    for row in runs["this"][0].get("checksums", {}):
        turns = [r.get("checksums", {}).get(row) for r in runs["other"] + runs["this"]]
        sums[row] = dict(other=turns[:2], this=turns[2:], equal=len(set(turns)) == 1)
        verdict = ("equal in all four turns" if sums[row]["equal"] else
                   "DIFFER; each checkout repeats its own" if len(set(turns[:2])) == 1 ==
                   len(set(turns[2:])) else "DIFFER, and a checkout does not repeat its own")
        print(f"checksum {row:<36} other {turns[0]} {turns[1]}  this {turns[2]} {turns[3]}  "
              f"{verdict}", flush=True)
    print(json.dumps({"rows": out, "checksums": sums}))
    return out


if __name__ == "__main__":
    main()
