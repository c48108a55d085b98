"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives pic1dp_tpu_torch's main paths — the default bump-on-tail run at its
full width of 6.4M markers, in f32 and with bf16_weights, through the
hand-written CUDA substep kernels, and the five probes through the stream
kernels — and checks them.  It imports neither jax nor pic1dp_tpu, catches
nothing, and exits non-zero at the first failed check.  Phases, each printed:

  1. environment: torch, CUDA, triton and nvcc versions, the card
  2. build: nvcc builds every kernel source of pic1dp_tpu_torch/csrc (each
     hashed with the headers beside it), one process per source, all at once
  3. each kernel against its plain PyTorch version on the same inputs:
     the substeps in f32 and bf16_weights at full width and in f64 with
     three modes, five Stepper steps in f32 and bf16, both stream kernels on
     every built pattern, both unit kernels for every unit and K in
     {0, 1, 4} at eps = 1 and 1e-12, and the carry kernel over 3 steps in
     every layout
  4. the main paths, each with its launch counts set to 0 just before and
     read just after: Simulation.run to t = 100 in f32 and in bf16_weights
     (launch counts, the pic1dp.out size and read-back, the growth rate
     against theory), then the kernel, pipeline, compute, overlap and
     pingpong probes at 2^26, each with the stream kernels' counts set to 0
     just before it
  5. timing: ms per call of each substep, unit and carry kernel and its
     plain version, and ms/step of the kernel and the plain Stepper at the
     main path's shape and at bench.py's headline shape (2^26 markers,
     nx 1024)

The last three lines of standard output are the card's name and power
limit, one JSON object on the kernels, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kinetic dispersion root of the default bump-on-tail case (k = 0.36):
# pic1dp_tpu.analysis.dispersion gives 1.16937651 + 0.08383105i
# (examples/bump_on_tail_pre83.py); tests/test_torch_io.py pins it.
BOT_OMEGA = complex(1.1693765077352976, 0.08383105105484892)
GAMMA_REL_TOL = 0.05
GAMMA_WINDOW = (25.0, 70.0)          # linear growth, as in the example's fit
FULL_N = 6_400_000                   # the default case's marker count
BENCH_N, BENCH_NX = 2**26, 1024      # bench.py's headline shape
F64_N = 262_144
# f32 bounds of tests/test_spectral_path.py:141-170: x and v absolute,
# w and the projections relative to their max
F32_TOL = dict(x=5e-5, v=1e-5, w=1e-4, proj=1e-4)
F64_TOL = 1e-12                      # relative to each field's max
# stream kernels: outputs bitwise equal to the plain version; the element
# sum (float64 in both, summed in another order) within this relative bound
STREAM_SUM_TOL = 1e-6
UNIT_KS = (0, 1, 4)                  # K compared for every unit
CARRY_STEPS = 3
PROBE_LOG2 = 26                      # 256 MB per stream: HBM, not the 50 MB L2
TIMING_STEPS, WARMUP_STEPS = 50, 5
SEED = 20261016


def say(*parts) -> None:
    print(*parts, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def periodic_err(a, b, lx: float) -> float:
    """Largest distance between two position sets on the periodic box (a
    marker at lx - 1 ulp in one and at 0 in the other is the same marker)."""
    d = torch.remainder(a.double() - b.double() + 0.5 * lx, lx) - 0.5 * lx
    return float(d.abs().max())


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b) -> float:
    return abs_err(a, b) / max(float(b.double().abs().max()), 1e-300)


def bf16_ulps(a, b, eta: float) -> dict:
    """|a - b| elementwise in units of one bfloat16 ulp of max(|a|, |b|)
    (2^(e-8) for a magnitude m * 2^e, m in [0.5, 1)): the largest, the
    number of elements that differ at all and beyond one ulp, at the worst
    element its magnitude and |a - b| relative to max|b|, and whether every
    element is within one ulp plus eta * max|b|."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    diff = (a - b).abs()
    ratio = torch.where(diff > 0, diff / ulp, torch.zeros_like(diff))
    worst = int(ratio.argmax())
    scale = float(b.abs().max())
    within = bool((diff <= ulp + eta * scale).all())
    return dict(within=within, ulps=float(ratio.max()), differ=int((diff > 0).sum()),
                beyond=int((ratio > 1).sum()), worst_mag=float(mag.flatten()[worst]),
                worst_rel=float(diff.flatten()[worst]) / scale,
                rel=float(diff.max()) / scale)


# ---- phases ----

def environment() -> str:
    from pic1dp_tpu_torch.utils.nvcc import find_nvcc

    say(f"[1 environment] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  torch.version.cuda {torch.version.cuda}")
    spec = importlib.util.find_spec("triton")
    tv = "absent" if spec is None else __import__("triton").__version__
    nvcc = find_nvcc()
    nv = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                        text=True, timeout=60).stdout.strip().splitlines()[-1]
    say(f"[1 environment] triton {tv}  nvcc {nvcc} ({nv})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1 environment] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}"
        f"  cudnn {torch.backends.cudnn.allow_tf32}")
    smi = card()
    say(f"[1 environment] card: {smi}  ({torch.cuda.get_device_name(0)},"
        f" {torch.cuda.device_count()} visible)")
    return smi


def build() -> None:
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.ops import substep_kernels as sk
    from pic1dp_tpu_torch.utils import nvcc

    start = time.perf_counter()
    for built in nvcc.load_all([sk.SOURCE, sp.SOURCE]):
        say(f"[2 build] {built.path.name}: nvcc {built.build_seconds:.1f} s")
        for line in built.log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                say(f"[2 build] {line.strip()}")
    sk.library()
    sp.library()
    say(f"[2 build] both libraries built in parallel and loaded in "
        f"{time.perf_counter() - start:.1f} s")


def _inputs(cfg, n: int, device: str):
    """A marker state as the loader makes one (x in [0, lx), v in
    [-v_max, v_max), p and w by the loader's formulas) from numpy draws,
    and mode components of a saturated amplitude."""
    from pic1dp_tpu_torch import distributions as dist
    from pic1dp_tpu_torch.core.loading import _initial_w

    rng = np.random.default_rng(SEED)
    dtype = getattr(torch, cfg.dtype)

    def t(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype).contiguous()

    x = t(rng.uniform(0.0, cfg.lx, (1, n)))
    v = t(rng.uniform(-cfg.v_max, cfg.v_max, (1, n)))
    sp = dist.SpeciesParams.from_config(cfg, dtype, device)
    p0 = dist.loader_weight_uniform(cfg.equilibrium, sp, v, cfg.lx, cfg.v_max,
                                    torch.full((1, 1), float(n), dtype=dtype, device=device))
    w = _initial_w(cfg, x, p0).contiguous()
    modes = [t(rng.uniform(-0.05, 0.05, cfg.nmode)) for _ in range(4)]
    p = (p0 + w).to(getattr(torch, cfg.p_dtype)).contiguous()
    return x, v, p, w, modes, sp


def compare_substeps(cfg, n: int, tol: dict | None) -> dict:
    """Both kernels and both plain versions on the same inputs; returns each
    kernel's largest absolute error; raises past the tolerance (tol None:
    F64_TOL relative to each field's max).  Under bf16_weights substep 1's
    w1 is held to one bfloat16 ulp per element: the kernel's float w1 may
    differ from torch's by an ulp (FMA contraction), which flips the
    rounding of a few markers."""
    from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps

    x, v, p, w, (mre0, mim0, mre1, mim1), sp = _inputs(cfg, n, "cuda")
    subs = FusedSubsteps(cfg, sp)
    kw1, kv1, kproj1 = subs.substep1(x, v, p, w, mre0, mim0)
    pw1, pv1, pproj1 = subs.substep1_plain(x, v, p, w, mre0, mim0)
    streams = [t.clone() for t in (x, v, w)]
    kx2, kv2, kw2, kproj2 = subs.substep2(*streams[:2], p, streams[2], kw1, kv1, mre1, mim1)
    streams = [t.clone() for t in (x, v, w)]
    px2, pv2, pw2, pproj2 = subs.substep2_plain(*streams[:2], p, streams[2],
                                               kw1, kv1, mre1, mim1)
    torch.cuda.synchronize()
    bf16 = cfg.bf16_weights
    pairs = {"substep1": dict(w=(kw1, pw1), v=(kv1, pv1), proj=(
                 torch.stack(kproj1), torch.stack(pproj1))),
             "substep2": dict(x=(kx2, px2), v=(kv2, pv2), w=(kw2, pw2), proj=(
                 torch.stack(kproj2), torch.stack(pproj2)))}
    check(kw1.dtype == pw1.dtype == p.dtype and kv1.dtype == kx2.dtype == x.dtype,
          f"substep output dtypes (w1 {kw1.dtype}, v1 {kv1.dtype}, x2 {kx2.dtype})")
    worst = {}
    for name, fields in pairs.items():
        errs = []
        for field, (a, b) in fields.items():
            check(bool(torch.isfinite(a).all()), f"{name} {field} finite")
            if bf16 and name == "substep1" and field == "w":
                u = bf16_ulps(a, b, tol["w"])
                say(f"[3 compare] bf16 n={n} substep1 w1: {u['differ']} of {a.numel()} "
                    f"markers differ, {u['beyond']} by more than one bf16 ulp; worst "
                    f"{u['ulps']:g} ulp at |w1| {u['worst_mag']:.3e} ({u['worst_rel']:.3e} "
                    f"of max); max abs err {u['rel']:.3e} of max; every marker within "
                    f"one ulp + {tol['w']:g} of max: {u['within']}")
                check(u["within"], f"bf16 w1 within one bf16 ulp + {tol['w']} of max")
                errs.append(abs_err(a, b))
                continue
            ab = periodic_err(a, b, cfg.lx) if field == "x" else abs_err(a, b)
            rel = ab / max(float(b.double().abs().max()), 1e-300)
            limit = F64_TOL if tol is None else tol[field]
            measured = rel if (tol is None or field in ("w", "proj")) else ab
            say(f"[3 compare] {cfg.dtype}{'/bf16' if bf16 else ''} n={n} "
                f"modes={cfg.modes} {name} {field}: "
                f"max abs err {ab:.3e}, rel to max {rel:.3e} (limit {limit:g})")
            check(measured <= limit, f"{name} {field} {cfg.dtype} within {limit}")
            errs.append(ab)
        worst[name + ("_bf16" if bf16 else "")] = max(errs)
    return worst


def trig_accuracy() -> None:
    """The kernels' grid-angle sin/cos against float64, for every
    realizable angle 2 pi (m ix0 mod nx) / nx; bound of
    tests/test_spectral_path.py:338-368 (2 f32 ulp at 1)."""
    from pic1dp_tpu_torch.ops.substep_kernels import grid_angle_f32

    worst = 0.0
    for nx in (64, 192, 1024):
        for m in (1, 2, 3, 4, 7, 8):
            k = (m * np.arange(nx)) % nx
            c, s = grid_angle_f32(torch.from_numpy(k.astype(np.int32)).cuda(), nx)
            th = 2.0 * np.pi * k / nx
            worst = max(worst, float(np.abs(c.cpu().numpy() - np.cos(th)).max()),
                        float(np.abs(s.cpu().numpy() - np.sin(th)).max()))
    say(f"[3 compare] grid-angle trig: max abs err {worst:.3e} (limit 2.4e-07)")
    check(worst < 2 * 1.2e-7, "grid-angle trig within 2 f32 ulp")


def compare_steppers(cfg) -> None:
    """The kernel Stepper against the plain-version Stepper, 5 steps from
    one loaded state, f32 bounds."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    kern, plain = Stepper(cfg, "cuda"), Stepper(cfg, "cuda", plain=True)
    a = kern.initial_field(load_particles(cfg, "cuda"))
    b, c = a.clone(), a.clone()
    a, b = kern.multi_step(a, 5), plain.multi_step(b, 5)
    c = kern.multi_step(c, 5)
    torch.cuda.synchronize()
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    check(a.p.dtype == getattr(torch, cfg.p_dtype) and a.w.dtype == getattr(torch, cfg.dtype),
          f"{label} Stepper keeps p {cfg.p_dtype} and w {cfg.dtype}")
    same = all(torch.equal(getattr(a, f), getattr(c, f))
               for f in ("x", "v", "w", "mode_re", "mode_im"))
    say(f"[3 compare] {label} kernel Stepper run twice from one state: bitwise equal {same}")
    check(same, "kernel steps repeat bit for bit (no float atomics)")
    errs = dict(x=periodic_err(a.x, b.x, cfg.lx), v=abs_err(a.v, b.v),
                w=rel_err(a.w, b.w), proj=max(rel_err(a.mode_re, b.mode_re),
                                             rel_err(a.mode_im, b.mode_im)))
    say(f"[3 compare] {label} Stepper 5 steps, kernel vs plain, n={cfg.nparticle_max}: "
        + ", ".join(f"{k} {v:.3e} (limit {F32_TOL[k]:g})" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= F32_TOL[k], f"Stepper {k} within {F32_TOL[k]}")


def stream_cases():
    """(label, kernel, keyword arguments, reads, writes, alias) of every
    built pattern under stream_rw and the default stream_bulk ring, and the
    pipeline probe's other rings on the substep-2 pattern."""
    from pic1dp_tpu_torch.ops.stream_probes import stream_bulk, stream_rw
    from pic1dp_tpu_torch.probes import kernel_probe, pipeline_probe

    for label, nr, nw, alias in kernel_probe.TPU_PATTERNS + kernel_probe.PORT_PATTERNS:
        yield "stream_rw", stream_rw, {}, nr, nw, alias, label
        yield "stream_bulk", stream_bulk, {}, nr, nw, alias, label
    for label, kernel, kw, alias in pipeline_probe.CASES:
        if kernel is stream_bulk:
            yield "stream_bulk", kernel, kw, pipeline_probe.N_READ, \
                pipeline_probe.N_WRITE, alias, label


def compare_streams(n: int) -> dict:
    """Each stream kernel against stream_plain on fresh copies of the same
    inputs (an odd n, so the masked tails run): outputs and inputs bitwise
    equal after the call, the element sum within STREAM_SUM_TOL."""
    from pic1dp_tpu_torch.ops.stream_probes import stream_plain
    from pic1dp_tpu_torch.probes import fresh_streams

    worst = {"stream_rw": 0.0, "stream_bulk": 0.0}
    for k, (name, kernel, kw, nr, nw, alias, label) in enumerate(stream_cases()):
        base = fresh_streams(nr, n, torch.device("cuda"), seed=k)
        a, b = [t.clone() for t in base], [t.clone() for t in base]
        outs_k, sum_k = kernel(a, nw, alias, **kw)
        outs_p, sum_p = stream_plain(b, nw, alias)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(outs_k + a, outs_p + b))
        err = max(abs_err(x, y) for x, y in zip(outs_k, outs_p))
        rel = abs(float(sum_k) - float(sum_p)) / abs(float(sum_p))
        say(f"[3 compare] {name} {kw or ''} {label} n={n}: outputs and inputs bitwise "
            f"equal {same}; sum rel err {rel:.3e} (limit {STREAM_SUM_TOL:g})")
        check(same, f"{name} {label} {kw} bitwise equal to stream_plain")
        check(rel <= STREAM_SUM_TOL, f"{name} {label} sum within {STREAM_SUM_TOL}")
        worst[name] = max(worst[name], err)
        del base, a, b, outs_k, outs_p
    return worst


def _unit_streams(n: int, seed: int, cancel: bool):
    """The unit kernels' inputs: x in [0, lx) and three streams in [0, 1),
    or with `cancel` x, -x, 0, 0, whose acc is exactly 0 so that every
    output at eps = 1 is the units' sum itself."""
    from pic1dp_tpu_torch.probes.compute_probe import unit_inputs

    ins = unit_inputs(n, torch.device("cuda"), seed)
    if cancel:
        ins[1].copy_(-ins[0])
        ins[2].zero_()
        ins[3].zero_()
    return ins


def compare_units(n: int) -> dict:
    """Both unit kernels against stream_units_plain on fresh copies of the
    same inputs, for every unit and K in UNIT_KS (an odd n, so the masked
    tails run): at eps = 1 with acc = 0 the units' sum within
    units_tolerance; at eps = 1e-12 every output within one float32 ulp of
    the plain value (the kernel may contract to FMA) and bitwise at K = 0,
    the element sum within STREAM_SUM_TOL."""
    from pic1dp_tpu_torch.ops import stream_probes as sp

    worst = {"stream_units": 0.0, "stream_bulk_units": 0.0}
    case = 0
    for kernel in (sp.stream_units, sp.stream_bulk_units):
        name = kernel.__name__
        for unit in sp.UNITS:
            for k in UNIT_KS:
                case += 1
                base = _unit_streams(n, case, cancel=True)
                a, b = [t.clone() for t in base], [t.clone() for t in base]
                (ek, *_), _ = kernel(a, sp.ALIAS, unit, k, eps=1.0)
                (ep, *_), _ = sp.stream_units_plain(b, sp.ALIAS, unit, k, eps=1.0)
                err = (ek.double() - ep.double()).abs()
                tol = sp.units_tolerance(unit, k, ep).double()
                over = float((err / tol.clamp_min(1e-30)).max())
                torch.cuda.synchronize()
                base = _unit_streams(n, case, cancel=False)
                a, b = [t.clone() for t in base], [t.clone() for t in base]
                outs_k, sum_k = kernel(a, sp.ALIAS, unit, k)
                outs_p, sum_p = sp.stream_units_plain(b, sp.ALIAS, unit, k)
                torch.cuda.synchronize()
                ulp = max(_ulps(x, y) for x, y in zip(outs_k, outs_p))
                same = all(torch.equal(x, y) for x, y in zip(outs_k + a, outs_p + b))
                rel = abs(float(sum_k) - float(sum_p)) / abs(float(sum_p))
                say(f"[3 compare] {name} {unit} x{k} n={n}: eps=1 units' sum max abs err "
                    f"{float(err.max()):.3e} ({over:.2f} of its bound, max bound "
                    f"{float(tol.max()):.3e}); eps=1e-12 outputs within {ulp:g} f32 ulp, "
                    f"bitwise {same}; sum rel err {rel:.3e} (limit {STREAM_SUM_TOL:g})")
                check(over <= 1.0, f"{name} {unit} x{k} units' sum within units_tolerance")
                check(ulp <= 1.0 and (same or k > 0),
                      f"{name} {unit} x{k} outputs within one ulp, bitwise at K = 0")
                check(rel <= STREAM_SUM_TOL, f"{name} {unit} x{k} sum within {STREAM_SUM_TOL}")
                worst[name] = max(worst[name], float(err.max()),
                                  max(abs_err(x, y) for x, y in zip(outs_k, outs_p)))
                del base, a, b, outs_k, outs_p, ek, ep, err, tol
    return worst


def _ulps(a, b) -> float:
    """Largest |a - b| in float32 ulps of b."""
    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    return float(((a.double() - b.double()).abs() / spacing.double()).max())


def compare_carry(n: int) -> dict:
    """The carry kernel against stream_carry_plain over CARRY_STEPS steps of
    every layout's loop from the same inputs: every carry buffer (and pp2's
    spare set) bitwise equal, h flipped to 1, each step's sum within
    STREAM_SUM_TOL.  pingpong runs at n (its halves not 16-byte aligned:
    the plain-load path) and at n rounded down to a multiple of 4 (the
    float4 path)."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.probes import fresh_streams, pingpong_probe as pp

    worst = 0.0
    cases = [(lay, n) for lay in pp.LAYOUTS] + [("pingpong", n - n % 4)]
    for c, (layout, m) in enumerate(cases):
        base = fresh_streams(4, m, torch.device("cuda"), seed=400 + c)
        ck = pp.carry(layout, [t.clone() for t in base])
        cp = pp.carry(layout, [t.clone() for t in base])
        rels = []
        for _ in range(CARRY_STEPS):
            sk_, sp_ = pp.step(ck, sp.stream_carry), pp.step(cp, sp.stream_carry_plain)
            rels.append(abs(float(sk_) - float(sp_)) / abs(float(sp_)))
        torch.cuda.synchronize()
        bufs_k = ck.bufs + (ck.spare or [])
        bufs_p = cp.bufs + (cp.spare or [])
        same = all(torch.equal(x, y) for x, y in zip(bufs_k, bufs_p))
        h_ok = layout != "pingpong" or int(ck.h) == int(cp.h) == CARRY_STEPS % 2
        say(f"[3 compare] stream_carry {layout} n={m}, {CARRY_STEPS} steps: {len(bufs_k)} "
            f"carry buffers bitwise equal {same}; h ok {h_ok}; sum rel err "
            f"{max(rels):.3e} (limit {STREAM_SUM_TOL:g})")
        check(same and h_ok, f"stream_carry {layout} bitwise equal to stream_carry_plain")
        check(max(rels) <= STREAM_SUM_TOL, f"stream_carry {layout} sums within tolerance")
        worst = max(worst, max(abs_err(x, y) for x, y in zip(bufs_k, bufs_p)))
        del base, ck, cp, bufs_k, bufs_p
    return {"stream_carry": worst}


def main_path(cfg) -> tuple[dict, float]:
    """Simulation.run to time_max with every substep kernel's count set to 0
    just before and read just after; returns the counts and gamma."""
    from pic1dp_tpu_torch import Simulation
    from pic1dp_tpu_torch.io import petsc_binary as pb
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    used = ({sk.SUBSTEP1_BF16.name, sk.SUBSTEP2_BF16.name} if cfg.bf16_weights
            else {sk.SUBSTEP1.name, sk.SUBSTEP2.name})
    snaps = []
    with tempfile.TemporaryDirectory() as out:
        sim = Simulation(cfg, out_path=out, device="cuda")
        for k in sk.KERNELS:
            k.launches = 0
        start = time.perf_counter()
        sim.run(snapshot_callback=snaps.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {k.name: k.launches for k in sk.KERNELS}
        path = os.path.join(out, "pic1dp.out")
        size = os.path.getsize(path)
        nm, ns, nxo, nvo = cfg.nmode, cfg.nspecies, cfg.nx_opd, cfg.nv_opd
        header = 4 * (6 + nm) + 8 * 2
        snap = (8 * (2 + 3 * ns) + 2 * (8 + 8 * nm) + 2 * (8 + 8 * cfg.nx)
                + ns * 8 * 3 * (nxo * nvo + nvo))
        with open(path, "rb") as fh:
            fh.seek(header + (len(snaps) - 1) * snap)
            last = pb.read_real(fh, 2 + 3 * ns)
    steps = sim.itime
    say(f"[4 main path] {label} n={cfg.nparticle_max} nx={cfg.nx} t={sim.time:.3f} "
        f"steps={steps} snapshots={len(snaps)} wall {wall:.2f} s; launches {launches}")
    check(steps == round(cfg.time_max / cfg.dt), "step count")
    check(all(v == (steps if k in used else 0) for k, v in launches.items()),
          f"one launch of each of {sorted(used)} per step and no other")
    check(len(snaps) == round(cfg.time_max / cfg.output_interval) + 1, "snapshot count")
    check(size == header + len(snaps) * snap,
          f"pic1dp.out size {size} == {header} + {len(snaps)} x {snap}")
    check(last[0] == snaps[-1]["time"] and last[1] == snaps[-1]["field_energy"],
          "last snapshot read back from pic1dp.out")
    s = sim.state
    for f in ("x", "v", "p", "w"):
        t = getattr(s, f)
        check(tuple(t.shape) == (1, cfg.nparticle_max) and bool(torch.isfinite(t).all()),
              f"final {f} finite with shape (1, {cfg.nparticle_max})")
    check(s.p.dtype == getattr(torch, cfg.p_dtype), f"final p is {cfg.p_dtype}")
    check(bool(((s.x >= 0) & (s.x < cfg.lx)).all()), "final x in [0, lx)")
    t = np.array([q["time"] for q in snaps])
    e = np.array([q["field_energy"] for q in snaps])
    check(bool(np.isfinite(e).all() and (e > 0).all()), "field energies finite")
    m = (t >= GAMMA_WINDOW[0]) & (t <= GAMMA_WINDOW[1])
    gamma = float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)
    rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
    say(f"[4 main path] {label} gamma {gamma:.5f} vs theory {BOT_OMEGA.imag:.5f}: "
        f"rel err {rel:.4f} (limit {GAMMA_REL_TOL}); int E^2 dx at t=100: {e[-1]:.4e}")
    check(rel <= GAMMA_REL_TOL, "growth rate within 5% of the dispersion root")
    return launches, gamma


def probes_path() -> tuple[dict, dict]:
    """The five probes at 2^PROBE_LOG2 through their entry points, each
    path with the stream kernels' counts set to 0 just before it and read
    just after; returns each kernel's launches on the path it belongs to,
    and the probes' rows."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.probes import (compute_probe, kernel_probe, overlap_probe,
                                         pingpong_probe, pipeline_probe)

    paths = (((kernel_probe, pipeline_probe), (sp.STREAM_RW, sp.STREAM_BULK)),
             ((compute_probe,), (sp.STREAM_UNITS,)),
             ((overlap_probe,), (sp.STREAM_UNITS, sp.STREAM_BULK_UNITS)),
             ((pingpong_probe,), (sp.STREAM_CARRY,)))
    launches = {k.name: 0 for k in sp.KERNELS}
    rows = {}
    for probes, kernels in paths:
        for k in sp.KERNELS:
            k.launches = 0
        for probe in probes:
            say(f"[4 probes] python -m {probe.__name__} {PROBE_LOG2}")
            rows.update({f"{probe.__name__.rsplit('.', 1)[1]}: {lbl}": r
                         for lbl, r in probe.main([str(PROBE_LOG2)]).items()})
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in sp.KERNELS}
        say(f"[4 probes] launches {counts}")
        check(all(counts[k.name] > 0 for k in kernels),
              f"{[k.name for k in kernels]} launched on the path of "
              f"{[p.__name__ for p in probes]}")
        for k in kernels:
            launches[k.name] += counts[k.name]
    return launches, rows


def device_state() -> str:
    """The caching allocator's state and the card's clocks, power and
    temperature, printed beside each timing window."""
    st = torch.cuda.memory_stats()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    return (f"reserved {torch.cuda.memory_reserved() / 2**30:.1f} GiB, allocator "
            f"retries {st.get('num_alloc_retries', 0)}, cudaMalloc "
            f"{st.get('num_device_alloc', 0)}, cudaFree {st.get('num_device_free', 0)}; "
            f"{smi}")


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_steppers(cfg, smi: str) -> tuple[float, float]:
    """ms/step of the kernel and the plain Stepper, in turns plain, kernel,
    kernel, plain; returns the means."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    kern, plain = Stepper(cfg, "cuda"), Stepper(cfg, "cuda", plain=True)
    state0 = kern.initial_field(load_particles(cfg, "cuda"))
    say(f"[5 timing] before: {device_state()}")
    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        st = kern if which == "kernel" else plain
        box = [st.multi_step(state0.clone(), WARMUP_STEPS)]
        torch.cuda.synchronize()

        def one():
            box[0] = st.step(box[0])

        ms[which].append(_events_ms(one, TIMING_STEPS))
        check(bool(torch.isfinite(box[0].w).all()), f"{which} timing run finite")
        del box
    say(f"[5 timing] after: {device_state()}")
    k, p = (float(np.mean(ms[w])) for w in ("kernel", "plain"))
    n = cfg.nspecies * cfg.nparticle_max
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    say(f"[5 timing] n={n} nx={cfg.nx} {label}: kernel {k:.4f} ms/step "
        f"({ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f}) = {n / k * 1e3:.4e} pushes/s; "
        f"plain {p:.4f} ms/step ({ms['plain'][0]:.4f}, {ms['plain'][1]:.4f}) = "
        f"{n / p * 1e3:.4e} pushes/s; card {smi}")
    return k, p


def time_kernels(cfg) -> dict:
    """ms per call of each substep kernel and of its plain version at the
    main path's shape (these launches come after the main path's counts
    were read)."""
    from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps

    x, v, p, w, (mre0, mim0, mre1, mim1), sp = _inputs(cfg, cfg.nparticle_max, "cuda")
    subs = FusedSubsteps(cfg, sp)
    w1, v1, _ = subs.substep1(x, v, p, w, mre0, mim0)
    tag = "_bf16" if cfg.bf16_weights else ""
    out = {}
    for name, fn in ((f"substep1{tag}", lambda: subs.substep1(x, v, p, w, mre0, mim0)),
                     (f"substep1{tag}_plain",
                      lambda: subs.substep1_plain(x, v, p, w, mre0, mim0)),
                     (f"substep2{tag}", lambda: subs.substep2(x, v, p, w, w1, v1, mre1, mim1)),
                     (f"substep2{tag}_plain",
                      lambda: subs.substep2_plain(x, v, p, w, w1, v1, mre1, mim1))):
        fn()
        out[name] = _events_ms(fn, TIMING_STEPS)
    say("[5 timing] per call at n={} nx={}: ".format(cfg.nparticle_max, cfg.nx)
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def time_stream_plain() -> float:
    """ms per call of stream_plain on the substep-2 pattern (4r+3w aliased)
    at 2^PROBE_LOG2, the pattern the stream kernels' "ms" is read at."""
    from pic1dp_tpu_torch.ops.stream_probes import stream_plain
    from pic1dp_tpu_torch.probes import fresh_streams, pipeline_probe

    ins = fresh_streams(4, 2**PROBE_LOG2, torch.device("cuda"), seed=7)
    fn = lambda: stream_plain(ins, 3, pipeline_probe.ALIAS)   # noqa: E731
    fn()
    ms = _events_ms(fn, 10)
    say(f"[5 timing] stream_plain 4r+3w aliased n=2^{PROBE_LOG2}: {ms:.4f} ms")
    return ms


def time_probe_kernels() -> dict:
    """ms per call of the unit and carry kernels and of their plain
    versions at 2^PROBE_LOG2, in the probes' configurations: trig x4 with
    fresh outputs on direct loads (4 blocks/SM) and on the 8 KB x 4 ring,
    the in-place carry (these launches come after the probes' counts were
    read)."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.probes import fresh_streams
    from pic1dp_tpu_torch.probes.compute_probe import unit_inputs

    n, dev = 2**PROBE_LOG2, torch.device("cuda")
    cases = (("stream_units", lambda i: sp.stream_units(i, {}, "trig", 4)),
             ("stream_bulk_units", lambda i: sp.stream_bulk_units(i, {}, "trig", 4)),
             ("stream_units_plain", lambda i: sp.stream_units_plain(i, {}, "trig", 4)),
             ("stream_carry", lambda i: sp.stream_carry(i, sp.ALIAS)),
             ("stream_carry_plain", lambda i: sp.stream_carry_plain(i, sp.ALIAS)))
    out = {}
    for c, (name, fn) in enumerate(cases):
        ins = (unit_inputs(n, dev, 500 + c) if "units" in name
               else fresh_streams(4, n, dev, 500 + c))
        fn(ins)
        out[name] = _events_ms(lambda: fn(ins), 10)
        del ins
    out["stream_bulk_units_plain"] = out["stream_units_plain"]
    say(f"[5 timing] per call at n=2^{PROBE_LOG2} (trig x4, fresh outputs; carry in "
        f"place): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                         "is False")
    from pic1dp_tpu_torch.config import bump_on_tail_default
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    smi = environment()
    build()

    main_cfg = bump_on_tail_default(time_max=100.0, verbosity=0)
    bf16_cfg = dataclasses.replace(main_cfg, bf16_weights=True)
    check(main_cfg.nparticle_max == FULL_N and main_cfg.nx == 192, "full width")
    trig_accuracy()
    err = compare_substeps(main_cfg, FULL_N, F32_TOL)
    err.update(compare_substeps(bf16_cfg, FULL_N, F32_TOL))
    f64 = dataclasses.replace(main_cfg, dtype="float64", nparticle_max=F64_N,
                              modes=(1, 2, 3), init_modes=(1, 2),
                              init_amp_cos=(1e-5, 0.0), init_amp_sin=(1e-4, 5e-5))
    compare_substeps(f64, F64_N, None)
    compare_substeps(dataclasses.replace(f64, modes=(1,), init_modes=(1,),
                                         init_amp_cos=(0.0,), init_amp_sin=(1e-5,)),
                     F64_N, None)
    compare_steppers(main_cfg)
    compare_steppers(bf16_cfg)
    err.update(compare_streams(2**PROBE_LOG2 + 13))
    err.update(compare_units(2**PROBE_LOG2 + 13))
    err.update(compare_carry(2**PROBE_LOG2 + 13))
    torch.cuda.synchronize()

    launches, gamma32 = main_path(main_cfg)
    bf16_launches, gamma16 = main_path(bf16_cfg)
    say(f"[4 main path] gamma f32 {gamma32:.5f}, bf16_weights {gamma16:.5f}, "
        f"theory {BOT_OMEGA.imag:.5f}")
    launches.update({k: v for k, v in bf16_launches.items() if "bf16" in k})
    stream_launches, rows = probes_path()
    launches.update(stream_launches)

    per_call = time_kernels(main_cfg)
    per_call.update(time_kernels(bf16_cfg))
    per_call["stream_rw"] = rows["kernel_probe: ss2 pattern 4r+3w aliased"].ms
    per_call["stream_bulk"] = rows["pipeline_probe: bulk 8 KB x 4 aliased"].ms
    per_call["stream_rw_plain"] = per_call["stream_bulk_plain"] = time_stream_plain()
    per_call.update(time_probe_kernels())
    time_steppers(main_cfg, smi)
    headline = bump_on_tail_default(nparticle_max=BENCH_N, nx=BENCH_NX, verbosity=0)
    time_steppers(headline, smi)
    time_steppers(dataclasses.replace(headline, bf16_weights=True), smi)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                "max_abs_err": err[k.name], "ms": per_call[k.name],
                "plain_ms": per_call[f"{k.name}_plain"]} for k in sk.KERNELS + sp.KERNELS]
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched on its main path")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
