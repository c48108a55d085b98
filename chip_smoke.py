"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives pic1dp_tpu_torch's main paths — the default bump-on-tail run at its
full width of 6.4M markers, in f32 and with bf16_weights, through the
hand-written CUDA substep kernels, in both nonlinear delta-f layouts, with
32 kept modes and with nine species; the reference's verification cases
(Landau damping nonlinear and linear, two-stream in delta-f and full-f, two
species, ion-acoustic) through the substep kernels of their layouts; and
the five probes through the stream kernels — and checks them.  It imports
neither jax nor pic1dp_tpu, catches nothing, and exits non-zero at the
first failed check.  Phases, each printed:

  1. environment: torch, CUDA, triton and nvcc versions, the card
  2. build: nvcc builds every kernel source of pic1dp_tpu_torch/csrc (each
     hashed with the headers beside it), one process per source, all at once
  3. each kernel against its plain PyTorch version on the same inputs:
     the main substeps in f32 and bf16_weights at full width and in f64
     with three modes; the angle table as the kernels read it, bit for
     bit; each layout's substeps at the shape of its
     verification case in f32 (and bf16_weights where it has a bf16 build),
     and every variant of the reference's _pallas_cases in f64; five Stepper
     steps in f32 and bf16; k steps replayed from a CUDA graph against k
     eager steps, bit for bit; both stream kernels on every built pattern, both unit
     kernels for every unit and K in {0, 1, 4} at eps = 1 and 1e-12, and the
     carry kernel over 3 steps in every layout
  4. the main paths, each with its launch counts set to 0 just before and
     read just after: Simulation.run to t = 100 in f32 and in bf16_weights
     (launch counts, the pic1dp.out size and read-back, the growth rate
     against theory), each verification case through Simulation.run against
     its dispersion root, each run under torch.profiler, whose substep
     kernels by name must equal the counters, then the kernel, pipeline, compute, overlap and
     pingpong probes at 2^26, each with the stream kernels' counts set to 0
     just before it
  5. the rest of the single-device run surface, each path with the substep
     kernels' counts set to 0 just before it and read just after: the
     full-spectrum rho of diag_full_rho against the kept-mode rho and the
     time of a snapshot with and without it; the EXPLICIT grid path against
     the matrix-free kernels (f32 at full width, f64 at 2^16 markers) and its
     ms/step; the multirand loader at full width with the native engine
     against a Python-oracle draw, and 20 steps from its state; a checkpoint
     at t = 5 resumed to t = 10 against the uninterrupted run, bit for bit,
     in f32 and bf16_weights; a run with a merge/remove/merge/split schedule
     at 2^21 markers to t = 75 (live counts around each event, gamma over
     the linear window, two kernel launches per step at the event steps too),
     then at that shape both kernels against their plain versions on a
     loaded state and on the state the events left, push_pair with the
     kernels against the plain Stepper's, and merge, remove and split on the
     card against the CPU in float64 with the same dice and normals
  7. (run after 5, before 6) the substep kernels' last layouts, each path
     with the substep kernels' counts set to 0 just before it and read just
     after: the kernels of the nonlinear delta-f layout the main config
     does not take (substep_kernels.layout) at the main shape in f32 and
     bf16_weights against their plain versions, both layouts stepped side
     by side bit for bit, and that layout (PIC1DP_STREAM_V1) through graph
     = eager and a run to t = 100 against the root; the grid bin (more than
     4 kept modes): 16, 32 and 64 modes at full width against plain in f32
     and in f64 at 2^16, bf16_weights at 32, nx 1024, 4096 and one past the
     shared memory at 16 and 64 modes in f32 and f64, linear and full-f at
     16, repeated launches, graph = eager and recompute = streamed bit for
     bit, and a run with 32 modes whose mode 1 grows at the root's rate; nine
     species (the species table) against plain in f32 and f64, graph =
     eager, and Landau damping's root; the phase table at the main shape and
     the headline in both layouts, with the step minus its two kernels and
     the idle share of a graph replay; and run.py --profile, whose trace
     holds each substep kernel as often as the counters say
  6. timing: ms per call of each substep, unit and carry kernel and its
     plain version (for each substep its bound, share, V, B, the bin and
     where the angle table or the grids sat), ms/step of the plain, the eager kernel and the CUDA
     graph Stepper at the main path's shape and at bench.py's headline
     shape (2^26 markers, nx 1024), and both nonlinear delta-f layouts per
     call and per graph step in turns on each side of the line that
     substep_kernels.rebuilds_v1_faster draws: the main shape and the
     headline in f32 and bf16_weights, 4, 16, 32 and 64 kept modes, the
     species loop and the cases of 1M markers or fewer

The last three lines of standard output are the card's name and power
limit, one JSON object on the kernels, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
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
GRAPH_CHECK_STEPS = 5
PROFILER_TRIES = 3                   # profiled runs of a case at most
SEED = 20261016
# the card's rates for bound_ms: NVIDIA's H100 SXM data sheet
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
FULL_RHO_TOL = 1e-4                  # tests/test_tools.py:189-193, in f32
EXPLICIT_F64_N = 2**16
MULTIRAND_RANKS = 640                # blocks of 10,000 markers for the oracle check
CHECKPOINT_T = (5.0, 10.0)           # save at, run to
OPT_N, OPT_TIME_MAX = 2**21, 75.0    # bench/opt_onchip.py's width
OPT_GAMMA_WINDOW = (25.0, 48.0)      # before the first event, as bench/opt_onchip.py fits
# merge/remove/split on the card against the CPU in float64: live bits that
# may differ in float64; in float32 the live count's and the sums' bounds
# (a few markers of 2^21 sit within float32 rounding of a threshold, and one
# that remove keeps on one side only carries its weight over its importance)
OPT_F64_FLIPS, OPT_F32_LIVE, OPT_F32_SUM = 2, 5e-4, 1e-3


# ---- the reference's verification cases, at the widths of its examples
# and tests (examples/landau_damping.py:21-22, examples/two_stream.py:30-37,
# PHYSICS_r05.json two_stream_k0.2_fullf, tests/test_physics.py:130-146,
# examples/ion_acoustic.py:47-58) ----

def landau_cfg(linear: bool = False, bf16: bool = False):
    return dataclasses.replace(landau_damping_cfg(), linear=linear, bf16_weights=bf16)


def two_stream_cfg(deltaf: bool = True):
    from pic1dp_tpu_torch.config import two_stream

    if deltaf:
        return two_stream(nparticle=1_000_448, time_max=80.0, output_interval=0.5,
                          verbosity=0)
    return two_stream(nparticle=2**24, deltaf=False, time_max=30.0, verbosity=0)


def two_species_cfg(bf16: bool = False):
    from pic1dp_tpu_torch.config import Config, Equilibrium, SpeciesConfig

    sp = dict(charge=-1.0, mass=1.0, temperature=1.0, density=0.5)
    return Config(lx=2.0 * np.pi / 0.2, equilibrium=Equilibrium.MAXWELLIAN,
                  species=(SpeciesConfig(v0=3.0, **sp), SpeciesConfig(v0=-3.0, **sp)),
                  nx=256, nparticle_max=2**20, time_max=26.0, output_interval=0.5,
                  bf16_weights=bf16, verbosity=0).validate()


def ion_acoustic_cfg():
    from pic1dp_tpu_torch.config import Config, Equilibrium, MarkerLoading, SpeciesConfig

    return Config(
        linear=False, deltaf=True, lx=2.0 * np.pi / 0.5, equilibrium=Equilibrium.MAXWELLIAN,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0, v0=0.0),
                 SpeciesConfig(charge=1.0, mass=25.0, temperature=0.05, density=1.0,
                               v0=0.0)),
        nx=64, nparticle_max=2**22, time_max=320.0, dt=0.05, marker=MarkerLoading.PHYSICAL,
        v_max=8.0, modes=(1,), init_modes=(1,), init_amp_cos=(0.0,), init_amp_sin=(3e-4,),
        output_interval=1.0, verbosity=0).validate()


def nine_species_cfg(dtype: str = "float32", n: int = 102_400):
    """Landau k = 0.5 (examples/landau_damping.py:21-22) as nine identical
    electron species of density 1/9, n markers each: the plasma and its
    dispersion root are the one-species case's."""
    from pic1dp_tpu_torch.config import SpeciesConfig

    sp = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0 / 9.0, v0=0.0)
    return dataclasses.replace(
        landau_damping_cfg(n), species=(sp,) * 9, dtype=dtype).validate()


def landau_damping_cfg(n: int = 102_400):
    from pic1dp_tpu_torch.config import landau_damping

    return landau_damping(nx=64, nparticle=n, k=0.5, amp=1e-4, time_max=20.0,
                          output_interval=0.1, verbosity=0)


def many_modes_cfg(nmode: int, **kw):
    """The default bump-on-tail case keeping modes 1..nmode, mode 1 alone
    perturbed at the start."""
    from pic1dp_tpu_torch.config import bump_on_tail_default

    return bump_on_tail_default(modes=tuple(range(1, nmode + 1)), init_modes=(1,),
                                verbosity=0, **kw)


def pallas_cases(n: int):
    """Every variant of tests/test_spectral_path.py's _pallas_cases, with n
    markers per species, in float64."""
    from pic1dp_tpu_torch import config as c

    lan = dict(nx=64, nparticle=n, dtype="float64", verbosity=0)
    yield "bot_nonlinear_deltaf", c.bump_on_tail_default(nx=192, nparticle_max=n,
                                                         dtype="float64", verbosity=0)
    yield "landau_linear", dataclasses.replace(c.landau_damping(**lan), linear=True)
    yield "landau_fullf", dataclasses.replace(c.landau_damping(amp=1e-2, **lan), deltaf=False)
    yield "two_stream2", c.two_stream(**lan)
    yield "multimode", dataclasses.replace(
        c.landau_damping(**lan), modes=(1, 2, 3), init_modes=(1, 2),
        init_amp_cos=(1e-5, 0.0), init_amp_sin=(1e-4, 5e-5))
    yield "two_species_maxwellian", dataclasses.replace(
        c.two_stream(**lan), equilibrium=c.Equilibrium.MAXWELLIAN,
        species=(c.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.6, v0=2.5),
                 c.SpeciesConfig(charge=-0.5, mass=2.0, temperature=0.5, density=0.4,
                                 v0=-3.0)))
    yield "two_species_bump_mixed", dataclasses.replace(
        c.bump_on_tail_default(nx=64, nparticle_max=n, dtype="float64", verbosity=0),
        species=(c.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, temperature2=0.25,
                                 density=0.9, v0=4.0),
                 c.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.5, temperature2=0.25,
                                 density=1.0, v0=0.0)))


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
    """Build every source at once and print the ptxas lines of the main
    path's substep kernels (the one-species nonlinear instantiations) and
    of the grid bin's (registers, spills, shared memory), and for the other
    kernels their count, most registers and any spill."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.ops import substep_kernels as sk
    from pic1dp_tpu_torch.utils import nvcc

    start = time.perf_counter()
    for built in nvcc.load_all([sk.SOURCE, sp.SOURCE]):
        say(f"[2 build] {built.path.name}: nvcc {built.build_seconds:.1f} s")
        entries = []             # (entry function, its ptxas lines)
        for ln in built.log.splitlines():
            ln = ln.strip()
            if "Compiling entry" in ln:
                entries.append((ln, []))
            elif entries and ("Used" in ln or "spill" in ln):
                entries[-1][1].append(ln)
        rest = []
        for entry, lines in entries:
            if _substep_entry(entry) in ("main", "grid", "grid_angle"):
                for line in (entry, *lines):
                    say(f"[2 build] {line}")
            else:
                rest.extend(lines)
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in rest if "Used " in ln]
        spills = [(entry, ln) for entry, lines in entries for ln in lines
                  if _substep_entry(entry) not in ("main", "grid", "grid_angle")
                  and "spill" in ln and not ln.startswith("0 bytes")]
        say(f"[2 build] {built.path.name}: {len(regs)} other kernels, at most "
            f"{max(regs, default=0)} registers; lines with spills: {len(spills)}")
        for entry, line in spills:
            say(f"[2 build] {entry.split('entry function ')[-1]}: {line}")
    sk.library()
    sp.library()
    say(f"[2 build] all libraries built in parallel and loaded in "
        f"{time.perf_counter() - start:.1f} s")


def _substep_entry(name: str) -> str | None:
    """What a ptxas entry name is: "main" for a substep kernel of the main
    path (nonlinear, v1 streamed or rebuilt, kSpecies false), "grid" for
    one of the grid bin (kGrid), "grid_angle", "substep" for another
    substep kernel, None for another source's kernel."""
    if "grid_angle_kernel" in name:
        return "grid_angle"
    m = re.search(r"substep[12]_kernelI\w*?Li\d+ELi(\d+)ELb([01])ELb([01])E", name)
    if m is None:
        return None
    if m.group(3) == "1":
        return "grid"
    return "main" if m.group(1) in ("0", "3") and m.group(2) == "0" else "substep"


def substep_counter(kernel_name: str) -> str | None:
    """The launch counter of a substep kernel from its device name as the
    profiler reports it, demangled ("substep1_kernel<float, __nv_bfloat16,
    __nv_bfloat16, 1, 1, true>") or mangled ("substep1_kernelIf13__nv_...
    Li1ELi1ELb1E"): substep, layout (template argument L) and bf16 storage;
    None for any other kernel."""
    layouts = {"0": "", "1": "_linear", "2": "_fullf", "3": "_recompute"}
    m = re.search(r"substep([12])_kernel<([^<>]*)>", kernel_name)
    if m:
        args = [a.strip() for a in m.group(2).split(",")]
        sub, types, lay = m.group(1), args[1], args[4]
    else:
        m = re.search(r"substep([12])_kernelI(\w*?)Li\d+ELi(\d+)ELb[01]E", kernel_name)
        if m is None:
            check(re.search(r"substep[12]_kernel", kernel_name) is None,
                  f"kernel name not understood: {kernel_name}")
            return None
        sub, types, lay = m.groups()
    return f"substep{sub}{layouts[lay]}{'_bf16' if 'bfloat16' in types else ''}"


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


def _loaded_inputs(cfg):
    """A state from the port's loader for cfg on the card, (ns, n), and mode
    components of a saturated amplitude."""
    from pic1dp_tpu_torch import distributions as dist
    from pic1dp_tpu_torch.core.loading import load_particles

    dtype = getattr(torch, cfg.dtype)
    st = load_particles(cfg, "cuda")
    rng = np.random.default_rng(SEED)
    modes = [torch.from_numpy(rng.uniform(-0.05, 0.05, cfg.nmode)).to("cuda", dtype)
             for _ in range(4)]
    return st.x, st.v, st.p, st.w, modes, dist.SpeciesParams.from_config(cfg, dtype, "cuda")


def compare_substeps(cfg, n: int, tol: dict | None, inputs=None,
                     stream_v1: bool | None = None, plain_f64: bool = False) -> dict:
    """Both kernels and both plain versions on the same inputs (default
    _inputs, one species of n markers); returns each kernel's largest
    absolute error; raises past the tolerance (tol None: F64_TOL relative to
    each field's max).  Under bf16_weights substep 1's w1 is held to one
    bfloat16 ulp per element: the kernel's float w1 may differ from torch's
    by an ulp (FMA contraction), which flips the rounding of a few markers.
    Streams a layout does not write are compared where they come back.
    stream_v1 picks the nonlinear delta-f layout (None: the config's own,
    substep_kernels.layout).  plain_f64 runs the plain version in float64
    on the same inputs (the f32 kernels against an f64 reference: full-f
    with many modes, where the f32 plain version's own grid angles, ix0
    times 2 pi m / nx rounded in f32, are off by more than the bound)."""
    from pic1dp_tpu_torch import distributions as dist
    from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps

    x, v, p, w, (mre0, mim0, mre1, mim1), sp = inputs or _inputs(cfg, n, "cuda")
    subs = FusedSubsteps(cfg, sp, stream_v1=stream_v1)
    kw1, kv1, kproj1 = subs.substep1(x, v, p, w, mre0, mim0)
    streams = [t.clone() for t in (x, v, w)]
    kx2, kv2, kw2, kproj2 = subs.substep2(*streams[:2], p, streams[2], kw1, kv1, mre1, mim1,
                                          mre0, mim0)
    plain, up = subs, (lambda t: t)
    if plain_f64:
        check(not cfg.bf16_weights, "plain_f64 compares f32 or f64 streams")
        c64 = dataclasses.replace(cfg, dtype="float64")
        plain = FusedSubsteps(c64, dist.SpeciesParams.from_config(c64, torch.float64, "cuda"),
                              stream_v1=stream_v1)
        up = lambda t: None if t is None else t.double()   # noqa: E731
    x, v, p, w, mre0, mim0, mre1, mim1 = map(up, (x, v, p, w, mre0, mim0, mre1, mim1))
    pw1, pv1, pproj1 = plain.substep1_plain(x, v, p, w, mre0, mim0)
    streams = [t.clone() for t in (x, v, w)]
    px2, pv2, pw2, pproj2 = plain.substep2_plain(*streams[:2], p, streams[2],
                                                up(kw1), up(kv1), mre1, mim1, mre0, mim0)
    torch.cuda.synchronize()
    bf16 = cfg.bf16_weights
    names = [k.name for k in subs.counters]
    pairs = {names[0]: dict(w=(kw1, pw1), v=(kv1, pv1), proj=(
                 torch.stack(kproj1), torch.stack(pproj1))),
             names[1]: dict(x=(kx2, px2), v=(kv2, pv2), w=(kw2, pw2), proj=(
                 torch.stack(kproj2), torch.stack(pproj2)))}
    check((kw1 is None or kw1.dtype == getattr(torch, cfg.p_dtype))
          and (kv1 is None or kv1.dtype == kx2.dtype) and kx2.dtype == getattr(torch, cfg.dtype),
          f"substep output dtypes (w1 {getattr(kw1, 'dtype', None)}, "
          f"v1 {getattr(kv1, 'dtype', None)}, x2 {kx2.dtype})")
    worst = {}
    for name, fields in pairs.items():
        errs = []
        for field, (a, b) in fields.items():
            check((a is None) == (b is None), f"{name} {field} written by both or neither")
            if a is None:
                continue
            check(bool(torch.isfinite(a).all()), f"{name} {field} finite")
            if bf16 and name.startswith("substep1") and field == "w":
                u = bf16_ulps(a, b, tol["w"])
                say(f"[3 compare] bf16 n={n} {name} w1: {u['differ']} of {a.numel()} "
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
            say(f"[3 compare] {cfg.dtype}{'/bf16' if bf16 else ''} n={cfg.nspecies}x{n} "
                f"nmode={cfg.nmode} {name} {field}{' (plain in f64)' if plain_f64 else ''}: "
                f"max abs err {ab:.3e}, rel to max {rel:.3e} (limit {limit:g})")
            check(measured <= limit, f"{name} {field} {cfg.dtype} within {limit}")
            errs.append(ab)
        worst[name] = max(errs)
    return worst


def compare_layouts() -> dict:
    """Each layout's kernels against their plain versions at the shapes of
    the verification cases in f32 (bf16_weights where the layout has a bf16
    build), and every _pallas_cases variant in f64 at 1e-12."""
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    worst = {}
    for cfg in (landau_cfg(linear=True), landau_cfg(linear=True, bf16=True), two_stream_cfg(),
                two_stream_cfg(deltaf=False), two_species_cfg(), two_species_cfg(bf16=True),
                ion_acoustic_cfg()):
        say(f"[3 compare] layout {sk.layout(cfg)}, {cfg.nspecies} species, "
            f"{cfg.equilibrium.value}, {'bf16_weights' if cfg.bf16_weights else cfg.dtype}")
        for name, err in compare_substeps(cfg, cfg.nparticle_max, F32_TOL,
                                          _loaded_inputs(cfg)).items():
            worst[name] = max(worst.get(name, 0.0), err)
        torch.cuda.synchronize()
    for label, cfg in pallas_cases(F64_N):
        say(f"[3 compare] f64 {label}: {sk.layout(cfg)} kernels")
        compare_substeps(cfg, F64_N, None, _loaded_inputs(cfg))
    return worst


def angle_tables() -> None:
    """The substep kernels' grid-angle table as they read it on the card
    (substep_kernels.angle_gather: staged into shared memory where the
    kernels stage it, else read in place) against the host's table, bit for
    bit: the main case, the headline, three modes in f64, and tables too
    large for shared memory in f32 and f64."""
    from types import SimpleNamespace

    from pic1dp_tpu_torch.ops import substep_kernels as sk

    for nx, modes, dtype in ((192, (1,), torch.float32), (1024, (1,), torch.float32),
                             (64, (1, 2, 3), torch.float64), (4096, (1, 3), torch.float32),
                             (2048, (1, 2), torch.float64), (5632, (7,), torch.float32)):
        cfg = SimpleNamespace(nx=nx, modes=modes)
        host = sk.angle_table(cfg, dtype, "cpu")
        table = sk.angle_table(cfg, dtype, "cuda")
        idx = torch.arange(host.numel() // 2, dtype=torch.int32, device="cuda")
        got = sk.angle_gather(table, idx).cpu()
        same = torch.equal(got, host.reshape(-1, 2))
        smem = sk.angle_smem_bytes(len(modes), nx, host.element_size())
        say(f"[3 compare] angle table nx={nx} modes={modes} {dtype}: "
            f"{'shared memory, ' + str(smem) + ' B' if smem else 'device memory'}; "
            f"gathered on the card bitwise equal to the host table {same}")
        check(same, f"angle table nx={nx} modes={modes} {dtype} read back bit for bit")


def trig_accuracy() -> None:
    """The grid-angle sin/cos of hat_trig's chain (the probes' trig unit)
    against float64, for every realizable angle 2 pi (m ix0 mod nx) / nx;
    bound of tests/test_spectral_path.py:338-368 (2 f32 ulp at 1)."""
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


def compare_graph(cfg) -> None:
    """GRAPH_CHECK_STEPS steps replayed from a CUDA graph against as many
    eager steps from the same state: every field bit for bit (the graph
    holds the same kernels on the same buffers, and no sum uses float
    atomics).  The counters gain one launch of each of the layout's two
    kernels per replayed step."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    k = GRAPH_CHECK_STEPS
    st = Stepper(cfg, "cuda")
    a = st.multi_step(st.initial_field(load_particles(cfg, "cuda")), 1)   # eager, loads all
    b = a.clone()
    before = {kk.name: kk.launches for kk in sk.KERNELS}
    a = st.multi_step(a, k)
    added = {kk.name: kk.launches - before[kk.name] for kk in sk.KERNELS}
    for _ in range(k):
        b = st.step(b)
    torch.cuda.synchronize()
    fields = ("x", "v", "p", "w", "mode_re", "mode_im", "electric", "rho")
    same = {f: torch.equal(getattr(a, f), getattr(b, f)) for f in fields}
    used = {kk.name for kk in st.substeps.counters}
    label = f"{st.substeps.layout} n={cfg.nspecies}x{cfg.nparticle_max} nmode={cfg.nmode}"
    say(f"[3 compare] CUDA graph {label}: {k} replayed steps against {k} eager steps, "
        f"bitwise equal {same}; counters gained {({n: d for n, d in added.items() if d})}")
    check(all(same.values()), "graph replay bit for bit equal to eager steps")
    check(all(d == (k if n in used else 0) for n, d in added.items()),
          f"a replay of {k} steps counts {k} launches of each of {sorted(used)}")


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


def run_case(phase: str, label: str, cfg) -> tuple[list, dict]:
    """Simulation.run of cfg on the card, through the CUDA graph, with every
    substep kernel's count set to 0 just before and read just after: only
    the config's own two kernels, once per step, in the counters and in a
    torch.profiler trace of the whole run, which sees each kernel the card
    ran by name (graph replays included; the run is made again, up to
    PROFILER_TRIES times, while the profiler sees fewer); the step and
    snapshot counts; pic1dp.out of the expected size, its last snapshot read
    back; a finite final state of the configured shape and dtypes with x in
    [0, lx).  Returns the snapshots and the counts."""
    from pic1dp_tpu_torch import Simulation
    from pic1dp_tpu_torch.io import petsc_binary as pb
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    nm, ns, nxo, nvo = cfg.nmode, cfg.nspecies, cfg.nx_opd, cfg.nv_opd
    header = 4 * (6 + nm) + 8 * 2
    snap = (8 * (2 + 3 * ns) + 2 * (8 + 8 * nm) + 2 * (8 + 8 * cfg.nx)
            + ns * 8 * 3 * (nxo * nvo + nvo))
    for attempt in range(1, PROFILER_TRIES + 1):
        snaps = []
        with tempfile.TemporaryDirectory() as out:
            sim = Simulation(cfg, out_path=out, device="cuda")
            for k in sk.KERNELS:
                k.launches = 0
            start = time.perf_counter()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                sim.run(snapshot_callback=snaps.append)
                torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = {k.name: k.launches for k in sk.KERNELS}
            seen, device_events = {}, 0
            for ev in prof.key_averages():
                device_events += ev.count
                name = substep_counter(ev.key)
                if name is not None:
                    seen[name] = seen.get(name, 0) + ev.count
            path = os.path.join(out, "pic1dp.out")
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                fh.seek(header + (len(snaps) - 1) * snap)
                last = pb.read_real(fh, 2 + 3 * ns)
        used = {k.name for k in sim.stepper.substeps.counters}
        steps = sim.itime
        counted = {n: v for n, v in launches.items() if v}
        say(f"[{phase}] {label}: {ns} x {cfg.nparticle_max} markers, nx={cfg.nx}, "
            f"t={sim.time:.3f}, steps={steps}, snapshots={len(snaps)}, wall {wall:.2f} s; "
            f"launches {counted}")
        check(steps == round(cfg.time_max / cfg.dt), f"{label} step count")
        check(all(v == (steps if n in used else 0) for n, v in launches.items()),
              f"{label}: one launch of each of {sorted(used)} per step and no other")
        say(f"[{phase}] {label}: the profiler saw substep kernels {seen} among "
            f"{device_events} device events (run {attempt} of at most {PROFILER_TRIES})")
        # the profiler now and then loses a batch of device records (PERF.md
        # section 7) but never invents one: a kernel it sees beyond the
        # counters fails at once, fewer runs the case again
        check(all(v <= counted.get(n, 0) for n, v in seen.items()),
              f"{label}: the profiler saw no substep kernel beyond the counters")
        if seen == counted:
            break
    check(seen == counted,
          f"{label}: the profiler's substep kernels equal the counters in one of "
          f"{PROFILER_TRIES} runs")
    check(len(snaps) == round(cfg.time_max / cfg.output_interval) + 1,
          f"{label} snapshot count")
    check(size == header + len(snaps) * snap,
          f"{label} pic1dp.out size {size} == {header} + {len(snaps)} x {snap}")
    check(last[0] == snaps[-1]["time"] and last[1] == snaps[-1]["field_energy"],
          f"{label} last snapshot read back from pic1dp.out")
    st = sim.state
    for f in ("x", "v", "p", "w"):
        t = getattr(st, f)
        check(tuple(t.shape) == (ns, cfg.nparticle_max) and bool(torch.isfinite(t).all()),
              f"{label} final {f} finite with shape ({ns}, {cfg.nparticle_max})")
    check(st.p.dtype == getattr(torch, cfg.p_dtype), f"{label} final p is {cfg.p_dtype}")
    check(bool(((st.x >= 0) & (st.x < cfg.lx)).all()), f"{label} final x in [0, lx)")
    e = np.array([q["field_energy"] for q in snaps])
    check(bool(np.isfinite(e).all() and (e > 0).all()), f"{label} field energies finite")
    return snaps, launches


def main_path(cfg, phase: str = "4 main path") -> tuple[dict, float]:
    """The default case to time_max (run_case); returns the counts and
    gamma against the dispersion root."""
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    snaps, launches = run_case(phase, label, cfg)
    t = np.array([q["time"] for q in snaps])
    e = np.array([q["field_energy"] for q in snaps])
    m = (t >= GAMMA_WINDOW[0]) & (t <= GAMMA_WINDOW[1])
    gamma = float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)
    rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
    say(f"[{phase}] {label} gamma {gamma:.5f} vs theory {BOT_OMEGA.imag:.5f}: "
        f"rel err {rel:.4f} (limit {GAMMA_REL_TOL}); int E^2 dx at t=100: {e[-1]:.4e}")
    check(rel <= GAMMA_REL_TOL, "growth rate within 5% of the dispersion root")
    return launches, gamma


def _energy_gamma(t, e, lo: float, hi: float) -> float:
    """Half the slope of ln int E^2 dx over [lo, hi] (tests/test_physics.py)."""
    m = (t >= lo) & (t <= hi)
    return float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)


def _peaks_gamma(t, e, lo: float, hi: float) -> float:
    """The same through the local maxima of a damped oscillation."""
    pk = [i for i in range(1, len(e) - 1)
          if e[i] > e[i - 1] and e[i] > e[i + 1] and lo <= t[i] <= hi]
    return float(np.polyfit(t[pk], np.log(e[pk]), 1)[0] / 2.0)


def physics_path() -> dict:
    """Each verification case against its dispersion root from the port's
    copy of analysis/dispersion.py; returns the launches of each kernel on
    the path of its own case."""
    from pic1dp_tpu_torch.analysis.dispersion import (Dispersion, fit_mode_omega,
                                                      species_for_config)

    def root(cfg, k, guesses=None):
        d = Dispersion(species_for_config(cfg), k)
        if guesses:
            d._guesses = guesses
        return d.solve_omega()

    def series(snaps, key):
        return np.array([s[key] for s in snaps])

    def row(label, value, want, limit):
        rel = abs(value - want) / abs(want)
        say(f"[4 physics] {label}: {value:.5f} against {want:.5f}, rel err {rel:.4f} "
            f"(limit {limit})")
        check(rel <= limit, f"{label} within {limit}")

    launches = {}

    def add(counts):
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v

    ts_guess = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
    landau_root = root(landau_cfg(), 0.5)
    snaps, counts = run_case("4 physics", "Landau, nonlinear delta-f", landau_cfg())
    add(counts)
    t, e = series(snaps, "time"), series(snaps, "field_energy")
    g_nl = _peaks_gamma(t, e, 1.0, 15.0)
    row("Landau nonlinear gamma (energy peaks, t in [1, 15]) vs root", g_nl,
        landau_root.imag, 0.05)
    for bf16 in (False, True):
        name = "Landau, linear" + (", bf16_weights" if bf16 else "")
        snaps, counts = run_case("4 physics", name, landau_cfg(linear=True, bf16=bf16))
        add(counts)
        g_li = _peaks_gamma(series(snaps, "time"), series(snaps, "field_energy"), 1.0, 15.0)
        row(f"{name} gamma vs the nonlinear run's", g_li, g_nl, 0.02)
        row(f"{name} gamma vs root", g_li, landau_root.imag, 0.06)

    cfg = two_stream_cfg()
    ts_root = root(cfg, 0.2, ts_guess)
    snaps, counts = run_case("4 physics", "two-stream, TWO_STREAM2", cfg)
    add(counts)
    t, e = series(snaps, "time"), series(snaps, "field_energy")
    row("two-stream gamma (t in [15, 35]) vs root", _energy_gamma(t, e, 15.0, 35.0),
        ts_root.imag, 0.08)
    ipk = next((i for i in range(1, len(e) - 1)
                if t[i] > 35.0 and e[i] >= e[i - 1] and e[i] > e[i + 1]), int(np.argmax(e)))
    ke = np.array([float(np.sum(s["total"])) for s in snaps])
    drift = float(np.max(np.abs(0.5 * ke + 0.5 * e - (0.5 * ke[0] + 0.5 * e[0]))) / ke[0])
    say(f"[4 physics] two-stream saturation peak at t = {t[ipk]:.1f} (limit "
        f"{cfg.time_max - 2.0}); total-energy drift {drift:.3e} of KE (limit 2e-3)")
    check(t[ipk] < cfg.time_max - 2.0 and drift < 2e-3, "two-stream saturation and energy")

    cfg = two_stream_cfg(deltaf=False)
    snaps, counts = run_case("4 physics", "two-stream, full-f", cfg)
    add(counts)
    row("two-stream full-f gamma (t in [10, 25]) vs root",
        _energy_gamma(series(snaps, "time"), series(snaps, "field_energy"), 10.0, 25.0),
        ts_root.imag, 0.05)

    for bf16 in (False, True):
        name = "two species" + (", bf16_weights" if bf16 else "")
        cfg = two_species_cfg(bf16)
        snaps, counts = run_case("4 physics", name, cfg)
        add(counts)
        row(f"{name} gamma (t in [10, 25]) vs 0.28451",
            _energy_gamma(series(snaps, "time"), series(snaps, "field_energy"), 10.0, 25.0),
            0.28451, 0.09)

    cfg = ion_acoustic_cfg()
    ia_root = root(cfg, 0.5, [0.098 - 0.008j, 0.118 - 0.010j, 0.078 - 0.006j])
    snaps, counts = run_case("4 physics", "ion-acoustic", cfg)
    add(counts)
    t = series(snaps, "time")
    fit = fit_mode_omega(t, series(snaps, "mode_re")[:, 0], series(snaps, "mode_im")[:, 0],
                         window=(60.0, 300.0))
    row("ion-acoustic omega (fit_mode_omega over (60, 300)) vs root", fit.real,
        abs(ia_root.real), 0.02)
    row("ion-acoustic gamma vs root", fit.imag, ia_root.imag, 0.08)
    return launches


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


def zero_substep_counts() -> None:
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    for k in sk.KERNELS:
        k.launches = 0


def substep_counts() -> dict:
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    return {k.name: k.launches for k in sk.KERNELS if k.launches}


def full_rho_phase(cfg) -> None:
    """diag_full_rho at the main shape: the full-spectrum rho's mode-1
    projection is the kept-mode rho (tests/test_tools.py:189-193), and what a
    snapshot costs with and without the flag."""
    from pic1dp_tpu_torch import Simulation

    zero_substep_counts()
    ms = {}
    with tempfile.TemporaryDirectory() as out:
        for flag in (False, True):
            sim = Simulation(dataclasses.replace(cfg, diag_full_rho=flag),
                             out_path=os.path.join(out, str(flag)), device="cuda")
            sim.load()
            sim.state = sim.stepper.multi_step(sim.state, 20)
            sim.output_snapshot()                       # warm-up
            torch.cuda.synchronize()
            ms[flag] = _events_ms(sim.output_snapshot, 5)
            sim.writer.close()
        deposit_ms = _events_ms(lambda: sim.stepper.full_rho(sim.state), 10)
    full, kept = sim.stepper.full_rho(sim.state).double(), sim.state.rho.double()
    k1 = torch.exp(2j * np.pi * torch.arange(cfg.nx, device="cuda") / cfg.nx)
    proj = 2.0 * (torch.mean(full * k1.conj()) * k1).real
    err = float((proj - kept).abs().max() / kept.abs().max())
    other = float((full - kept).abs().max() / kept.abs().max())
    say(f"[5 full rho] n={cfg.nparticle_max} nx={cfg.nx}: mode-1 projection of full_rho "
        f"against the kept-mode rho {err:.3e} of max (limit {FULL_RHO_TOL:g}); full rho "
        f"differs from it by {other:.3e} of max (the other modes' marker noise); launches "
        f"{substep_counts()}")
    check(err <= FULL_RHO_TOL, "full rho's mode-1 projection equals the kept-mode rho")
    check(other > 10 * FULL_RHO_TOL, "full rho holds more than the kept mode")
    check(tuple(full.shape) == (cfg.nx,) and bool(torch.isfinite(full).all()), "full rho finite")
    say(f"[5 full rho] one snapshot (energies, x-v histograms, host copy, write): "
        f"{ms[False]:.3f} ms without diag_full_rho, {ms[True]:.3f} ms with; full_rho alone "
        f"{deposit_ms:.3f} ms")


def explicit_phase(cfg) -> None:
    """The EXPLICIT grid path against the matrix-free kernels from one
    state: 5 steps in f32 at cfg's shape within the f32 bounds, in f64 at
    EXPLICIT_F64_N markers within 1e-12; ms/step of the grid path."""
    from pic1dp_tpu_torch.config import ParticleShape
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    small = dataclasses.replace(cfg, dtype="float64", nparticle_max=EXPLICIT_F64_N)
    for c in (cfg, small):
        zero_substep_counts()
        kern = Stepper(c, "cuda")
        grid = Stepper(dataclasses.replace(c, shape=ParticleShape.EXPLICIT), "cuda")
        raw = load_particles(c, "cuda")
        a, b = kern.initial_field(raw.clone()), grid.initial_field(raw.clone())
        a, b = kern.multi_step(a, 5), grid.multi_step(b, 5)
        torch.cuda.synchronize()
        check(substep_counts() == {k.name: 5 for k in kern.substeps.counters},
              "5 kernel steps beside 5 grid steps, which launch no kernel")
        if c.dtype == "float32":
            errs = dict(x=periodic_err(b.x, a.x, c.lx), v=abs_err(b.v, a.v), w=rel_err(b.w, a.w))
            limits = F32_TOL
        else:
            errs = {f: rel_err(getattr(b, f), getattr(a, f))
                    for f in ("v", "w", "mode_re", "mode_im", "electric")}
            errs["x"] = periodic_err(b.x, a.x, c.lx) / c.lx
            limits = dict.fromkeys(errs, F64_TOL)
        say(f"[5 explicit] {c.dtype} n={c.nparticle_max}: 5 grid-path steps against 5 kernel "
            f"steps: " + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in errs.items()))
        for k, v in errs.items():
            check(v <= limits[k], f"EXPLICIT {c.dtype} {k} within {limits[k]}")
        check(bool(torch.isfinite(b.w).all() and torch.isfinite(b.electric).all()),
              "EXPLICIT state finite")
        box = [b]

        def one():
            box[0] = grid.step(box[0])

        ms = _events_ms(one, 10)
        say(f"[5 explicit] {c.dtype} n={c.nparticle_max} nx={c.nx}: {ms:.4f} ms/step (eager "
            f"steps, index_add_ deposit)")
        del a, b, box, raw


def multirand_phase(cfg) -> None:
    """The main case loaded by the multirand backend with the native engine:
    the load's time, the markers of the first and the last rank block of a
    MULTIRAND_RANKS-rank load and the first velocities of the one-rank load
    against the Python oracle's draws, then 20 kernel steps."""
    from pic1dp_tpu_torch.config import RngConfig
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.rng import native
    from pic1dp_tpu_torch.rng.multirand import MultiRand

    check(native.available(), f"native multirand engine built: {native.build_error()}")
    cfg = dataclasses.replace(cfg, rng=RngConfig(backend="multirand"))
    rc, n = cfg.rng, cfg.nparticle_max
    start = time.perf_counter()
    state = load_particles(cfg, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    say(f"[5 multirand] {n} markers ({2 * n} draws, native engine "
        f"{native.library_path().name}) loaded in {seconds:.3f} s")

    def oracle(mype: int, count: int):
        eng = MultiRand(algorithm=rc.algorithm, seed_type=rc.seed_type, mype=mype,
                        warmup=rc.warmup)
        v = (eng.real_array(count) - 0.5) * 2.0 * cfg.v_max
        return v, eng.real_array(count) * cfg.lx

    def same(t, a) -> bool:
        return torch.equal(t.cpu(), torch.from_numpy(a).to(t.dtype))

    v0, _ = oracle(0, 10_000)
    check(same(state.v[0, :10_000], v0), "one-rank load: first 10,000 v equal the oracle's")
    ranked = load_particles(cfg, "cuda", emulate_ranks=MULTIRAND_RANKS)
    block = n // MULTIRAND_RANKS
    check(n % MULTIRAND_RANKS == 0, "equal rank blocks")
    for mype, sl in ((0, slice(0, block)), (MULTIRAND_RANKS - 1, slice(n - block, n))):
        v, x = oracle(mype, block)
        check(same(ranked.v[0, sl], v) and same(ranked.x[0, sl], x),
              f"{MULTIRAND_RANKS}-rank load: rank {mype}'s x and v equal the oracle's")
    say(f"[5 multirand] first 10,000 v of the one-rank load and the first and last "
        f"{block}-marker blocks (x and v) of a {MULTIRAND_RANKS}-rank load equal the Python "
        f"oracle's draws bit for bit")
    del ranked
    zero_substep_counts()
    st = Stepper(cfg, "cuda")
    state = st.multi_step(st.initial_field(state), 20)
    torch.cuda.synchronize()
    ok = all(bool(torch.isfinite(getattr(state, f)).all()) for f in ("x", "v", "w", "electric"))
    say(f"[5 multirand] 20 steps from the multirand state: finite {ok}; launches "
        f"{substep_counts()}")
    check(ok, "20 steps from the multirand state finite")
    check(substep_counts() == {k.name: 20 for k in st.substeps.counters},
          "20 steps, one launch of each kernel per step")


def checkpoint_phase(cfg) -> None:
    """cfg to CHECKPOINT_T[0], save_checkpoint, a fresh Simulation restores
    and runs to CHECKPOINT_T[1]: bit for bit the uninterrupted run."""
    from pic1dp_tpu_torch import Simulation

    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    t_save, t_end = CHECKPOINT_T
    zero_substep_counts()
    whole = Simulation(dataclasses.replace(cfg, time_max=t_end), device="cuda")
    whole.run()
    first = Simulation(dataclasses.replace(cfg, time_max=t_save), device="cuda")
    first.run()
    with tempfile.TemporaryDirectory() as out:
        start = time.perf_counter()
        path = first.save_checkpoint(os.path.join(out, "checkpoint.npz"))
        seconds = time.perf_counter() - start
        size = os.path.getsize(path)
        rest = Simulation(dataclasses.replace(cfg, time_max=t_end), device="cuda")
        start = time.perf_counter()
        rest.restore_checkpoint(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
    check(rest.itime == first.itime and rest.state.p.dtype == getattr(torch, cfg.p_dtype),
          f"{label} restored step count and p dtype")
    same = {f: torch.equal(getattr(rest.state, f), getattr(first.state, f))
            for f in ("x", "v", "p", "w", "live", "electric", "rho", "mode_re", "mode_im")}
    check(all(same.values()), f"{label} restored state bit-equal to the saved one: {same}")
    rest.run()
    torch.cuda.synchronize()
    same = {f: torch.equal(getattr(rest.state, f), getattr(whole.state, f))
            for f in ("x", "v", "w", "electric")}
    steps = whole.itime + first.itime + (rest.itime - first.itime)
    say(f"[5 checkpoint] {label} n={cfg.nparticle_max}: saved at t={first.time:.2f} "
        f"({size} bytes in {seconds:.3f} s, restored in {restore_s:.3f} s), resumed to "
        f"t={rest.time:.2f}: bitwise equal to the uninterrupted run {same}; launches "
        f"{substep_counts()}")
    check(rest.itime == whole.itime and all(same.values()),
          f"{label} resume = uninterrupted run bit for bit")
    check(substep_counts() == {k.name: steps for k in whole.stepper.substeps.counters},
          f"{label}: one launch of each kernel per step of the three runs")


def optimization_cfg():
    """bench/opt_onchip.py's schedule at its own width: merge at 50 and 62,
    importance-sampling remove at 56, split at 68."""
    from pic1dp_tpu_torch.config import OptimizationConfig, bump_on_tail_default

    return bump_on_tail_default(
        nparticle_max=OPT_N, time_max=OPT_TIME_MAX, output_interval=1.0, verbosity=0,
        optimization=OptimizationConfig(
            tmerge=(50.0, 62.0), thshmerge=(0.05, 0.1), tremove=(56.0,), typeremove=2,
            thshremove=(), tsplit=(68.0,), thshsplit=(0.9,), split_ngroup=2,
            split_dv_sig_frac=0.1))


def optimization_run(cfg):
    """Simulation.run of cfg with the live counts taken around each step
    that optimizes; returns the simulation, the events, the snapshots and
    the launch counts."""
    from pic1dp_tpu_torch import Simulation

    sim = Simulation(cfg, device="cuda")
    events, snaps = [], []
    step_once = sim.step_once

    def counted_step_once():
        due = sim._optimization_due()
        ops = [name for name, d in zip(("merge", "remove", "split"), due) if d is not None]
        before = int(sim.state.nparticles().sum()) if ops else None
        start = time.perf_counter()
        step_once()
        if ops:
            after = int(sim.state.nparticles().sum())     # waits for the device
            events.append(dict(time=round(sim.time, 6), ops=ops, n_before=before,
                               n_after=after, seconds=time.perf_counter() - start))

    sim.step_once = counted_step_once
    zero_substep_counts()
    start = time.perf_counter()
    sim.run(snapshot_callback=snaps.append)
    torch.cuda.synchronize()
    return sim, events, snaps, substep_counts(), time.perf_counter() - start


def compare_push_pair(cfg, state) -> None:
    """Stepper.push_pair with the kernels against the plain Stepper's on
    clones of one state on the card, within the f32 bounds (rho and E as the
    projections: relative to their max)."""
    from pic1dp_tpu_torch.core.step import Stepper

    a = Stepper(cfg, "cuda").push_pair(state.clone())
    b = Stepper(cfg, "cuda", plain=True).push_pair(state.clone())
    torch.cuda.synchronize()
    errs = dict(x=periodic_err(a.x, b.x, cfg.lx), v=abs_err(a.v, b.v), w=rel_err(a.w, b.w),
                rho=rel_err(a.rho, b.rho), electric=rel_err(a.electric, b.electric))
    limits = dict(F32_TOL, rho=F32_TOL["proj"], electric=F32_TOL["proj"])
    say(f"[5 optimization] push_pair, kernels against plain, n={cfg.nparticle_max} with "
        f"{int(state.live.sum())} live: "
        + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= limits[k], f"push_pair {k} within {limits[k]}")
    dead = ~state.live
    check(torch.equal(a.mode_re, state.mode_re) and torch.equal(a.mode_im, state.mode_im)
          and torch.equal(a.live, state.live) and float(a.w[dead].abs().max()) == 0.0,
          "push_pair keeps the step-start modes, the live set and w = 0 in dead slots")


def _moments(st) -> dict:
    """Sums over the markers that merge conserves, in float64, each beside
    the sum of its terms' magnitudes."""
    x, v, p, w = (getattr(st, f).double().cpu() for f in ("x", "v", "p", "w"))
    terms = dict(p=p, w=w, wx=w * x, wv=w * v)
    return {k: (float(t.sum()), float(t.abs().sum())) for k, t in terms.items()}


def compare_optimizations(cfg, state) -> None:
    """merge, remove, split and all three in one call on the card against
    the CPU in float64, with the same dice and normals, on a state whose live
    and dead slots are interleaved.  In float64 the card's result is the
    CPU's: the live masks equal but for OPT_F64_FLIPS markers at most (the
    profile is summed in another order, so a marker within rounding of a
    threshold may change sides) and x, v, p, w within 1e-12 of their max
    everywhere but around such a marker.  In float32 the card's live count
    and its sums of p, w, w x and w v are held to the CPU's within
    OPT_F32_LIVE and OPT_F32_SUM."""
    from pic1dp_tpu_torch.core import optimize as opt

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dice, normals = opt.draw_randoms(cfg, state, gen)
    o = cfg.optimization
    ops = dict(merge=dict(merge=o.thshmerge[1]), remove=dict(remove=0.0),
               split=dict(split=o.thshsplit[0]))
    ops["merge+remove+split"] = {k: v for d in ops.values() for k, v in d.items()}

    def widened(st, device):
        return dataclasses.replace(st, **{
            f: getattr(st, f).to(device=device, dtype=torch.float64)
            for f in ("x", "v", "p", "w", "rho", "electric", "mode_re", "mode_im")},
            live=st.live.to(device))

    cpu = widened(state, "cpu")
    dice64, normals64 = dice.double(), normals.double()
    for name, kw in ops.items():
        want = opt.apply_optimizations(cfg, cpu, dice64.cpu(), normals64.cpu(), **kw)
        got64 = opt.apply_optimizations(cfg, widened(state, "cuda"), dice64, normals64, **kw)
        got32 = opt.apply_optimizations(cfg, state, dice, normals, **kw)
        torch.cuda.synchronize()
        n_want = int(want.live.sum())
        check(n_want != int(state.live.sum()), f"{name} changes the live count")
        flips = int((got64.live.cpu() != want.live).sum())
        errs, off = {}, 0
        for f in ("x", "v", "p", "w"):
            a, b = getattr(got64, f).cpu(), getattr(want, f)
            d = (a - b).abs()
            if f == "x":
                d = torch.minimum(d, cfg.lx - d)
            scale = float(b.abs().max())
            off = max(off, int((d > F64_TOL * scale).sum()))
            errs[f] = float(d.max()) / scale
        say(f"[5 optimization] {name} on the card against the CPU, float64, same dice and "
            f"normals: live {int(state.live.sum())} -> {int(got64.live.sum())} (CPU {n_want}), "
            f"{flips} live bits differ, {off} markers beyond {F64_TOL:g} of max; worst "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(flips <= OPT_F64_FLIPS and off <= 64 * flips,
              f"{name} in float64 on the card equals the CPU's")
        check(got32.p.dtype == state.p.dtype and got32.x.dtype == state.x.dtype
              and float(got32.p[~got32.live].abs().max()) == 0.0
              and float(got32.w[~got32.live].abs().max()) == 0.0,
              f"{name} in float32 keeps the dtypes and the dead-slot invariant")
        n32 = int(got32.live.sum())
        m32, m64 = _moments(got32), _moments(want)
        sums = {k: abs(m32[k][0] - m64[k][0]) / m64[k][1] for k in m64}
        say(f"[5 optimization] {name} float32 on the card against the float64 CPU: live "
            f"{n32} vs {n_want} (limit {OPT_F32_LIVE:g} of it); sums relative to the sums of "
            f"magnitudes: " + ", ".join(f"{k} {v:.3e}" for k, v in sums.items())
            + f" (limit {OPT_F32_SUM:g})")
        check(abs(n32 - n_want) <= OPT_F32_LIVE * n_want, f"{name} float32 live count")
        check(max(sums.values()) <= OPT_F32_SUM, f"{name} float32 sums")


def optimization_phase() -> dict:
    """The merge/remove/merge/split schedule through Simulation.run with the
    kernels: the events in order, live counts, gamma before the first event,
    a finite state with the dead-slot invariant, two launches per step at
    the event steps too; whether a second run repeats the first; then, at
    this path's shape, both kernels against their plain versions on a loaded
    state and on the state the events left (live and dead slots
    interleaved), push_pair with the kernels against the plain Stepper's,
    and the three operations on the card against the CPU.  Returns each
    kernel's largest absolute error."""
    cfg = optimization_cfg()
    sim, events, snaps, counts, wall = optimization_run(cfg)
    for ev in events:
        say(f"[5 optimization] t={ev['time']:.2f} {'+'.join(ev['ops'])}: live "
            f"{ev['n_before']} -> {ev['n_after']} ({ev['seconds'] * 1e3:.1f} ms for the step)")
    check([ev["ops"] for ev in events] == [["merge"], ["remove"], ["merge"], ["split"]],
          "the four scheduled events ran, in order")
    check(all(ev["n_after"] > ev["n_before"] if ev["ops"] == ["split"]
              else ev["n_after"] <= ev["n_before"] for ev in events)
          and all(ev["n_after"] < ev["n_before"] for ev in events[:2]),
          "merge and remove lower the live count, split raises it")
    check(events[-1]["n_after"] <= cfg.nparticle_max, "live count within capacity")
    t = np.array([q["time"] for q in snaps])
    e = np.array([q["field_energy"] for q in snaps])
    gamma = _energy_gamma(t, e, *OPT_GAMMA_WINDOW)
    rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
    steps = round(cfg.time_max / cfg.dt)
    st = sim.state
    finite = bool(np.isfinite(e).all()) and all(
        bool(torch.isfinite(getattr(st, f)).all()) for f in ("x", "v", "p", "w", "electric"))
    dead = ~st.live
    say(f"[5 optimization] n={cfg.nparticle_max} to t={sim.time:.2f}: {sim.itime} steps, "
        f"{len(snaps)} snapshots, wall {wall:.2f} s; gamma over {OPT_GAMMA_WINDOW} "
        f"{gamma:.5f} vs {BOT_OMEGA.imag:.5f} (rel err {rel:.4f}, limit {GAMMA_REL_TOL}); "
        f"int E^2 dx at the end {e[-1]:.4e}; all finite {finite}; launches {counts}; "
        f"timers push pair {sim.timers.seconds('step: push pair'):.3f} s, optimize "
        f"{sim.timers.seconds('optimize particle'):.3f} s, collect + solve "
        f"{sim.timers.seconds('step: collect + solve'):.3f} s")
    check(sim.itime == steps and len(snaps) == round(cfg.time_max / cfg.output_interval) + 1,
          "optimization run step and snapshot counts")
    check(finite, "optimization run finite")
    check(rel <= GAMMA_REL_TOL, "optimization run gamma within 5% of the dispersion root")
    check(counts == {k.name: steps for k in sim.stepper.substeps.counters},
          "two kernel launches per step, the four push_pair steps included")
    check(float(st.p[dead].abs().max()) == 0.0 and float(st.w[dead].abs().max()) == 0.0,
          "dead-slot invariant after the events")
    check(int(st.live.sum()) == events[-1]["n_after"], "final live count is the last event's")
    again, events2, _, _, _ = optimization_run(cfg)
    same_counts = [ev["n_after"] for ev in events2] == [ev["n_after"] for ev in events]
    same_state = all(torch.equal(getattr(again.state, f), getattr(st, f))
                     for f in ("x", "v", "w", "live"))
    say(f"[5 optimization] a second run: live counts after the events "
        f"{[ev['n_after'] for ev in events2]}, equal to the first run's {same_counts}; final "
        f"x, v, w, live bitwise equal {same_state} (the profile is an index_add_ with float "
        f"atomics: reported, not required)")
    del again
    inputs = _loaded_inputs(cfg)
    worst = compare_substeps(cfg, OPT_N, F32_TOL, inputs)
    for name, err in compare_substeps(cfg, OPT_N, F32_TOL,
                                      (st.x, st.v, st.p, st.w, *inputs[4:])).items():
        worst[name] = max(worst[name], err)
    compare_push_pair(cfg, st)
    compare_optimizations(cfg, st)
    return worst


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


def time_steppers(cfg, smi: str) -> dict:
    """ms/step of the plain Stepper, of the kernel Stepper's eager steps and
    of its CUDA graph replays, in turns plain, eager, graph, graph, eager,
    plain; returns the means.  A graph turn captures its TIMING_STEPS-step
    graph before the timed replay."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    kern, plain = Stepper(cfg, "cuda"), Stepper(cfg, "cuda", plain=True)
    state0 = kern.initial_field(load_particles(cfg, "cuda"))
    say(f"[6 timing] before: {device_state()}")
    ms = {"plain": [], "eager": [], "graph": []}
    for which in ("plain", "eager", "graph", "graph", "eager", "plain"):
        st = plain if which == "plain" else kern
        box = [st.multi_step(state0.clone(), WARMUP_STEPS)]
        if which == "graph":
            box[0] = st.graph_steps(box[0], TIMING_STEPS)   # captures the graph
        torch.cuda.synchronize()

        def one():
            box[0] = st.step(box[0])

        if which == "graph":
            ms[which].append(_events_ms(lambda: st.graph_steps(box[0], TIMING_STEPS), 1)
                             / TIMING_STEPS)
        else:
            ms[which].append(_events_ms(one, TIMING_STEPS))
        check(bool(torch.isfinite(box[0].w).all()), f"{which} timing run finite")
        del box
    say(f"[6 timing] after: {device_state()}")
    mean = {w: float(np.mean(v)) for w, v in ms.items()}
    n = cfg.nspecies * cfg.nparticle_max
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    say(f"[6 timing] n={n} nx={cfg.nx} {label}: "
        + "; ".join(f"{w} {mean[w]:.4f} ms/step ({v[0]:.4f}, {v[1]:.4f}) = "
                    f"{n / mean[w] * 1e3:.4e} pushes/s" for w, v in ms.items())
        + f"; card {smi}")
    return mean


def stream_bytes(cfg, substep: int, lay: str) -> int:
    """Bytes per marker that a substep kernel must move in layout `lay`:
    each stream it reads once and each it writes once (the mode scalars,
    the angle table and the per-block partials are a few KB per call and
    left out)."""
    from pic1dp_tpu_torch.ops.substep_kernels import FULLF, LINEAR, NONLINEAR, RECOMPUTE

    f = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    n = torch.empty((), dtype=getattr(torch, cfg.p_dtype)).element_size()
    reads = {NONLINEAR: {1: [f, f, n, f], 2: [f, f, n, f, n, f]},
             RECOMPUTE: {1: [f, f, n, f], 2: [f, f, n, f, n]},
             LINEAR: {1: [f, f, n, f], 2: [f, f, n, f, n]},
             FULLF: {1: [f, f, n], 2: [f, f, n]}}[lay][substep]
    writes = {NONLINEAR: {1: [n, f], 2: [f, f, f]}, RECOMPUTE: {1: [n], 2: [f, f, f]},
              LINEAR: {1: [n], 2: [f, f]}, FULLF: {1: [], 2: [f, f]}}[lay][substep]
    return sum(reads) + sum(writes)


def substep_ops(cfg, substep: int, lay: str, n: int, blocks: int,
                grid_bin: bool | None = None) -> int:
    """Operations of one call of a substep kernel on n markers in `blocks`
    blocks, layout `lay`, an FMA counted as two; the smaller of the two
    forms of the function, whichever bin runs it.  Per marker: substep 1's
    push 32 (one wrap 8, the w update 5, the drive 17, v 2), substep 2's 40
    (two wraps), one gather of E at a position and one deposit, and where
    substep 2 rebuilds v1 one gather at x0 and 2 more.  In the per-mode form
    of the register bins (at most 4 modes) a gather or deposit takes 4 for
    its cell and 13 per kept mode (the table entry's fold 9, the sum 4; no
    transcendental, the angles come from the table).  In the grid form
    (grid_bin, by default above 4 modes) a gather takes 4 for the cell and
    3 for the lerp, a deposit 4 for the cell, 3 for the two hat weights and
    2 adds, and each block forms each of its E grids and projects its
    charge grid with 2 FMAs per cell and mode (4 nx nmode each)."""
    from pic1dp_tpu_torch.ops.substep_kernels import FULLF, GRID_BIN, RECOMPUTE, mode_bin

    if grid_bin is None:
        grid_bin = mode_bin(cfg.nmode) == GRID_BIN
    rebuild = substep == 2 and lay in (FULLF, RECOMPUTE)
    push = 32 if substep == 1 else 40
    if not grid_bin:
        position = 4 + 13 * cfg.nmode
        return n * (2 * position + push + (position + 2 if rebuild else 0))
    per_marker = 7 + 9 + push + (9 if rebuild else 0)
    per_block = 4 * cfg.nx * cfg.nmode * ((2 if rebuild else 1) + 1)
    return n * per_marker + blocks * per_block


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least ms the card could take: bytes over HBM's rate or
    operations over the f32 rate, whichever is larger, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(cfg, inputs=None, stream_v1: bool | None = None,
                 with_plain: bool = True) -> tuple[dict, dict]:
    """ms per call of each substep kernel of cfg and of its plain version
    (unless with_plain is False: many modes at 2^26 markers, where the
    plain version's per-mode temporaries take tens of GB) at cfg's shape,
    on the card's clock: calls captured in a CUDA graph and replayed
    (probes.graph_ms), so that a small case is not timed at the host's
    launch rate (these launches come after the main paths' counts were
    read); and each kernel's bound at that shape.  The line printed gives
    the share of the bound, V, B, the grid, the bin and where the angle
    table or the grids sat."""
    from pic1dp_tpu_torch.ops import substep_kernels as sk
    from pic1dp_tpu_torch.probes import graph_ms

    x, v, p, w, (mre0, mim0, mre1, mim1), sp = inputs or _inputs(
        cfg, cfg.nparticle_max, "cuda")
    subs = sk.FusedSubsteps(cfg, sp, stream_v1=stream_v1)
    w1, v1, _ = subs.substep1(x, v, p, w, mre0, mim0)
    k1, k2 = (k.name for k in subs.counters)
    out = {}
    for name, fn in ((k1, lambda: subs.substep1(x, v, p, w, mre0, mim0)),
                     (f"{k1}_plain", lambda: subs.substep1_plain(x, v, p, w, mre0, mim0)),
                     (k2, lambda: subs.substep2(x, v, p, w, w1, v1, mre1, mim1, mre0, mim0)),
                     (f"{k2}_plain", lambda: subs.substep2_plain(x, v, p, w, w1, v1, mre1,
                                                                 mim1, mre0, mim0))):
        if with_plain or not name.endswith("_plain"):
            out[name] = graph_ms(fn, x.device)
    n = x.numel()
    vec = sk.vector_width(cfg.nmode, x.element_size())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = {ss: subs.grid_size(n, sms, x.element_size(), ss) for ss in (1, 2)}
    nbytes = {ss: stream_bytes(cfg, ss, subs.layout) for ss in (1, 2)}
    bounds = {name: bound(n * nbytes[ss], substep_ops(cfg, ss, subs.layout, n, grid[ss]))
              for name, ss in ((k1, 1), (k2, 2))}
    smem = sk.angle_smem_bytes(cfg.nmode, cfg.nx, x.element_size())
    if subs.uses_grid_bin():
        grids = [sk.grid_smem(cfg.nx, x.element_size(), sk.grid_egrids(ss)) for ss in (1, 2)]
        where = "grid bin, grids in " + ", ".join(
            f"substep {ss}: " + (f"shared memory ({b} B, {c} charge grids)" if b
                                 else "the device buffer") for ss, (b, c) in zip((1, 2), grids))
    else:
        where = f"{cfg.nmode if cfg.nmode == 1 else 4}-mode bin, angle table in " + (
            f"shared memory ({smem} B)" if smem else "device memory")
    say(f"[6 timing] {cfg.equilibrium.value} {'bf16_weights' if cfg.bf16_weights else cfg.dtype}"
        f" per call at {cfg.nspecies} x {cfg.nparticle_max} markers, nx {cfg.nx}, "
        f"{cfg.nmode} modes, {subs.layout}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()) + "; bound "
        + ", ".join(f"{k} {b:.4f} ms ({by}, {nbytes[ss]} B/marker), share "
                    f"{b / out[k]:.1%}" for (k, (b, by)), ss in zip(bounds.items(), (1, 2)))
        + f"; V {vec}, B {subs.blocks_per_sm}, grid {grid[1]} / {grid[2]}, {where}")
    return out, bounds


def time_stream_plain() -> float:
    """ms per call of stream_plain on the substep-2 pattern (4r+3w aliased)
    at 2^PROBE_LOG2, the pattern the stream kernels' "ms" is read at."""
    from pic1dp_tpu_torch.ops.stream_probes import stream_plain
    from pic1dp_tpu_torch.probes import fresh_streams, pipeline_probe

    ins = fresh_streams(4, 2**PROBE_LOG2, torch.device("cuda"), seed=7)
    fn = lambda: stream_plain(ins, 3, pipeline_probe.ALIAS)   # noqa: E731
    fn()
    ms = _events_ms(fn, 10)
    say(f"[6 timing] stream_plain 4r+3w aliased n=2^{PROBE_LOG2}: {ms:.4f} ms")
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
    say(f"[6 timing] per call at n=2^{PROBE_LOG2} (trig x4, fresh outputs; carry in "
        f"place): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


# ---- phase 7: the substep kernels' last layouts, the phase table, the
# profiler ----

@contextlib.contextmanager
def stream_v1_env(stream_v1: bool):
    """PIC1DP_STREAM_V1 set for the block (a Stepper reads it when made)."""
    old = os.environ.get("PIC1DP_STREAM_V1")
    os.environ["PIC1DP_STREAM_V1"] = "1" if stream_v1 else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PIC1DP_STREAM_V1"]
        else:
            os.environ["PIC1DP_STREAM_V1"] = old


def compare_v1_layouts(cfg, k: int = GRAPH_CHECK_STEPS) -> None:
    """k steps of the recompute layout against k of the streamed layout from
    one loaded state, every field bit for bit (the JAX package requires as
    much: tests/test_spectral_path.py:504-528)."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    with stream_v1_env(True):
        streamed = Stepper(cfg, "cuda")
    with stream_v1_env(False):
        rebuilt = Stepper(cfg, "cuda")
    a = streamed.initial_field(load_particles(cfg, "cuda"))
    b = a.clone()
    for _ in range(k):
        a, b = streamed.step(a), rebuilt.step(b)
    torch.cuda.synchronize()
    fields = ("x", "v", "w", "mode_re", "mode_im", "electric", "rho")
    same = {f: torch.equal(getattr(a, f), getattr(b, f)) for f in fields}
    say(f"[7 layouts] {'bf16_weights' if cfg.bf16_weights else cfg.dtype} "
        f"{cfg.nspecies}x{cfg.nparticle_max} nmode={cfg.nmode}: {k} recompute steps "
        f"({[c.name for c in rebuilt.substeps.counters]}) against {k} streamed steps "
        f"({[c.name for c in streamed.substeps.counters]}): bitwise equal {same}")
    check(all(same.values()), "recompute layout = streamed layout bit for bit")


def v1_layout_phase(main_cfg, bf16_cfg) -> tuple[dict, dict]:
    """Both nonlinear delta-f layouts at the main shape in f32 and
    bf16_weights: the kernels of the layout the config does not take
    (substep_kernels.layout; phase 3 holds the one it takes) against their
    plain versions (f32 bounds; both layouts in f64 at 1e-12), both layouts
    stepped side by side bit for bit, and the other layout through graph =
    eager and its run to t = 100 (main_path: gamma, counts, profiler).
    Returns the launches of that layout's kernels on its run and their
    errors."""
    from pic1dp_tpu_torch.ops.substep_kernels import NONLINEAR, layout

    launches, err = {}, {}
    for cfg in (main_cfg, bf16_cfg):
        other = layout(cfg) != NONLINEAR          # stream_v1 of the other layout
        err.update(compare_substeps(cfg, FULL_N, F32_TOL, stream_v1=other))
        compare_v1_layouts(cfg)
        with stream_v1_env(other):
            compare_graph(cfg)
            zero_substep_counts()
            counts, _ = main_path(cfg, "7 layouts")
        launches.update({k: v for k, v in counts.items() if v})
    f64 = dataclasses.replace(main_cfg, dtype="float64", nparticle_max=F64_N)
    for stream_v1 in (True, False):
        compare_substeps(f64, F64_N, None, stream_v1=stream_v1)
    return launches, err


def repeat_launches(cfg, stream_v1: bool) -> None:
    """Each kernel launched twice on the same inputs: every output bit for
    bit (no float atomic in any sum, a fixed grid)."""
    from pic1dp_tpu_torch.ops.substep_kernels import FusedSubsteps

    x, v, p, w, (mre0, mim0, mre1, mim1), sp = _inputs(cfg, cfg.nparticle_max, "cuda")
    subs = FusedSubsteps(cfg, sp, stream_v1=stream_v1)
    one = [subs.substep1(x, v, p, w, mre0, mim0) for _ in range(2)]
    outs = [[t for t in (one[k][0], one[k][1], *one[k][2]) if t is not None] for k in (0, 1)]
    for _ in range(2):
        st = [t.clone() for t in (x, v, w)]
        x2, v2, w2, proj = subs.substep2(st[0], st[1], p, st[2], one[0][0], one[0][1], mre1,
                                         mim1, mre0, mim0)
        outs.append([x2, v2, w2, *proj])
    torch.cuda.synchronize()
    same = [all(torch.equal(a, b) for a, b in zip(outs[k], outs[k + 1])) for k in (0, 2)]
    say(f"[7 modes] nmode={cfg.nmode} {subs.layout} n={cfg.nparticle_max}: each kernel "
        f"launched twice on the same inputs, bitwise equal {same}")
    check(all(same), "a repeated launch gives the same bits")


# the grid bin's shared-memory cases (f32 and f64 at 16 and 64 modes): nx
# 1024 (an opt-in past 48 KB in f64), 4096 (4 charge grids in f64) and one
# nx whose grids do not fit even once (the device buffer)
GRID_NX = (1024, 4096, 32768)


def many_modes_phase() -> dict:
    """The grid bin (more than 4 kept modes): the kernels of both nonlinear
    layouts against their plain versions at 16, 32 and 64 modes at the main
    width in f32 and at 2^16 markers in f64 (1e-12), bf16_weights at 32
    modes, every GRID_NX at 16 and 64 modes in f32 and f64, linear and
    full-f at 16 modes at their verification cases' shapes (full-f against
    the plain version in f64); repeated launches, graph = eager and
    recompute = streamed bit for bit at 32 modes; and a run to t = 70 with
    32 modes whose mode 1 grows at the dispersion root's rate (fit of
    ln |mode 1| over the linear window).  Returns the run's launches."""
    cfg = many_modes_cfg(32, time_max=GAMMA_WINDOW[1])
    check(cfg.nmode == 32 and cfg.nparticle_max == FULL_N and cfg.nx == 192,
          "32 modes at full width")
    for nmode in (16, 32, 64):
        full = many_modes_cfg(nmode)
        small = dataclasses.replace(full, dtype="float64", nparticle_max=2**16)
        for stream_v1 in (True, False):
            compare_substeps(full, FULL_N, F32_TOL, stream_v1=stream_v1)
            compare_substeps(small, 2**16, None, stream_v1=stream_v1)
    compare_substeps(many_modes_cfg(32, bf16_weights=True), FULL_N, F32_TOL)
    for nx in GRID_NX:
        for nmode in (16, 64):
            for dtype, tol in (("float32", F32_TOL), ("float64", None)):
                c = dataclasses.replace(many_modes_cfg(nmode), nx=nx, nparticle_max=2**16,
                                        dtype=dtype)
                for stream_v1 in (True, False):
                    compare_substeps(c, 2**16, tol, stream_v1=stream_v1)
    for case in (landau_cfg(linear=True), two_stream_cfg(deltaf=False)):
        c = dataclasses.replace(case, modes=tuple(range(1, 17)))
        c64 = dataclasses.replace(c, dtype="float64")
        compare_substeps(c, c.nparticle_max, F32_TOL, _loaded_inputs(c), plain_f64=not c.deltaf)
        compare_substeps(c64, c64.nparticle_max, None, _loaded_inputs(c64))
    for stream_v1 in (True, False):
        repeat_launches(many_modes_cfg(32), stream_v1)
    compare_graph(cfg)
    compare_v1_layouts(dataclasses.replace(cfg, nparticle_max=2**20))
    zero_substep_counts()
    snaps, launches = run_case("7 modes", "32 kept modes", cfg)
    t = np.array([q["time"] for q in snaps])
    amp = np.array([np.hypot(q["mode_re"][0], q["mode_im"][0]) for q in snaps])
    m = (t >= GAMMA_WINDOW[0]) & (t <= GAMMA_WINDOW[1])
    gamma = float(np.polyfit(t[m], np.log(amp[m]), 1)[0])
    rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
    top = [int(np.argmax(np.hypot(snaps[-1]["mode_re"], snaps[-1]["mode_im"]))) + 1]
    say(f"[7 modes] 32 kept modes: mode 1 gamma (ln |mode 1| over {GAMMA_WINDOW}) "
        f"{gamma:.5f} vs {BOT_OMEGA.imag:.5f}, rel err {rel:.4f} (limit {GAMMA_REL_TOL}); "
        f"largest mode at the end: {top}")
    check(rel <= GAMMA_REL_TOL, "32 modes: mode 1's growth within 5% of the root")
    return launches


def nine_species_phase() -> dict:
    """Landau k = 0.5 as nine identical species (nine_species_cfg): the
    kernels against their plain versions in f32 and f64 (species 8 takes its
    constants from the species table), graph = eager, and Simulation.run
    to t = 20, gamma from the energy peaks within the example's 5% of the
    one-species root.  Returns the run's launches."""
    from pic1dp_tpu_torch.analysis.dispersion import Dispersion, species_for_config

    cfg = nine_species_cfg()
    compare_substeps(cfg, cfg.nparticle_max, F32_TOL, _loaded_inputs(cfg))
    small = nine_species_cfg("float64", 2**14)
    for stream_v1 in (True, False):
        compare_substeps(small, small.nparticle_max, None, _loaded_inputs(small),
                         stream_v1=stream_v1)
    compare_graph(cfg)
    zero_substep_counts()
    snaps, launches = run_case("7 species", "nine species", cfg)
    root = Dispersion(species_for_config(landau_damping_cfg()), 0.5).solve_omega()
    t = np.array([q["time"] for q in snaps])
    gamma = _peaks_gamma(t, np.array([q["field_energy"] for q in snaps]), 1.0, 15.0)
    rel = abs(gamma - root.imag) / abs(root.imag)
    say(f"[7 species] nine species: gamma (energy peaks, t in [1, 15]) {gamma:.5f} vs the "
        f"one-species root {root.imag:.5f}, rel err {rel:.4f} (limit 0.05)")
    check(rel <= 0.05, "nine species gamma within 5% of the root")
    return launches


def idle_share(stepper, state, steps: int) -> tuple[float, float]:
    """ms/step and the share of the time the card runs no kernel, over one
    replay of a `steps`-step CUDA graph under torch.profiler (from the
    first kernel's start to the last one's end)."""
    stepper.graph_steps(state, steps)                  # captures the graph
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            stepper.graph_steps(state, steps)
            torch.cuda.synchronize()
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events
                   if ev.get("cat") == "kernel" and "dur" in ev)
    check(len(spans) > 0, "the profiler saw the graph's kernels")
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = spans[-1][1] - spans[0][0]
    return span / steps * 1e-3, 1.0 - busy / span


def phase_table_phase() -> dict:
    """The phase table (utils/phase_split.py) at the main shape and the
    headline in f32, in both nonlinear layouts, each with the step minus
    its two kernels and the idle share of a 50-step graph replay."""
    from pic1dp_tpu_torch.config import bump_on_tail_default
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.utils.phase_split import format_phase_table, measure_phase_split

    out = {}
    for label, cfg in (("main", bump_on_tail_default(verbosity=0)),
                       ("headline", bump_on_tail_default(nparticle_max=BENCH_N, nx=BENCH_NX,
                                                         verbosity=0))):
        for stream_v1 in (True, False):
            with stream_v1_env(stream_v1):
                st = Stepper(cfg, "cuda")
            state = st.initial_field(load_particles(cfg, "cuda"))
            table = measure_phase_split(st, state, steps=10)
            rest = (table["full step (measured)"] - table["substep-1 kernel (fused)"]
                    - table["substep-2 kernel (fused)"])
            ms, idle = idle_share(st, state, TIMING_STEPS)
            name = f"{label} {st.substeps.layout}"
            say(f"[7 phase table] {name}, n={cfg.nparticle_max} nx={cfg.nx} f32:")
            for line in format_phase_table(table).splitlines():
                say(f"[7 phase table]   {line}")
            say(f"[7 phase table] {name}: step minus the two kernels {rest * 1e3:.4f} ms; "
                f"{TIMING_STEPS}-step graph replay under the profiler {ms:.4f} ms/step, idle "
                f"share {idle:.4f} (no kernel running)")
            check(all(np.isfinite(v) and v >= 0.0 for v in table.values()),
                  "phase table finite")
            out[name] = dict(table, idle=idle)
            del state, st
            torch.cuda.empty_cache()
    return out


def profile_phase(steps: int = 50) -> None:
    """run.py --profile on the card: the main case for `steps` steps, the
    trace's substep kernels by name equal to the counters (the run is made
    again, up to PROFILER_TRIES times, while the profiler sees fewer)."""
    from pic1dp_tpu_torch import run
    from pic1dp_tpu_torch.config import bump_on_tail_default

    cfg = bump_on_tail_default(verbosity=0)
    for attempt in range(1, PROFILER_TRIES + 1):
        with tempfile.TemporaryDirectory() as out:
            zero_substep_counts()
            check(run.main(["-s", f"time_max={steps * cfg.dt}", "-s", "verbosity=0",
                            "--no-output", "--profile", out]) == 0, "run.py --profile")
            counts = substep_counts()
            with open(os.path.join(out, run.TRACE_FILE)) as fh:
                events = json.load(fh)["traceEvents"]
        seen = {}
        for ev in events:
            name = substep_counter(ev.get("name", "")) if ev.get("cat") == "kernel" else None
            if name is not None:
                seen[name] = seen.get(name, 0) + 1
        say(f"[7 profile] run.py --profile, {steps} steps at {cfg.nparticle_max} markers: "
            f"{len(events)} trace events; substep kernels in the trace {seen}, counters "
            f"{counts} (run {attempt} of at most {PROFILER_TRIES})")
        check(len(counts) == 2 and all(v == steps for v in counts.values()),
              f"{steps} launches of each of the two kernels")
        check(all(v <= counts.get(n, 0) for n, v in seen.items()),
              "the trace holds no substep kernel beyond the counters")
        if seen == counts:
            return
    check(False, f"the trace's substep kernels equal the counters in one of "
          f"{PROFILER_TRIES} runs")


def compare_v1_steps(cfg, smi: str) -> dict:
    """ms/step of CUDA graph replays of both nonlinear layouts in turns
    streamed, recompute, recompute, streamed (TIMING_STEPS steps each, after
    the graph's capture): each layout's mean and its two turns."""
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.ops.substep_kernels import layout

    steppers = {}
    for stream_v1 in (True, False):
        with stream_v1_env(stream_v1):
            steppers[stream_v1] = Stepper(cfg, "cuda")
    state0 = steppers[True].initial_field(load_particles(cfg, "cuda"))
    ms = {True: [], False: []}
    for stream_v1 in (True, False, False, True):
        st = steppers[stream_v1]
        box = [st.multi_step(state0.clone(), WARMUP_STEPS)]
        box[0] = st.graph_steps(box[0], TIMING_STEPS)
        torch.cuda.synchronize()
        ms[stream_v1].append(_events_ms(lambda: st.graph_steps(box[0], TIMING_STEPS), 1)
                             / TIMING_STEPS)
        del box
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    say(f"[7 timing] graph ms/step {cfg.nspecies}x{cfg.nparticle_max} nx={cfg.nx} "
        f"nmode={cfg.nmode} {label}: streamed "
        f"{mean[True]:.4f} ({ms[True][0]:.4f}, {ms[True][1]:.4f}), recompute "
        f"{mean[False]:.4f} ({ms[False][0]:.4f}, {ms[False][1]:.4f}); recompute/streamed "
        f"{mean[False] / mean[True]:.4f}; the config takes {layout(cfg)}; card {smi}")
    return mean


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
    angle_tables()
    err = compare_substeps(main_cfg, FULL_N, F32_TOL)
    err.update(compare_substeps(bf16_cfg, FULL_N, F32_TOL))
    f64 = dataclasses.replace(main_cfg, dtype="float64", nparticle_max=F64_N,
                              modes=(1, 2, 3), init_modes=(1, 2),
                              init_amp_cos=(1e-5, 0.0), init_amp_sin=(1e-4, 5e-5))
    compare_substeps(f64, F64_N, None)
    compare_substeps(dataclasses.replace(f64, modes=(1,), init_modes=(1,),
                                         init_amp_cos=(0.0,), init_amp_sin=(1e-5,)),
                     F64_N, None)
    err.update(compare_layouts())
    compare_steppers(main_cfg)
    compare_steppers(bf16_cfg)
    compare_graph(main_cfg)
    compare_graph(two_species_cfg())
    err.update(compare_streams(2**PROBE_LOG2 + 13))
    err.update(compare_units(2**PROBE_LOG2 + 13))
    err.update(compare_carry(2**PROBE_LOG2 + 13))
    torch.cuda.synchronize()

    launches, gamma32 = main_path(main_cfg)
    bf16_launches, gamma16 = main_path(bf16_cfg)
    say(f"[4 main path] gamma f32 {gamma32:.5f}, bf16_weights {gamma16:.5f}, "
        f"theory {BOT_OMEGA.imag:.5f}")
    launches.update({k: v for k, v in bf16_launches.items() if "bf16" in k})
    for k, v in physics_path().items():   # the layouts' kernels: their cases' counts
        if v and not launches.get(k):
            launches[k] = v
    stream_launches, rows = probes_path()
    launches.update(stream_launches)

    full_rho_phase(main_cfg)
    explicit_phase(main_cfg)
    multirand_phase(main_cfg)
    checkpoint_phase(main_cfg)
    checkpoint_phase(bf16_cfg)
    for name, e in optimization_phase().items():
        err[name] = max(err[name], e)
    torch.cuda.synchronize()

    v1_launches, v1_err = v1_layout_phase(main_cfg, bf16_cfg)
    err.update({k: max(v, err.get(k, 0.0)) for k, v in v1_err.items()})
    for k, v in v1_launches.items():     # the other layout's kernels: its run's counts
        if not launches.get(k):
            launches[k] = v
    many_modes_phase()
    nine_species_phase()
    phase_table_phase()
    profile_phase()
    torch.cuda.synchronize()

    # each layout's kernels at the shape of each of its verification cases;
    # the kernels line keeps the first shape a kernel was timed at (the main
    # path's for the nonlinear kernels in both layouts, Landau's for linear,
    # 2^24 for full-f)
    per_call, bounds = {}, {}
    timed = [(cfg, None, stream_v1) for cfg in (main_cfg, bf16_cfg) for stream_v1 in (True, False)]
    timed += [(c, _loaded_inputs, None) for c in (
        landau_cfg(linear=True), landau_cfg(linear=True, bf16=True), two_stream_cfg(deltaf=False))]
    for cfg, inputs, stream_v1 in timed:
        ms, b = time_kernels(cfg, inputs and inputs(cfg), stream_v1)
        for name in ms:
            per_call.setdefault(name, ms[name])
            if name in b:
                bounds.setdefault(name, b[name])
        torch.cuda.synchronize()
    # both nonlinear delta-f layouts, per call and per graph step in turns,
    # on each side of substep_kernels.rebuilds_v1_faster's line: the 1-, 4-,
    # 16- and 32-mode bins at the main width (64 modes per call only), the
    # species loop at 2 x 2^20 and 2 x 2^22 markers, and the cases of 1M
    # markers or fewer (printed only)
    headline = bump_on_tail_default(nparticle_max=BENCH_N, nx=BENCH_NX, verbosity=0)
    head16 = dataclasses.replace(headline, bf16_weights=True)
    for cfg in (main_cfg, bf16_cfg, headline, head16):
        compare_v1_steps(cfg, smi)
    # the grid bin at the headline's width and nx with 32 kept modes, the
    # kernels alone in both layouts
    head32 = many_modes_cfg(32, nparticle_max=BENCH_N, nx=BENCH_NX)
    for stream_v1 in (True, False):
        time_kernels(head32, None, stream_v1, with_plain=False)
    torch.cuda.empty_cache()
    for cfg, inputs in (
            (many_modes_cfg(4), None), (many_modes_cfg(4, bf16_weights=True), None),
            (many_modes_cfg(16), None), (many_modes_cfg(32), None), (many_modes_cfg(64), None),
            *((c, _loaded_inputs) for c in (
                two_species_cfg(), two_species_cfg(bf16=True), ion_acoustic_cfg(),
                two_stream_cfg(), nine_species_cfg(), landau_cfg()))):
        for stream_v1 in (True, False):
            time_kernels(cfg, inputs and inputs(cfg), stream_v1)
        if cfg.nmode < 64:
            compare_v1_steps(cfg, smi)
        torch.cuda.empty_cache()
    # the stream, unit and carry kernels move 4 reads and 3 writes of 2^26
    # f32 values; their operations per element: the sum's adds, and for trig
    # x4 four trig units at the substep cost estimate's per-mode share
    n = 2**PROBE_LOG2
    for name, ops in (("stream_rw", 7), ("stream_bulk", 7), ("stream_units", 7 + 4 * 32),
                      ("stream_bulk_units", 7 + 4 * 32), ("stream_carry", 7)):
        bounds[name] = bound(7 * 4 * n, ops * n)
    per_call["stream_rw"] = rows["kernel_probe: ss2 pattern 4r+3w aliased"].ms
    per_call["stream_bulk"] = rows["pipeline_probe: bulk 8 KB x 4 aliased"].ms
    per_call["stream_rw_plain"] = per_call["stream_bulk_plain"] = time_stream_plain()
    per_call.update(time_probe_kernels())
    time_steppers(main_cfg, smi)
    time_steppers(headline, smi)
    time_steppers(head16, smi)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                "max_abs_err": err[k.name], "ms": per_call[k.name],
                "plain_ms": per_call[f"{k.name}_plain"], "bound_ms": bounds[k.name][0],
                "bound_by": bounds[k.name][1], "library_ms": None}
               for k in sk.KERNELS + sp.KERNELS]
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched on its main path")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
