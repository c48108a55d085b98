"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives pic1dp_tpu_torch's main paths — the default bump-on-tail run at its
full width of 6.4M markers, in f32 and with bf16_weights, through the
hand-written CUDA substep kernels, in both nonlinear delta-f layouts, with
32 kept modes and with nine species, and split over a one-rank NCCL mesh
and two gloo ranks; the reference's verification cases (Landau damping
nonlinear and linear, two-stream in delta-f and full-f, two species,
ion-acoustic) through the substep kernels of their layouts, configured and
fitted by the port's example scripts; the analysis tools on the main run's
output; the snapshot histograms, the optimization profile and the grid charge
through the hat-deposit kernels; and the five probes through the stream kernels —
and checks them.  It imports
neither jax nor pic1dp_tpu, catches nothing, and exits non-zero at the
first failed check.  Phases, each printed:

  1. environment: torch, CUDA, triton and nvcc versions, the card
  2. build: nvcc builds every kernel source of pic1dp_tpu_torch/csrc (each
     hashed with the headers beside it), one process per source, all at
     once; the ptxas lines of the main path's and the grid bin's substep
     kernels and of every instantiation of the bulk-copy ring
  3. each kernel against its plain PyTorch version on the same inputs:
     the main substeps in f32 and bf16_weights at full width and in f64
     with three modes; wherever the substeps are compared, the modes their
     last block solves (solve=True) against Stepper._solve of their own
     projections, bit for bit, on a launch and on a CUDA graph replay; the
     angle table as the kernels read it, bit for bit; each layout's
     substeps at the shape of its
     verification case in f32 (and bf16_weights where it has a bf16 build),
     and every variant of the reference's _pallas_cases in f64; five Stepper
     steps in f32 and bf16; k steps replayed from a CUDA graph against k
     eager steps, bit for bit; both stream kernels on every built pattern, both unit
     kernels for every unit and K in {0, 1, 4} at eps = 1 and 1e-12, the
     ring (stream_bulk, stream_bulk_units) in each of the overlap probe's
     three rings at an odd n of many tiles a block, an n below one tile and
     37 tiles (fewer than blocks), aliased and fresh, at the consumer warps
     ring_consumers picks and at RING_WARPS, and the carry kernel over 3
     steps in every layout; the three hat-deposit kernels (x-v histogram,
     |delta f|(v) profile, grid charge) in f32 and f64 against their plain
     versions (f32 against the same terms summed in f64) at the main shape,
     2^21 and nine species of 102,401 markers, with markers on the grids'
     edges, a grid past shared memory, no markers, all dead and all past
     v_max: a second launch and a CUDA graph replay bit for bit the first
  4. the main paths, each with its launch counts set to 0 just before and
     read just after: Simulation.run to t = 100 in f32 and in bf16_weights
     as examples/bump_on_tail_pre83 configures it (launch counts, the
     pic1dp.out size and read-back, the growth rate by the example's fit
     against theory), runinfo and ptcldist on the f32 run's pic1dp.out
     (runinfo's gamma against the fit, ptcldist's files against the stream,
     the viewer's ImportError without matplotlib), each verification case
     through Simulation.run against its dispersion root by the config, root
     and fit of its example script where it has one, each run under
     torch.profiler, whose substep
     kernels by name must equal the counters, and one hat-deposit launch a
     species and snapshot; a second f32 main run, two bf16_weights runs and
     two diag_full_rho runs, each pair writing the same pic1dp.out byte for
     byte; then the kernel, pipeline, compute, overlap and
     pingpong probes at 2^26, each with the stream kernels' counts set to 0
     just before it
  5. the rest of the single-device run surface, each path with the substep
     kernels' counts set to 0 just before it and read just after: the
     full-spectrum rho of diag_full_rho against the kept-mode rho and the
     time of a snapshot with and without it; the EXPLICIT grid path against
     the matrix-free kernels (f32 at full width, f64 at 2^16 markers), a
     second grid-path run bit for bit the first, its grid-charge launches and
     its ms/step; the multirand loader at full width with the native engine
     against a Python-oracle draw, and 20 steps from its state; a checkpoint
     at t = 5 resumed to t = 10 against the uninterrupted run, bit for bit,
     in f32 and bf16_weights; a run with a merge/remove/merge/split schedule
     at 2^21 markers to t = 75 (live counts around each event, gamma over
     the linear window, two kernel launches per step at the event steps too,
     one profile launch an event), a second run bit for bit the first (live
     counts and final state), a checkpoint before the first event resumed
     past two bit for bit the run not interrupted, then at that shape both
     kernels against their plain versions on a
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
     the headline in both layouts, with the step minus its two kernels,
     the idle share of a graph replay and its kernels per step (the step's
     two, and E, rho and their copies once a graph); and run.py --profile,
     whose trace
     holds each substep kernel as often as the counters say
  8. (run after 7, before 6) multi-device runs on the one card: the main
     case in f32 and bf16_weights through Simulation(mesh=1) on a one-rank
     NCCL job, its CUDA graphs holding the all_reduces, bit for bit the run
     without a mesh, with the launch counts set to 0 just before and read
     just after, and gamma against the root; the graph step with and
     without the all_reduces in turns; then two gloo ranks on the one card,
     each in its own process, eager steps within the f32 bounds of the run
     without a mesh, and their ms/step
  6. timing: ms per call of each substep (solving its modes, as the
     Stepper calls it), unit, carry and hat-deposit kernel and its plain
     version, and of a step of the pingpong probe's carry (h on the card)
     and its plain version (for a hat deposit also its index_add_
     alone, the kernels line's library_ms, and its deposit and row-sum
     kernels apart) (for each substep its bound, share, V, B, the bin and
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
# consumer warps the ring is also compared at, beside ring_consumers' pick:
# below every ring's chunk count, with the tile's chunks dealt in whole
# rounds (a step of 0) and not, and 8 (a step of 0 at every ring)
RING_WARPS = (4, 5, 8)
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
CHECKPOINT_EVENT_T = (48.0, 57.0)    # the optimization run's: before merge at 50, past remove at 56
OPT_N, OPT_TIME_MAX = 2**21, 75.0    # bench/opt_onchip.py's width
OPT_GAMMA_WINDOW = (25.0, 48.0)      # before the first event, as bench/opt_onchip.py fits
# merge/remove/split on the card against the CPU in float64: live bits that
# may differ in float64; in float32 the live count's and the sums' bounds
# (a few markers of 2^21 sit within float32 rounding of a threshold, and one
# that remove keeps on one side only carries its weight over its importance)
OPT_F64_FLIPS, OPT_F32_LIVE, OPT_F32_SUM = 2, 5e-4, 1e-3
# the hat-deposit kernels against their plain versions, relative to each
# output's max: two sums of about 6,000 terms a bin in different orders in
# f32; f64 as every f64 bound here
HIST_TOL = {"float32": 1e-5, "float64": 1e-12}
HIST_N_ODD = 102_401                 # no block's range ends at a species' end
HIST_WIDE = (128, 128)               # (nv, nx): a copy a block in f32, the device buffer in f64
HIST_GRID_NX = (1024, 4096, 32768)   # the grid charge; 32768 past shared memory


# ---- the reference's verification cases, at the widths of its examples
# and tests (examples/landau_damping.py:21-22, examples/two_stream.py:30-37,
# PHYSICS_r05.json two_stream_k0.2_fullf, tests/test_physics.py:130-146,
# examples/ion_acoustic.py:47-58) ----

def examples():
    """The port's example scripts (pic1dp_tpu_torch/examples/): their
    configs, dispersion roots and fits are phase 4's."""
    from pic1dp_tpu_torch.examples import (bump_on_tail_pre83, ion_acoustic,
                                           landau_damping, two_stream)

    return bump_on_tail_pre83, landau_damping, two_stream, ion_acoustic


def quiet(cfg):
    return dataclasses.replace(cfg, verbosity=0)


def landau_cfg(linear: bool = False, bf16: bool = False):
    return dataclasses.replace(landau_damping_cfg(), linear=linear, bf16_weights=bf16)


def two_stream_cfg(deltaf: bool = True):
    from pic1dp_tpu_torch.config import two_stream

    if deltaf:   # the example's config, 1e6 markers rounded up to 1,000,448
        return quiet(examples()[2].config(1_000_000, 80.0, "cuda"))
    return two_stream(nparticle=2**24, deltaf=False, time_max=30.0, verbosity=0)


def two_species_cfg(bf16: bool = False):
    from pic1dp_tpu_torch.config import Config, Equilibrium, SpeciesConfig

    sp = dict(charge=-1.0, mass=1.0, temperature=1.0, density=0.5)
    return Config(lx=2.0 * np.pi / 0.2, equilibrium=Equilibrium.MAXWELLIAN,
                  species=(SpeciesConfig(v0=3.0, **sp), SpeciesConfig(v0=-3.0, **sp)),
                  nx=256, nparticle_max=2**20, time_max=26.0, output_interval=0.5,
                  bf16_weights=bf16, verbosity=0).validate()


def ion_acoustic_cfg():
    return quiet(examples()[3].config(2**22, 320.0, "cuda"))


def nine_species_cfg(dtype: str = "float32", n: int = 102_400, ns: int = 9):
    """Landau k = 0.5 (examples/landau_damping.py:21-22) as ns (nine)
    identical electron species of density 1/ns, n markers each: the plasma
    and its dispersion root are the one-species case's."""
    from pic1dp_tpu_torch.config import SpeciesConfig

    sp = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0 / ns, v0=0.0)
    return dataclasses.replace(
        landau_damping_cfg(n), species=(sp,) * ns, dtype=dtype).validate()


def landau_damping_cfg(n: int = 102_400):
    return quiet(examples()[1].config(n))


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
    path's substep kernels (the one-species nonlinear instantiations), of
    the grid bin's and of the bulk-copy ring's (registers, spills, shared
    memory), and for the other kernels their count, most registers and any
    spill."""
    from pic1dp_tpu_torch.ops import hist_kernels as hk
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.ops import substep_kernels as sk
    from pic1dp_tpu_torch.utils import nvcc

    start = time.perf_counter()
    for built in nvcc.load_all([sk.SOURCE, sp.SOURCE, hk.SOURCE]):
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
            elif built.path.name.startswith(hk.SOURCE):
                say(f"[2 build] {entry.split('entry function ')[-1]}: " + "; ".join(lines))
            elif ring_entry(entry):
                say(f"[2 build] {ring_entry(entry)}: " + "; ".join(lines))
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
    hk.library()
    say(f"[2 build] all libraries built in parallel and loaded in "
        f"{time.perf_counter() - start:.1f} s")


def ring_entry(name: str) -> str | None:
    """stream_bulk_kernel<NR, NW, U, K> for a ptxas entry of the bulk-copy
    ring, None for any other."""
    m = re.search(r"stream_bulk_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
    return None if m is None else f"stream_bulk_kernel<{', '.join(m.groups())}>"


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
    compare_kernel_modes(cfg, subs, (x, v, p, w, mre0, mim0, mre1, mim1))
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


def compare_kernel_modes(cfg, subs, inputs) -> None:
    """The modes the substep kernels' last block solves (solve=True)
    against Stepper._solve's products (spectral.solve_modes with the same
    factor subs.g) of the kernels' own projections, bit for bit, on a
    launch of both substeps and on a replay of a CUDA graph of them over the
    same buffers; the projections equal a launch's without the solve."""
    from pic1dp_tpu_torch.core.step import CountedGraph
    from pic1dp_tpu_torch.ops import spectral as spectral_ops

    x, v, p, w, mre0, mim0, mre1, mim1 = inputs
    start = [t.clone() for t in (x, v, w)]
    xs, vs, ws = streams = [t.clone() for t in start]

    def both():
        w1, v1, proj1, modes1 = subs.substep1(xs, vs, p, ws, mre0, mim0, solve=True)
        *_, proj2, modes2 = subs.substep2(xs, vs, p, ws, w1, v1, mre1, mim1, mre0, mim0,
                                          solve=True)
        return proj1, modes1, proj2, modes2

    def same(out) -> bool:
        proj1, modes1, proj2, modes2 = out
        return all(torch.equal(a, b) for got, proj in ((modes1, proj1), (modes2, proj2))
                   for a, b in zip(got, spectral_ops.solve_modes(*proj, subs.g)))

    launch = both()
    unsolved = subs.substep1(*start[:2], p, start[2], mre0, mim0)[2]
    torch.cuda.synchronize()
    ok_launch = same(launch)
    ok_proj = all(torch.equal(a, b) for a, b in zip(launch[0], unsolved))
    for t, t0 in zip(streams, start):
        t.copy_(t0)
    box = []
    graph = CountedGraph(lambda: box.append(both()))
    for t, t0 in zip(streams, start):
        t.copy_(t0)
    graph.replay()
    torch.cuda.synchronize()
    ok_graph = same(box[0]) and all(
        torch.equal(a, b) for pair in zip(box[0], launch) for a, b in zip(*pair))
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    say(f"[3 compare] {label} {subs.layout} n={cfg.nspecies}x{x.shape[-1]} nmode={cfg.nmode}"
        f"{' grid bin' if subs.uses_grid_bin() else ''}: kernel-solved modes of both "
        f"substeps = _solve of their projections bit for bit on a launch {ok_launch}, on a "
        f"graph replay {ok_graph} (= the launch); projections = an unsolved launch's "
        f"{ok_proj}")
    check(ok_launch and ok_graph and ok_proj,
          "the kernels' modes are _solve of their projections, bit for bit")


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


def ring_edges():
    """(ring label, keyword arguments, n, what n is, alias) of the overlap
    probe's three rings (4 KB x 4, 8 KB x 4, 16 KB x 3) at the sizes where
    the ring's schedule has edges, with aliased and fresh outputs: an odd n
    of many tiles a block and a tail, an n below one tile (no block has a
    tile), and 37 tiles and a tail (fewer tiles than blocks)."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.probes import overlap_probe

    for label, kernel, kw in overlap_probe.CASES:
        if kernel is not sp.stream_bulk_units:
            continue
        tile = kw["tile_bytes"] // 4
        for n, what in ((2**22 + 13, "odd n with a tail"), (tile - 3, "n below one tile"),
                        (37 * tile + 5, "37 tiles and a tail")):
            for alias in (sp.ALIAS, {}):
                yield label, kw, n, what, alias


def _compare_stream(kernel, kw: dict, nr: int, nw: int, alias: dict, n: int, seed: int):
    """One stream kernel call against stream_plain on fresh copies of the
    same inputs: (outputs and inputs bitwise equal, max abs err, sum rel
    err)."""
    from pic1dp_tpu_torch.ops.stream_probes import stream_plain
    from pic1dp_tpu_torch.probes import fresh_streams

    base = fresh_streams(nr, n, torch.device("cuda"), seed=seed)
    a, b = [t.clone() for t in base], [t.clone() for t in base]
    outs_k, sum_k = kernel(a, nw, alias, **kw)
    outs_p, sum_p = stream_plain(b, nw, alias)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(outs_k + a, outs_p + b))
    err = max(abs_err(x, y) for x, y in zip(outs_k, outs_p))
    return same, err, abs(float(sum_k) - float(sum_p)) / abs(float(sum_p))


def compare_streams(n: int) -> dict:
    """Each stream kernel against stream_plain on fresh copies of the same
    inputs (an odd n, so the masked tails run), then the ring on 4r+3w at
    each of ring_edges(): outputs and inputs bitwise equal after the call,
    the element sum within STREAM_SUM_TOL."""
    from pic1dp_tpu_torch.ops.stream_probes import bulk_ring, stream_bulk

    worst = {"stream_rw": 0.0, "stream_bulk": 0.0}
    for k, (name, kernel, kw, nr, nw, alias, label) in enumerate(stream_cases()):
        same, err, rel = _compare_stream(kernel, kw, nr, nw, alias, n, seed=k)
        say(f"[3 compare] {name} {kw or ''} {label} n={n}: outputs and inputs bitwise "
            f"equal {same}; sum rel err {rel:.3e} (limit {STREAM_SUM_TOL:g})")
        check(same, f"{name} {label} {kw} bitwise equal to stream_plain")
        check(rel <= STREAM_SUM_TOL, f"{name} {label} sum within {STREAM_SUM_TOL}")
        worst[name] = max(worst[name], err)
    for k, (label, kw, m, what, alias) in enumerate(ring_edges()):
        same, err, rel = _compare_stream(stream_bulk, kw, 4, 3, alias, m, seed=600 + k)
        tag = (f"stream_bulk {label} 4r+3w {'aliased' if alias else 'fresh'} n={m} ({what}; "
               f"{bulk_ring(4, 3, **kw).consumers} consumer warps)")
        say(f"[3 compare] {tag}: outputs and inputs bitwise equal {same}; sum rel err "
            f"{rel:.3e} (limit {STREAM_SUM_TOL:g})")
        check(same, f"{tag} bitwise equal to stream_plain")
        check(rel <= STREAM_SUM_TOL, f"{tag} sum within {STREAM_SUM_TOL}")
        worst["stream_bulk"] = max(worst["stream_bulk"], err)
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


def _compare_unit(kernel, unit: str, k: int, n: int, seed: int, alias: dict,
                  kw: dict) -> dict:
    """One unit kernel against stream_units_plain on fresh copies of the
    same inputs, checked: at eps = 1 with acc = 0 the units' sum within
    units_tolerance; at eps = 1e-12 every output within one float32 ulp of
    the plain value (the kernel may contract to FMA) and bitwise at K = 0,
    the element sum within STREAM_SUM_TOL.  Returns the measures."""
    from pic1dp_tpu_torch.ops import stream_probes as sp

    name = f"{kernel.__name__} {unit} x{k} {kw or ''} n={n}"
    base = _unit_streams(n, seed, cancel=True)
    a, b = [t.clone() for t in base], [t.clone() for t in base]
    (ek, *_), _ = kernel(a, alias, unit, k, eps=1.0, **kw)
    (ep, *_), _ = sp.stream_units_plain(b, alias, unit, k, eps=1.0)
    err = (ek.double() - ep.double()).abs()
    tol = sp.units_tolerance(unit, k, ep).double()
    over = float((err / tol.clamp_min(1e-30)).max())
    torch.cuda.synchronize()
    base = _unit_streams(n, seed, cancel=False)
    a, b = [t.clone() for t in base], [t.clone() for t in base]
    outs_k, sum_k = kernel(a, alias, unit, k, **kw)
    outs_p, sum_p = sp.stream_units_plain(b, alias, unit, k)
    torch.cuda.synchronize()
    ulp = max(_ulps(x, y) for x, y in zip(outs_k, outs_p))
    same = all(torch.equal(x, y) for x, y in zip(outs_k + a, outs_p + b))
    rel = abs(float(sum_k) - float(sum_p)) / abs(float(sum_p))
    check(over <= 1.0, f"{name} units' sum within units_tolerance")
    check(ulp <= 1.0 and (same or k > 0), f"{name} outputs within one ulp, bitwise at K = 0")
    check(rel <= STREAM_SUM_TOL, f"{name} sum within {STREAM_SUM_TOL}")
    return dict(err=float(err.max()), over=over, bound=float(tol.max()), ulp=ulp, same=same,
                rel=rel, worst=max(float(err.max()),
                                   max(abs_err(x, y) for x, y in zip(outs_k, outs_p))))


def compare_units(n: int) -> dict:
    """Both unit kernels against stream_units_plain (_compare_unit) for
    every unit and K in UNIT_KS at n (odd, so the masked tails run),
    aliased; then the ring at each of ring_edges(), one line for each, and
    there at each of RING_WARPS consumer warps at K = 0 and trig x4."""
    from pic1dp_tpu_torch.ops import stream_probes as sp

    worst = {"stream_units": 0.0, "stream_bulk_units": 0.0}
    case = 0
    for kernel in (sp.stream_units, sp.stream_bulk_units):
        name = kernel.__name__
        for unit in sp.UNITS:
            for k in UNIT_KS:
                case += 1
                r = _compare_unit(kernel, unit, k, n, case, sp.ALIAS, {})
                say(f"[3 compare] {name} {unit} x{k} n={n}: eps=1 units' sum max abs err "
                    f"{r['err']:.3e} ({r['over']:.2f} of its bound, max bound "
                    f"{r['bound']:.3e}); eps=1e-12 outputs within {r['ulp']:g} f32 ulp, "
                    f"bitwise {r['same']}; sum rel err {r['rel']:.3e} "
                    f"(limit {STREAM_SUM_TOL:g})")
                worst[name] = max(worst[name], r["worst"])
    for label, kw, m, what, alias in ring_edges():
        rs = []
        for unit in sp.UNITS:
            for k in UNIT_KS:
                case += 1
                rs.append((k, _compare_unit(sp.stream_bulk_units, unit, k, m, case, alias, kw)))
        say(f"[3 compare] stream_bulk_units {label} {'aliased' if alias else 'fresh'} n={m} "
            f"({what}), every unit and K in {UNIT_KS}: units' sum at most "
            f"{max(r['over'] for _, r in rs):.2f} of its bound; outputs within "
            f"{max(r['ulp'] for _, r in rs):g} f32 ulp, bitwise at K = 0 "
            f"{all(r['same'] for k, r in rs if k == 0)}; sum rel err at most "
            f"{max(r['rel'] for _, r in rs):.3e} (limit {STREAM_SUM_TOL:g})")
        worst["stream_bulk_units"] = max(worst["stream_bulk_units"],
                                         max(r["worst"] for _, r in rs))
    # K = 0 is the instantiation stream_bulk launches on 4r+3w
    for label, kw, m, what, alias in ring_edges():
        chunks = -(-kw["tile_bytes"] // 16 // 32)
        for w in RING_WARPS:
            rs = []
            for k in (0, 4):
                case += 1
                rs.append((k, _compare_unit(sp.stream_bulk_units, "trig", k, m, case, alias,
                                            dict(kw, consumer_warps=w))))
            say(f"[3 compare] stream_bulk_units {label} {'aliased' if alias else 'fresh'} "
                f"n={m} ({what}) at {w} consumer warps ({chunks} chunks a tile, step "
                f"{chunks % w}), trig x0 and x4: units' sum at most "
                f"{max(r['over'] for _, r in rs):.2f} of its bound; outputs within "
                f"{max(r['ulp'] for _, r in rs):g} f32 ulp, bitwise at K = 0 "
                f"{rs[0][1]['same']}; sum rel err at most "
                f"{max(r['rel'] for _, r in rs):.3e} (limit {STREAM_SUM_TOL:g})")
            worst["stream_bulk_units"] = max(worst["stream_bulk_units"],
                                             max(r["worst"] for _, r in rs))
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


# ---- the deterministic hat deposits (ops/hist_kernels.py) ----

def hist_markers(n: int, ns: int, dtype: str, lx: float, v_max: float, seed: int,
                 edges: bool = True, dead_every: int = 7):
    """(x, v, p, w, live), each (ns, n) on the card: x in [0, lx), v in
    [-1.1 v_max, 1.1 v_max] (some past the v grid), p a Maxwellian's loader
    weight, w ~ 1e-3 N(0, 1), every dead_every-th marker dead with p = w = 0
    (the dead-slot invariant).  With edges each species' first six markers
    sit at v = -v_max, v_max and one ulp inside each, x = 0 and x one ulp
    below lx."""
    rng = np.random.default_rng(seed)
    ft = np.float32 if dtype == "float32" else np.float64
    x = rng.uniform(0.0, lx, (ns, n)).astype(ft)
    x[x >= ft(lx)] = 0.0
    v = rng.uniform(-1.1 * v_max, 1.1 * v_max, (ns, n)).astype(ft)
    if edges and n >= 6:
        vm, lxt = ft(v_max), ft(lx)
        v[:, :4] = [-vm, vm, np.nextafter(-vm, ft(0)), np.nextafter(vm, ft(0))]
        x[:, 4], x[:, 5] = 0.0, np.nextafter(lxt, ft(0))
    p = (np.exp(-0.5 * v.astype(np.float64) ** 2) * lx * 2.0 * v_max / n).astype(ft)
    w = (1e-3 * rng.standard_normal((ns, n))).astype(ft)
    live = np.ones((ns, n), dtype=bool)
    live[:, ::dead_every] = False
    p[~live], w[~live] = 0.0, 0.0
    return tuple(torch.from_numpy(a).to("cuda") for a in (x, v, p, w, live))


def hist_vals(x, p, w, live):
    """ptcldist's three channels of one species: live, p and w of the live."""
    return torch.stack([live.to(x.dtype), torch.where(live, p, 0.0), torch.where(live, w, 0.0)])


def summed_f64(terms, shape, args) -> torch.Tensor:
    """A plain version's sum in float64: its terms (bins and values, at the
    inputs' dtype, as the kernel forms them) added by one float64
    index_add_, reshaped as the plain output (a (bins, k) sum is
    transposed first)."""
    bins, vals = terms(*args)
    out = torch.zeros((int(np.prod(shape[1:])), shape[0]) if vals.dim() == 2
                      else int(np.prod(shape)), dtype=torch.float64, device=vals.device)
    out.index_add_(0, bins, vals.double())
    return (out.T if vals.dim() == 2 else out).reshape(shape)


def hist_case(label: str, fn, plain, terms, args, per_channel: bool = False,
              graph: bool = False) -> float:
    """A hat-deposit kernel fn(*args) against its plain version on the same
    inputs, within HIST_TOL of each output's max (each channel's with
    per_channel; exactly 0 where the plain output is).  The plain version's
    own terms (terms(*args), formed at the inputs' dtype as the kernel forms
    them) are summed in float64 (summed_f64): its float32 index_add_, of up
    to 10^5 terms a bin in an order the float atomics pick, is no yardstick
    at 1e-5 (its distance is printed beside).  A second launch, and with
    graph a replay of a launch captured in a CUDA graph, bit for bit the
    first.  Returns the largest absolute error."""
    got = fn(*args)
    want = summed_f64(terms, tuple(got.shape), args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == args[0].dtype,
          f"{label} shape and dtype")
    tol = HIST_TOL[str(got.dtype).split(".")[-1]]

    def rel(a):
        out = []
        for g, w in (zip(a, want) if per_channel else [(a, want)]):
            scale = float(w.abs().max()) if w.numel() else 0.0
            out.append(abs_err(g, w) / scale if scale > 0 else
                       (0.0 if not g.numel() or not bool(g.any()) else float("inf")))
        return max(out)

    err = rel(got)
    own = "" if got.dtype == torch.float64 else \
        f"; the f32 plain version {rel(plain(*args)):.3e}"
    again = fn(*args)
    same = torch.equal(again, got)
    replay = None
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = fn(*args)
        g.replay()
        torch.cuda.synchronize()
        replay = torch.equal(captured, got)
    say(f"[3 compare] {label}: {err:.3e} of max from the plain version summed in f64 (limit "
        f"{tol:g}){own}; a second launch bitwise equal {same}"
        + ("" if replay is None else f"; a CUDA graph replay bitwise equal {replay}"))
    check(err <= tol, f"{label} within {tol:g} of max of its plain version")
    check(same and replay is not False, f"{label} repeats bit for bit")
    return abs_err(got, want) if got.numel() else 0.0


def compare_pass(label: str, x, v, live, p, w, lx: float, v_max: float, nx: int,
                 nv: int) -> None:
    """hist_kernels.xv_pass, the snapshot's marker pass over one species (x,
    v, live, p, w of shape (n,)): its histograms bit for bit those of
    hist_xv on the plain chain's three channels (xv_channels), its moments
    within HIST_TOL of their terms' size (sum of |v^2 value|) from the
    plain version's terms summed in float64 (torch's own sum beside), and a
    second launch and a CUDA graph replay bit for bit the first."""
    from pic1dp_tpu_torch.ops import hist_kernels as hk

    args = (x, v, live, p, w, lx, v_max, nx, nv)
    hist, moments = hk.xv_pass(*args)
    vals = hk.xv_channels(live, p, w, x.dtype)
    want_hist = hk.hist_xv(x, v, vals, lx, v_max, nx, nv)
    terms = torch.where(live, v * v, 0.0) * vals
    want = terms.double().sum(dim=1)
    scale = terms.double().abs().sum(dim=1).clamp_min(1e-300)
    err = float(((moments.double() - want).abs() / scale).max())
    torch_err = float(((terms.sum(dim=1).double() - want).abs() / scale).max())
    again = hk.xv_pass(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hk.xv_pass(*args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = hk.xv_pass(*args)
    g.replay()
    torch.cuda.synchronize()
    tol = HIST_TOL[str(x.dtype).split(".")[-1]]
    same_hist = torch.equal(hist, want_hist)
    repeat = all(torch.equal(a, b) for a, b in zip((*again, *captured), (hist, moments) * 2))
    say(f"[3 compare] xv_pass {label}: histograms bitwise those of hist_xv on the three "
        f"channels {same_hist}; moments {err:.3e} of their terms' size from the f64 sum "
        f"(limit {tol:g}; torch's own sum {torch_err:.3e}); a second launch and a CUDA graph "
        f"replay bitwise equal {repeat}")
    check(same_hist, f"xv_pass {label}: histograms = hist_xv's bit for bit")
    check(err <= tol, f"xv_pass {label}: moments within {tol:g} of their terms' size")
    check(repeat, f"xv_pass {label} repeats bit for bit")


def compare_hists() -> dict:
    """The three hat-deposit kernels against their plain versions (hist_case)
    in f32 and f64: at the main shape (6.4M markers of one species, the 64 x
    64 snapshot grid, the main case's nx and nv) and the optimization run's
    2^21; nine species of HIST_N_ODD markers (no block's range ends at the
    species' end), each species' first markers at the edges of the grids;
    the x-v histogram with 1, 2 and 3 channels on a grid with one grid copy
    a block in f32 and past shared memory in f64 (HIST_WIDE); the grid
    charge at nx 1024, 4096 and 32768 (past shared
    memory); no markers, markers all past v_max and all dead.  The marker
    pass (compare_pass) at the main shape, p in bfloat16 too, on each of the
    nine species, on the wide grid and with every marker past v_max.
    Returns each kernel's largest absolute error at the main shape in f32."""
    from pic1dp_tpu_torch.config import bump_on_tail_default
    from pic1dp_tpu_torch.ops import hist_kernels as hk

    cfg = bump_on_tail_default()
    lx, vm, nxo, nvo, nv = cfg.lx, cfg.v_max, cfg.nx_opd, cfg.nv_opd, cfg.nv

    def xv(nx, nv_):
        return (lambda x, v, vals: hk.hist_xv(x, v, vals.contiguous(), lx, vm, nx, nv_),
                lambda x, v, vals: hk.hist_xv_plain(x, v, vals, lx, vm, nx, nv_),
                lambda x, v, vals: hk.hist_xv_terms(x, v, vals, lx, vm, nx, nv_))

    prof = (lambda v, w, live: hk.profile(v, w, live, vm, nv),
            lambda v, w, live: hk.profile_plain(v, w, live, vm, nv),
            lambda v, w, live: hk.profile_terms(v, w, live, vm, nv))

    def charge(nx):
        return (lambda x, val: hk.grid_charge(x, val, lx, nx),
                lambda x, val: hk.grid_charge_plain(x, val, lx, nx),
                lambda x, val: hk.grid_charge_terms(x, val, lx, nx))

    err = {k.name: 0.0 for k in hk.KERNELS}
    for dtype in ("float32", "float64"):
        x, v, p, w, live = hist_markers(FULL_N, 1, dtype, lx, vm, SEED)
        vals = hist_vals(x[0], p[0], w[0], live[0])
        val = torch.where(live, w, 0.0) * -1.0
        main = {
            "hist_xv": hist_case(f"hist_xv {dtype} n={FULL_N} {nvo}x{nxo} k=3",
                                 *xv(nxo, nvo), (x[0], v[0], vals), True, True),
            "hist_v": hist_case(f"hist_v {dtype} n={FULL_N} nv={nv}", *prof, (v, w, live),
                                graph=True),
            "grid_charge": hist_case(f"grid_charge {dtype} n={FULL_N} nx={cfg.nx}",
                                     *charge(cfg.nx), (x, val), graph=True)}
        if dtype == "float32":
            err.update(main)
        compare_pass(f"{dtype} n={FULL_N} {nvo}x{nxo}", x[0], v[0], live[0], p[0], w[0], lx, vm,
                     nxo, nvo)
        if dtype == "float32":
            compare_pass(f"{dtype}, p bfloat16, n={FULL_N} {nvo}x{nxo}", x[0], v[0], live[0],
                         p[0].to(torch.bfloat16), w[0], lx, vm, nxo, nvo)
        del x, v, p, w, live, vals, val
        x, v, p, w, live = hist_markers(OPT_N, 1, dtype, lx, vm, SEED + 1)
        hist_case(f"hist_v {dtype} n={OPT_N} nv={nv}", *prof, (v, w, live))
        x, v, p, w, live = hist_markers(HIST_N_ODD, 9, dtype, lx, vm, SEED + 2)
        for s in range(9):
            hist_case(f"hist_xv {dtype} species {s} of 9 n={HIST_N_ODD} {nvo}x{nxo} k=3",
                      *xv(nxo, nvo), (x[s], v[s], hist_vals(x[s], p[s], w[s], live[s])), True)
            compare_pass(f"{dtype} species {s} of 9 n={HIST_N_ODD}", x[s], v[s], live[s], p[s],
                         w[s], lx, vm, nxo, nvo)
        val = torch.where(live, w, 0.0) * -1.0
        hist_case(f"hist_v {dtype} 9 x {HIST_N_ODD}", *prof, (v, w, live), graph=True)
        for nx in (cfg.nx, *HIST_GRID_NX):
            hist_case(f"grid_charge {dtype} 9 x {HIST_N_ODD} nx={nx}", *charge(nx), (x, val),
                      graph=nx == HIST_GRID_NX[-1])
        wv, wx = HIST_WIDE
        vals = hist_vals(x[0], p[0], w[0], live[0])
        for k in (1, 2, 3):
            where = "the device buffer" if hk.plan(
                x.element_size(), hk.XV, wv * wx).form == hk.BUFFER else "shared memory"
            hist_case(f"hist_xv {dtype} n={HIST_N_ODD} {wv}x{wx} k={k} (grids in {where})",
                      *xv(wx, wv), (x[0], v[0], vals[:k]), True, graph=k == 3)
        compare_pass(f"{dtype} n={HIST_N_ODD} {wv}x{wx} (grids in {where})", x[0], v[0],
                     live[0], p[0], w[0], lx, vm, wx, wv)
        fast = torch.full_like(v, 2.0 * vm)
        compare_pass(f"{dtype}, every marker past v_max", x[0], fast[0], live[0], p[0], w[0], lx,
                     vm, nxo, nvo)
        dead = torch.zeros_like(live)
        empty = x[:, :0].contiguous()
        for label, fn, plain, _, args in (
                ("hist_xv, every marker past v_max", *xv(nxo, nvo), (x[0], fast[0], vals)),
                ("hist_xv, no markers", *xv(nxo, nvo), (empty[0], empty[0], vals[:, :0])),
                ("hist_v, every marker dead", *prof, (v, w, dead)),
                ("hist_v, no markers", *prof, (empty, empty, dead[:, :0].contiguous())),
                ("grid_charge, no markers", *charge(cfg.nx), (empty, empty))):
            got = fn(*args)
            torch.cuda.synchronize()
            check(not bool(got.any()) and torch.equal(got, plain(*args)),
                  f"{label} {dtype}: all zeros, as the plain version's")
            say(f"[3 compare] {label} {dtype}: all zeros, as the plain version's")
        del x, v, p, w, live, vals, val, fast, dead, empty
    torch.cuda.empty_cache()
    return err


def run_case(phase: str, label: str, cfg, out_dir: str | None = None) -> tuple[list, dict]:
    """Simulation.run of cfg on the card, through the CUDA graph, with every
    substep kernel's count set to 0 just before and read just after: only
    the config's own two kernels, once per step, in the counters and in a
    torch.profiler trace of the whole run, which sees each kernel the card
    ran by name (graph replays included; the run is made again, up to
    PROFILER_TRIES times, while the profiler sees fewer); the step and
    snapshot counts; pic1dp.out of the expected size, its last snapshot read
    back; a finite final state of the configured shape and dtypes with x in
    [0, lx).  pic1dp.out goes to out_dir where given (kept), else to a
    temporary directory.  Returns the snapshots and the counts."""
    from pic1dp_tpu_torch import Simulation
    from pic1dp_tpu_torch.io import petsc_binary as pb
    from pic1dp_tpu_torch.ops import hist_kernels as hk
    from pic1dp_tpu_torch.ops import substep_kernels as sk

    nm, ns, nxo, nvo = cfg.nmode, cfg.nspecies, cfg.nx_opd, cfg.nv_opd
    header = 4 * (6 + nm) + 8 * 2
    snap = (8 * (2 + 3 * ns) + 2 * (8 + 8 * nm) + 2 * (8 + 8 * cfg.nx)
            + ns * 8 * 3 * (nxo * nvo + nvo))
    for attempt in range(1, PROFILER_TRIES + 1):
        snaps = []
        with (contextlib.nullcontext(out_dir) if out_dir else tempfile.TemporaryDirectory()) \
                as out:
            sim = Simulation(cfg, out_path=out, device="cuda")
            for k in sk.KERNELS + hk.KERNELS:
                k.launches = 0
            start = time.perf_counter()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                sim.run(snapshot_callback=snaps.append)
                torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = {k.name: k.launches for k in sk.KERNELS}
            hists = {k.name: k.launches for k in hk.KERNELS}
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
    want = {"hist_xv": ns * len(snaps), "hist_v": 0,
            "grid_charge": len(snaps) if cfg.diag_full_rho else 0}
    say(f"[{phase}] {label}: hat-deposit launches {hists} (one hist_xv a species and "
        f"snapshot)")
    check(hists == want, f"{label}: hat-deposit launches {want}")
    passes = sim.timers.counter("snapshot marker passes")
    check(passes == ns * len(snaps), f"{label}: one marker pass a species and snapshot "
                                     f"({passes})")
    launches.update(hists)
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


def main_path(cfg, phase: str = "4 main path", out_dir: str | None = None
              ) -> tuple[dict, float]:
    """The default case to time_max (run_case); returns the counts and
    gamma, fitted as the example fits it (examples/bump_on_tail_pre83:
    over [25, 70] at time_max 100), against the dispersion root."""
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    snaps, launches = run_case(phase, label, cfg, out_dir)
    bump = examples()[0]
    gamma = bump.fit_gamma(snaps, cfg.time_max)
    rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
    e = np.array([q["field_energy"] for q in snaps])
    say(f"[{phase}] {label} gamma {gamma:.5f} vs theory {BOT_OMEGA.imag:.5f}: "
        f"rel err {rel:.4f} (limit {GAMMA_REL_TOL}); int E^2 dx at t=100: {e[-1]:.4e}")
    check(rel <= GAMMA_REL_TOL, "growth rate within 5% of the dispersion root")
    return launches, gamma


def repeat_phase(cfg, first_out: str) -> dict:
    """Each main path run a second time, pic1dp.out byte for byte the
    first's: the f32 main case against phase 4's run (first_out), two runs
    with bf16_weights and two with diag_full_rho (its full-spectrum rho made
    by the grid-charge kernel), each run with the counts set to 0 just before
    and read just after.  Returns the hat-deposit launches of a
    diag_full_rho run."""
    import filecmp

    from pic1dp_tpu_torch import Simulation

    def run(c, out):
        zero_substep_counts()
        zero_hist_counts()
        start = time.perf_counter()
        Simulation(c, out_path=out, device="cuda").run()
        torch.cuda.synchronize()
        return time.perf_counter() - start, hist_counts(), substep_counts()

    with tempfile.TemporaryDirectory() as tmp:
        for label, c, first in (
                ("f32", cfg, os.path.join(first_out, "pic1dp.out")),
                ("bf16_weights", dataclasses.replace(cfg, bf16_weights=True), None),
                ("diag_full_rho", dataclasses.replace(cfg, diag_full_rho=True), None)):
            if first is None:
                run(c, os.path.join(tmp, label, "a"))
                first = os.path.join(tmp, label, "a", "pic1dp.out")
            wall, hists, subs = run(c, os.path.join(tmp, label, "b"))
            again = os.path.join(tmp, label, "b", "pic1dp.out")
            same = filecmp.cmp(first, again, shallow=False)
            say(f"[4 repeat] {label} to t={c.time_max:g}: a second run's pic1dp.out "
                f"({os.path.getsize(again)} bytes) byte for byte the first's: {same}; "
                f"wall {wall:.2f} s; launches {subs}, hat deposits {hists}")
            check(same, f"{label}: two runs write the same pic1dp.out, byte for byte")
    return hists


def _energy_gamma(t, e, lo: float, hi: float) -> float:
    """Half the slope of ln int E^2 dx over [lo, hi] (tests/test_physics.py)."""
    m = (t >= lo) & (t <= hi)
    return float(np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0)


def physics_path() -> dict:
    """Each verification case against its dispersion root, through the
    port's example scripts (pic1dp_tpu_torch/examples/): their configs (the
    full-f two-stream and two-species cases excepted: no example has them),
    their dispersion roots and their fits, held to phase 4's tolerances;
    returns the launches of each kernel on the path of its own case."""
    _, landau, two_stream, ion_acoustic = examples()

    def row(label, value, want, limit):
        rel = abs(value - want) / abs(want)
        say(f"[4 physics] {label}: {value:.5f} against {want:.5f}, rel err {rel:.4f} "
            f"(limit {limit})")
        check(rel <= limit, f"{label} within {limit}")

    launches = {}

    def add(counts):
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v

    landau_root = landau.theory(landau_cfg())
    snaps, counts = run_case("4 physics", "Landau, nonlinear delta-f", landau_cfg())
    add(counts)
    g_nl = landau.fit_gamma(snaps)
    row("Landau nonlinear gamma (energy peaks, t in [1, 15]) vs root", g_nl,
        landau_root.imag, 0.05)
    for bf16 in (False, True):
        name = "Landau, linear" + (", bf16_weights" if bf16 else "")
        snaps, counts = run_case("4 physics", name, landau_cfg(linear=True, bf16=bf16))
        add(counts)
        g_li = landau.fit_gamma(snaps)
        row(f"{name} gamma vs the nonlinear run's", g_li, g_nl, 0.02)
        row(f"{name} gamma vs root", g_li, landau_root.imag, 0.06)

    cfg = two_stream_cfg()
    ts_root = two_stream.theory(cfg)
    snaps, counts = run_case("4 physics", "two-stream, TWO_STREAM2", cfg)
    add(counts)
    row("two-stream gamma (t in [15, 35]) vs root", two_stream.fit_gamma(snaps),
        ts_root.imag, 0.08)
    t_pk, _, drift = two_stream.saturation(snaps)
    say(f"[4 physics] two-stream saturation peak at t = {t_pk:.1f} (limit "
        f"{cfg.time_max - 2.0}); total-energy drift {drift:.3e} of KE (limit "
        f"{two_stream.DRIFT_LIMIT})")
    check(t_pk < cfg.time_max - 2.0 and drift < two_stream.DRIFT_LIMIT,
          "two-stream saturation and energy")

    cfg = two_stream_cfg(deltaf=False)
    snaps, counts = run_case("4 physics", "two-stream, full-f", cfg)
    add(counts)
    row("two-stream full-f gamma (t in [10, 25]) vs root",
        two_stream.fit_gamma(snaps, (10.0, 25.0)), ts_root.imag, 0.05)

    for bf16 in (False, True):
        name = "two species" + (", bf16_weights" if bf16 else "")
        cfg = two_species_cfg(bf16)
        snaps, counts = run_case("4 physics", name, cfg)
        add(counts)
        row(f"{name} gamma (t in [10, 25]) vs 0.28451",
            two_stream.fit_gamma(snaps, (10.0, 25.0)), 0.28451, 0.09)

    cfg = ion_acoustic_cfg()
    ia_root = ion_acoustic.theory(cfg)
    snaps, counts = run_case("4 physics", "ion-acoustic", cfg)
    add(counts)
    fit = ion_acoustic.fit_omega(snaps, cfg.time_max)
    row("ion-acoustic omega (fit_mode_omega over (60, 300)) vs root", fit.real,
        abs(ia_root.real), ion_acoustic.OMEGA_TOLERANCE)
    row("ion-acoustic gamma vs root", fit.imag, ia_root.imag, ion_acoustic.GAMMA_TOLERANCE)
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


def zero_hist_counts() -> None:
    from pic1dp_tpu_torch.ops import hist_kernels as hk

    for k in hk.KERNELS:
        k.launches = 0


def hist_counts() -> dict:
    from pic1dp_tpu_torch.ops import hist_kernels as hk

    return {k.name: k.launches for k in hk.KERNELS}


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
            sim.output_snapshot()                       # warm-up: eager,
            sim.output_snapshot()                       # then the graph's capture
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
    EXPLICIT_F64_N markers within 1e-12; the grid path's grid-charge
    launches (counts set to 0 just before) and a second grid-path run bit
    for bit the first; ms/step of the grid path."""
    from pic1dp_tpu_torch.config import ParticleShape
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper

    small = dataclasses.replace(cfg, dtype="float64", nparticle_max=EXPLICIT_F64_N)
    for c in (cfg, small):
        zero_substep_counts()
        zero_hist_counts()
        kern = Stepper(c, "cuda")
        grid = Stepper(dataclasses.replace(c, shape=ParticleShape.EXPLICIT), "cuda")
        raw = load_particles(c, "cuda")
        a, b = kern.initial_field(raw.clone()), grid.initial_field(raw.clone())
        a, b = kern.multi_step(a, 5), grid.multi_step(b, 5)
        torch.cuda.synchronize()
        hists = hist_counts()
        check(substep_counts() == {k.name: 5 for k in kern.substeps.counters},
              "5 kernel steps beside 5 grid steps, which launch no substep kernel")
        check(hists == {"hist_xv": 0, "hist_v": 0, "grid_charge": 11},
              "the grid path: one grid-charge launch for the initial field, two a step")
        b2 = grid.multi_step(grid.initial_field(raw.clone()), 5)
        torch.cuda.synchronize()
        same = {f: torch.equal(getattr(b, f), getattr(b2, f))
                for f in ("x", "v", "w", "rho", "electric", "mode_re", "mode_im")}
        say(f"[5 explicit] {c.dtype} n={c.nparticle_max}: grid-charge launches {hists}; a "
            f"second EXPLICIT run of 5 steps from the same state bitwise equal {same}")
        check(all(same.values()), "two EXPLICIT runs give the same bits")
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
            f"steps, grid-charge kernel deposit)")
        del a, b, b2, box, raw


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
    that optimizes; returns the simulation, the events, the snapshots, the
    substep launch counts, the wall time and the hat-deposit launches."""
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
    zero_hist_counts()
    start = time.perf_counter()
    sim.run(snapshot_callback=snaps.append)
    torch.cuda.synchronize()
    return sim, events, snaps, substep_counts(), time.perf_counter() - start, hist_counts()


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
    sim, events, snaps, counts, wall, hists = optimization_run(cfg)
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
    say(f"[5 optimization] hat-deposit launches {hists} (one profile an event, one "
        f"hist_xv a snapshot)")
    check(hists == {"hist_xv": len(snaps), "hist_v": len(events), "grid_charge": 0},
          "one profile launch an event")
    again, events2, _, _, _, _ = optimization_run(cfg)
    same_counts = [ev["n_after"] for ev in events2] == [ev["n_after"] for ev in events]
    same_state = {f: torch.equal(getattr(again.state, f), getattr(st, f))
                  for f in ("x", "v", "p", "w", "live")}
    say(f"[5 optimization] a second run: live counts after the events "
        f"{[ev['n_after'] for ev in events2]}, equal to the first run's {same_counts}; final "
        f"state bitwise equal {same_state}")
    check(same_counts and all(same_state.values()),
          "the optimization run repeats bit for bit: live counts and final state")
    del again
    checkpoint_event_phase(cfg)
    inputs = _loaded_inputs(cfg)
    worst = compare_substeps(cfg, OPT_N, F32_TOL, inputs)
    for name, err in compare_substeps(cfg, OPT_N, F32_TOL,
                                      (st.x, st.v, st.p, st.w, *inputs[4:])).items():
        worst[name] = max(worst[name], err)
    compare_push_pair(cfg, st)
    compare_optimizations(cfg, st)
    return worst, hists


def checkpoint_event_phase(cfg) -> None:
    """The optimization schedule checkpointed at CHECKPOINT_EVENT_T[0],
    before its first event, and resumed to CHECKPOINT_EVENT_T[1], past a
    merge and a remove (whose dice come from the saved generator): live
    count and state bit for bit those of the run that was not interrupted."""
    from pic1dp_tpu_torch import Simulation

    t_save, t_end = CHECKPOINT_EVENT_T
    check(t_save < cfg.optimization.tmerge[0] and cfg.optimization.tremove[0] < t_end,
          "the checkpoint lies before the first event and the resume runs past two")
    whole = Simulation(dataclasses.replace(cfg, time_max=t_end), device="cuda")
    whole.run()
    first = Simulation(dataclasses.replace(cfg, time_max=t_save), device="cuda")
    first.run()
    with tempfile.TemporaryDirectory() as out:
        path = first.save_checkpoint(os.path.join(out, "checkpoint.npz"))
        rest = Simulation(dataclasses.replace(cfg, time_max=t_end), device="cuda")
        rest.restore_checkpoint(path)
    rest.run()
    torch.cuda.synchronize()
    same = {f: torch.equal(getattr(rest.state, f), getattr(whole.state, f))
            for f in ("x", "v", "p", "w", "live", "electric", "mode_re", "mode_im")}
    live = (int(whole.state.live.sum()), int(rest.state.live.sum()))
    say(f"[5 optimization] checkpoint at t={first.time:.2f}, resumed to t={rest.time:.2f} "
        f"across the merge at {cfg.optimization.tmerge[0]:g} and the remove at "
        f"{cfg.optimization.tremove[0]:g}: live {live[1]} (uninterrupted {live[0]}), state "
        f"bitwise equal {same}")
    check(rest.itime == whole.itime and all(same.values()),
          "resume across an event = uninterrupted run bit for bit")


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
    each solving the modes of its projections as a Stepper's steps do,
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
    w1, v1 = subs.substep1(x, v, p, w, mre0, mim0, solve=True)[:2]
    k1, k2 = (k.name for k in subs.counters)
    out = {}
    for name, fn in ((k1, lambda: subs.substep1(x, v, p, w, mre0, mim0, solve=True)),
                     (f"{k1}_plain", lambda: subs.substep1_plain(x, v, p, w, mre0, mim0,
                                                                 solve=True)),
                     (k2, lambda: subs.substep2(x, v, p, w, w1, v1, mre1, mim1, mre0, mim0,
                                                solve=True)),
                     (f"{k2}_plain", lambda: subs.substep2_plain(x, v, p, w, w1, v1, mre1,
                                                                 mim1, mre0, mim0,
                                                                 solve=True))):
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
    the in-place carry, and a step of the pingpong probe's carry (the half
    index h on the card; printed only) (these launches come after the
    probes' counts were read)."""
    from pic1dp_tpu_torch.ops import stream_probes as sp
    from pic1dp_tpu_torch.probes import fresh_streams, pingpong_probe
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
    pingpong = {}
    for name, kernel in (("stream_carry", sp.stream_carry),
                         ("stream_carry_plain", sp.stream_carry_plain)):
        c = pingpong_probe.carry("pingpong", fresh_streams(4, n, dev, 510))
        pingpong_probe.step(c, kernel)
        pingpong[name] = _events_ms(lambda: pingpong_probe.step(c, kernel), 10)
        del c
    say(f"[6 timing] pingpong carry (h on the card) per step at n=2^{PROBE_LOG2}: "
        f"stream_carry {pingpong['stream_carry']:.4f} ms, its plain version "
        f"{pingpong['stream_carry_plain']:.4f} ms")
    return out


def hist_split(per_kernel: dict) -> tuple[float, float]:
    """(deposit ms, row-sum ms) of one hat-deposit call from
    probes.kernel_ms' durations by kernel name."""
    dep = sum(ms for name, ms in per_kernel.items() if "hist_kernel" in name)
    rows = sum(ms for name, ms in per_kernel.items() if "hist_sum_kernel" in name)
    return dep, rows


def time_hists() -> tuple[dict, dict, dict]:
    """ms per call of each hat-deposit kernel, of its plain version and of
    the one PyTorch call that computes the same scatter (index_add_ of the
    plain version's bins and terms, made beforehand), from CUDA-graph
    replays (probes.graph_ms), in f32 at its path's shape: the x-v histogram
    at the main shape (6.4M markers, the 64 x 64 grid) as a snapshot runs
    it, the marker pass (xv_pass: three channels from live, p and w, and
    their moments; and, printed only, hist_xv on the three-channel stack as
    before the pass), the profile at the optimization run's 2^21 (and at
    6.4M, printed only), the grid charge at the main shape (nx 192).  The
    bound: the marker streams and the output once over HBM (x, v, the live
    byte, p and w, or x, v and k channels; v, w and the live byte; x and
    val), or per marker 14 + 8k + 3k, 14 + 8k, 11 and 8 operations (the hat
    cells and weights, a product and an add per term, the moments' two
    products and an add), whichever is larger.
    Beside them the kernel's two launches apart, the deposit and the row
    sum (probes.kernel_ms: their device time in a profiled graph replay).
    Returns (ms, bounds, library ms) by kernel and "<name>_plain"."""
    from pic1dp_tpu_torch.config import bump_on_tail_default
    from pic1dp_tpu_torch.ops import hist_kernels as hk
    from pic1dp_tpu_torch.probes import graph_ms, kernel_ms

    cfg = bump_on_tail_default()
    lx, vm, nxo, nvo, nv, dev = cfg.lx, cfg.v_max, cfg.nx_opd, cfg.nv_opd, cfg.nv, \
        torch.device("cuda")
    per_call, bounds, library = {}, {}, {}
    for name, n, form in (("hist_xv", FULL_N, "pass"), ("hist_xv", FULL_N, "vals"),
                          ("hist_v", OPT_N, ""), ("hist_v", FULL_N, ""),
                          ("grid_charge", FULL_N, "")):
        x, v, p, w, live = hist_markers(n, 1, "float32", lx, vm, SEED)
        if form == "pass":
            args = (x[0], v[0], live[0], p[0], w[0], lx, vm, nxo, nvo)
            fn, plain = hk.xv_pass, hk.xv_pass_plain
            vals = hist_vals(x[0], p[0], w[0], live[0])
            terms = lambda *a: hk.hist_xv_terms(x[0], v[0], vals, lx, vm, nxo, nvo)
            nout, k, shape = nvo * nxo, 3, f"{nvo} x {nxo}, the marker pass (xv_pass)"
            nbytes, ops = n * (4 + 4 + 1 + 4 + 4) + k * nout * 4, n * (14 + 8 * k + 3 * k)
        elif form == "vals":
            vals = hist_vals(x[0], p[0], w[0], live[0])
            args = (x[0], v[0], vals, lx, vm, nxo, nvo)
            fn, plain, terms = hk.hist_xv, hk.hist_xv_plain, hk.hist_xv_terms
            nout, k, shape = nvo * nxo, 3, f"{nvo} x {nxo}, hist_xv of k = 3 channels"
            nbytes, ops = n * (2 + k) * 4 + k * nout * 4, n * (14 + 8 * k)
        elif name == "hist_v":
            args = (v, w, live, vm, nv)
            fn, plain, terms = hk.profile, hk.profile_plain, hk.profile_terms
            nout, k, shape = nv, 1, f"nv {nv}"
            nbytes, ops = n * 9 + nout * 4, n * 11
        else:
            val = torch.where(live, w, 0.0) * -1.0
            args = (x, val, lx, cfg.nx)
            fn, plain, terms = hk.grid_charge, hk.grid_charge_plain, hk.grid_charge_terms
            nout, k, shape = cfg.nx, 1, f"nx {cfg.nx}"
            nbytes, ops = n * 8 + nout * 4, n * 8
        bins, tm = terms(*args)
        out = torch.zeros((nout, k) if name == "hist_xv" else (nout,), device=dev)
        ms = {"kernel": graph_ms(lambda: fn(*args), dev),
              "plain": graph_ms(lambda: plain(*args), dev),
              "index_add_": graph_ms(lambda: out.zero_().index_add_(0, bins, tm), dev)}
        b = bound(nbytes, ops)
        dep, rows = hist_split(kernel_ms(lambda: fn(*args), dev))
        say(f"[6 timing] {name} f32 at n={n}, {shape}: kernel {ms['kernel']:.4f} ms (deposit "
            f"{dep:.4f}, row sum {rows:.4f}), plain {ms['plain']:.4f}, index_add_ alone "
            f"{ms['index_add_']:.4f}; bound {b[0]:.4f} ms ({b[1]}, {nbytes / n:.2f} B a "
            f"marker), share {b[0] / ms['kernel']:.1%}")
        if name not in per_call:
            per_call[name], per_call[f"{name}_plain"] = ms["kernel"], ms["plain"]
            bounds[name], library[name] = b, ms["index_add_"]
        del x, v, p, w, live, bins, tm, out, args
    torch.cuda.empty_cache()
    return per_call, bounds, library


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


# markers per species whose species starts are not V-aligned (V = 4 in f32,
# 2 in f64): the species loop's blocks walk single-marker heads and tails
ODD_N = 102_401


def nine_species_phase() -> dict:
    """Landau k = 0.5 as nine identical species (nine_species_cfg): the
    kernels against their plain versions in f32 and f64 (species 8 takes its
    constants from the species table) at 102,400 markers each and at ODD_N,
    and at 17 species in f64 (species 8-16 from the table); the grid bin's
    species loop, two species with 16 kept modes, against the plain versions
    in f32 and f64 and recompute = streamed bit for bit; graph = eager, and
    Simulation.run to t = 20, gamma from the energy peaks within the
    example's 5% of the one-species root.  Returns the run's launches."""

    cfg = nine_species_cfg()
    for n in (cfg.nparticle_max, ODD_N):
        c = nine_species_cfg(n=n)
        compare_substeps(c, n, F32_TOL, _loaded_inputs(c))
    for c in (nine_species_cfg("float64", 2**14), nine_species_cfg("float64", ODD_N),
              nine_species_cfg("float64", 2**14 + 1, ns=17)):
        for stream_v1 in (True, False):
            compare_substeps(c, c.nparticle_max, None, _loaded_inputs(c), stream_v1=stream_v1)
    wide = dataclasses.replace(two_species_cfg(), modes=tuple(range(1, 17)))
    for c, tol in ((wide, F32_TOL),
                   (dataclasses.replace(wide, dtype="float64", nparticle_max=2**16), None)):
        for stream_v1 in (True, False):
            compare_substeps(c, c.nparticle_max, tol, _loaded_inputs(c), stream_v1=stream_v1)
    compare_v1_layouts(wide)
    compare_graph(wide)
    compare_graph(cfg)
    zero_substep_counts()
    snaps, launches = run_case("7 species", "nine species", cfg)
    landau = examples()[1]
    root = landau.theory(landau_damping_cfg())
    gamma = landau.fit_gamma(snaps)
    rel = abs(gamma - root.imag) / abs(root.imag)
    say(f"[7 species] nine species: gamma (energy peaks, t in [1, 15]) {gamma:.5f} vs the "
        f"one-species root {root.imag:.5f}, rel err {rel:.4f} (limit 0.05)")
    check(rel <= 0.05, "nine species gamma within 5% of the root")
    return launches


def idle_share(stepper, state, steps: int) -> tuple[float, float, float]:
    """ms/step, the share of the time the card runs no kernel and the
    kernels per step, over one replay of a `steps`-step CUDA graph under
    torch.profiler (from the first kernel's start to the last one's end)."""
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
    return span / steps * 1e-3, 1.0 - busy / span, len(spans) / steps


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
            ms, idle, per_step = idle_share(st, state, TIMING_STEPS)
            name = f"{label} {st.substeps.layout}"
            say(f"[7 phase table] {name}, n={cfg.nparticle_max} nx={cfg.nx} f32:")
            for line in format_phase_table(table).splitlines():
                say(f"[7 phase table]   {line}")
            say(f"[7 phase table] {name}: step minus the two kernels {rest * 1e3:.4f} ms; "
                f"{TIMING_STEPS}-step graph replay under the profiler {ms:.4f} ms/step, idle "
                f"share {idle:.4f} (no kernel running), {per_step:.2f} kernels a step")
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


# ---- phase 4 (continued): the analysis tools on the card's own output ----

RUNINFO_GAMMA_TOL = 0.02   # runinfo's window takes one snapshot before 25 and none at 70


def analysis_phase(cfg, out_dir: str, gamma: float) -> None:
    """runinfo and ptcldist (pic1dp_tpu_torch/analysis/, no -vis) on the
    pic1dp.out of phase 4's f32 main run: runinfo's growth rate over the
    example's window against phase 4's gamma; ptcldist's x-v and v files
    equal to what OutputData reads, the v-space marker distribution summing
    to the markers inside v_max (at least 99% of them); and the viewer, which needs matplotlib,
    failing with its ImportError where the card's machine has none (built
    headless where it has)."""
    import io

    from pic1dp_tpu_torch.analysis import output_data, ptcldist, runinfo, visual

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        runinfo.main(["-gr", str(GAMMA_WINDOW[0]), str(GAMMA_WINDOW[1]),
                      "-sr", "0", str(cfg.time_max), out_dir])
    for line in text.getvalue().strip().splitlines():
        say(f"[4 analysis] runinfo: {line}")
    found = re.search(r"growth rate = (\S+)", text.getvalue())
    check(found is not None, "runinfo reports a growth rate")
    g = float(found.group(1))
    rel = abs(g - gamma) / gamma
    say(f"[4 analysis] runinfo gamma {g:.5f} against phase 4's {gamma:.5f}: rel {rel:.4f} "
        f"(limit {RUNINFO_GAMMA_TOL})")
    check(rel <= RUNINFO_GAMMA_TOL, "runinfo's gamma matches phase 4's")

    data = output_data.OutputData(out_dir)
    last = data.ntime - 1
    with tempfile.TemporaryDirectory() as d:
        for xv, dist in ((0, "2"), (1, "0")):
            with contextlib.redirect_stdout(io.StringIO()):
                ptcldist.main([out_dir, "-xv", str(xv), "-d", dist, "-o", d])
        xv_file = np.loadtxt(os.path.join(d, "ptcldist_xv.dat"))
        v_file = np.loadtxt(os.path.join(d, "ptcldist_v.dat"))
        v_axis = np.loadtxt(os.path.join(d, "ptcldist_v_v.dat"))
    check(xv_file.shape == (cfg.nv_opd, cfg.nx_opd + 1) and v_file.shape == (cfg.nv_opd,),
          "ptcldist file shapes")
    check(np.array_equal(xv_file, data.get_ptcldist_xv(last, 0, 2))
          and np.array_equal(v_file, data.get_ptcldist_v(last, 0, 0))
          and np.array_equal(v_axis, data.v_pd), "ptcldist files equal the stream's records")
    # markr_v is the marker histogram times (nv - 1) / (2 v_max)
    markers = float(np.sum(v_file)) * 2.0 * cfg.v_max / (cfg.nv_opd - 1)
    say(f"[4 analysis] ptcldist: delta f (x, v) {xv_file.shape}, max |delta f| "
        f"{np.abs(xv_file).max():.4e}; markers in g(v) {markers:.1f} of {cfg.nparticle_max}")
    check(bool(np.isfinite(xv_file).all()) and np.abs(xv_file).max() > 0,
          "delta f (x, v) finite and not zero")
    # markers at |v| >= v_max are left out of the histograms (deposit_xv)
    check(0.99 * cfg.nparticle_max <= markers <= cfg.nparticle_max * (1 + 1e-9),
          "g(v) sums to the markers inside v_max")
    if importlib.util.find_spec("matplotlib") is None:
        try:
            visual.VisualApp(out_dir)
        except ImportError as exc:
            say(f"[4 analysis] visual: no matplotlib here; VisualApp raised {exc!r}")
        else:
            check(False, "VisualApp without matplotlib raises ImportError")
    else:
        import matplotlib

        matplotlib.use("Agg", force=True)
        app = visual.VisualApp(out_dir)
        app.update_all()
        say(f"[4 analysis] visual: VisualApp built headless over {data.ntime} snapshots")


# ---- phase 8: multi-device runs on the one card ----

GLOO_STEPS = 5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(cfg, smi: str) -> dict:
    """A one-rank NCCL job on the card (the card check of particle
    data-parallelism; NCCL refuses two ranks on one GPU): Simulation(mesh=1)
    of the main case at full width to time_max, its steps replayed from CUDA
    graphs that hold the two all_reduces of each step, against the same
    run without a mesh: x, v, w, E and every other field bit for bit, the
    launches, and gamma against the root.  Then the graph step of Stepper
    and of ShardedStepper over the same state in turns (single, mesh, mesh,
    single): the price of the all_reduces.  Returns the run's launches."""
    import torch.distributed as dist

    from pic1dp_tpu_torch import Simulation
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.state import FIELDS
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.parallel import launch
    from pic1dp_tpu_torch.parallel import mesh as pmesh

    launch.initialize(f"tcp://localhost:{free_port()}", 1, 0, "cuda")
    try:
        mesh = launch.global_mesh("cuda")
        check(mesh.size == 1 and dist.get_backend(mesh.group) == "nccl",
              "a one-rank NCCL mesh")
        label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
        single = Simulation(cfg, device="cuda")
        single.run()
        zero_substep_counts()
        sharded = Simulation(cfg, device="cuda", mesh=mesh)
        snaps = []
        sharded.run(snapshot_callback=snaps.append)
        torch.cuda.synchronize()
        launches = substep_counts()
        used = {k.name for k in sharded.stepper.substeps.counters}
        steps = sharded.itime
        graphs = sorted(sharded.stepper._graphs)
        same = {f: torch.equal(getattr(single.state, f), getattr(sharded.state, f))
                for f in FIELDS}
        gamma = examples()[0].fit_gamma(snaps, cfg.time_max)
        rel = abs(gamma - BOT_OMEGA.imag) / BOT_OMEGA.imag
        say(f"[8 mesh] {label} Simulation(mesh=1) on NCCL, {cfg.nparticle_max} markers, "
            f"nx={cfg.nx}: {steps} steps, graphs of {graphs} steps; launches {launches}; "
            f"bitwise equal to the run without a mesh {same}; gamma {gamma:.5f} vs "
            f"{BOT_OMEGA.imag:.5f}, rel err {rel:.4f} (limit {GAMMA_REL_TOL})")
        check(bool(graphs), f"{label} mesh run replayed CUDA graphs")
        check(set(launches) == used and all(v == steps for v in launches.values()),
              f"{label} mesh run: one launch of each of {sorted(used)} per step")
        check(all(same.values()), f"{label} one-rank mesh run bit for bit the single run")
        check(rel <= GAMMA_REL_TOL, f"{label} mesh run gamma within 5% of the root")
        del single, sharded

        plain, shard = Stepper(cfg, "cuda"), pmesh.ShardedStepper(cfg, mesh)
        state0 = plain.initial_field(load_particles(cfg, "cuda"))
        ms = {"single": [], "mesh": []}
        for which in ("single", "mesh", "mesh", "single"):
            st = plain if which == "single" else shard
            box = [st.multi_step(state0.clone(), WARMUP_STEPS)]
            box[0] = st.graph_steps(box[0], TIMING_STEPS)     # captures the graph
            torch.cuda.synchronize()
            ms[which].append(_events_ms(lambda: st.graph_steps(box[0], TIMING_STEPS), 1)
                             / TIMING_STEPS)
            del box
        mean = {w: float(np.mean(v)) for w, v in ms.items()}
        say(f"[8 mesh] {label} graph ms/step in turns single, mesh, mesh, single: "
            + "; ".join(f"{w} {mean[w]:.4f} ({v[0]:.4f}, {v[1]:.4f})" for w, v in ms.items())
            + f"; the two all_reduces and their copies {mean['mesh'] - mean['single']:+.4f} "
              f"ms/step; card {smi}")
        return launches
    finally:
        dist.destroy_process_group()


def gloo_rank(rank: int, port: int, cfg_json: str, out: str) -> None:
    """One rank of the two-rank gloo job on the one card (gloo_phase): its
    half of the markers stepped one step and then GLOO_STEPS timed eager
    steps with the kernels, against its half of the same steps without a
    mesh, within the f32 bounds; writes what it measured to
    <out>.rank<rank>.json."""
    from pic1dp_tpu_torch.config import Config
    from pic1dp_tpu_torch.core.loading import load_particles
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.ops import substep_kernels as sk
    from pic1dp_tpu_torch.parallel import launch
    from pic1dp_tpu_torch.parallel import mesh as pmesh

    launch.initialize(f"tcp://localhost:{port}", 2, rank, "cpu")   # gloo
    try:
        cfg = Config.from_json(cfg_json)
        mesh = pmesh.make_mesh(2, device="cuda:0")
        single = Stepper(cfg, mesh.device)
        ref = single.initial_field(load_particles(cfg, mesh.device))
        state = pmesh.shard_state(ref, mesh)
        start, stop = pmesh.local_block(cfg.nparticle_max, mesh)
        for _ in range(GLOO_STEPS):
            ref = single.step(ref)
        shard = pmesh.ShardedStepper(cfg, mesh)
        state = shard.step(shard.initial_field(state))     # one step to warm up
        ref = single.step(ref)
        for k in sk.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = shard.multi_step(state, GLOO_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / GLOO_STEPS
        err = dict(x=periodic_err(state.x, ref.x[:, start:stop], cfg.lx),
                   v=abs_err(state.v, ref.v[:, start:stop]),
                   w=rel_err(state.w, ref.w[:, start:stop]),
                   proj=max(rel_err(state.mode_re, ref.mode_re),
                            rel_err(state.mode_im, ref.mode_im)))
        with open(f"{out}.rank{rank}.json", "w") as fh:
            json.dump({"rank": rank, "ms_per_step": ms, "err": err,
                       "launches": {k.name: k.launches for k in sk.KERNELS if k.launches},
                       "graphs": len(shard._graphs)}, fh)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def gloo_phase(cfg, smi: str) -> None:
    """Two gloo ranks on the one card, each in a process of its own (gloo
    takes CUDA tensors; NCCL refuses two ranks on one GPU): the main case's
    markers split in halves, 1 + GLOO_STEPS eager steps (a gloo all_reduce
    cannot be captured in a graph) with the kernels, each rank's half
    against the same steps without a mesh within the f32 bounds; the host
    clock's ms/step.  No multi-card run is possible on this machine."""
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "gloo")
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.gloo_rank({r}, {port}, "
             f"{cfg.to_json()!r}, {out!r})"],
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            check(p.returncode == 0, f"gloo rank exited {p.returncode}: {err[-2000:]}")
        ranks = []
        for r in range(2):
            with open(f"{out}.rank{r}.json") as fh:
                ranks.append(json.load(fh))
    label = "bf16_weights" if cfg.bf16_weights else cfg.dtype
    for r in ranks:
        say(f"[8 gloo] {label} rank {r['rank']} of 2 on one card, "
            f"{cfg.nparticle_max // 2} markers: {GLOO_STEPS} eager steps "
            f"{r['ms_per_step']:.4f} ms/step (host clock); launches {r['launches']}; "
            f"against the run without a mesh: " + ", ".join(
                f"{k} {v:.3e} (limit {F32_TOL[k]})" for k, v in r["err"].items())
            + f"; card {smi}")
        check(r["graphs"] == 0, "gloo ranks step eagerly")
        check(len(r["launches"]) == 2 and all(v == GLOO_STEPS for v in r["launches"].values()),
              "each gloo rank launched both substep kernels once a step")
        check(all(v <= F32_TOL[k] for k, v in r["err"].items()),
              "two gloo ranks within the f32 bounds of the run without a mesh")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                         "is False")
    from pic1dp_tpu_torch.config import bump_on_tail_default
    from pic1dp_tpu_torch.ops import hist_kernels as hk
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
    err.update(compare_hists())
    torch.cuda.synchronize()

    # the main path as the example script configures and fits it (one
    # snapshot a time unit, as the example writes them)
    example_cfg = quiet(examples()[0].config(FULL_N, main_cfg.time_max))
    check(dataclasses.replace(example_cfg, output_interval=main_cfg.output_interval)
          == main_cfg, "the example's config is the main case")
    with tempfile.TemporaryDirectory() as main_out:
        launches, gamma32 = main_path(example_cfg, out_dir=main_out)
        analysis_phase(example_cfg, main_out, gamma32)
        launches["grid_charge"] = repeat_phase(example_cfg, main_out)["grid_charge"]
    bf16_launches, gamma16 = main_path(dataclasses.replace(example_cfg, bf16_weights=True))
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
    worst, opt_hists = optimization_phase()
    for name, e in worst.items():
        err[name] = max(err[name], e)
    launches["hist_v"] = opt_hists["hist_v"]
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

    for cfg in (main_cfg, bf16_cfg):
        mesh_phase(cfg, smi)
    gloo_phase(main_cfg, smi)
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
    hist_ms, hist_bounds, library = time_hists()
    per_call.update(hist_ms)
    bounds.update(hist_bounds)
    time_steppers(main_cfg, smi)
    time_steppers(headline, smi)
    time_steppers(head16, smi)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                "max_abs_err": err[k.name], "ms": per_call[k.name],
                "plain_ms": per_call[f"{k.name}_plain"], "bound_ms": bounds[k.name][0],
                "bound_by": bounds[k.name][1], "library_ms": library.get(k.name)}
               for k in sk.KERNELS + sp.KERNELS + hk.KERNELS]
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched on its main path")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
