"""What each part of the substep kernels' grid bin costs: the kernels built
with one part swapped, timed against them in turns.

    python -m pic1dp_tpu_torch.probes.grid_forms [n_log2=26]

The grid bin (more than 4 kept modes; csrc/substep_kernels.cu) forms E on
the nx cells in each block, gathers it at the markers, deposits onto
per-warp charge grids and projects them onto the modes.  This probe builds
csrc/substep_kernels.cu as it is and in the variants of FORMS (each a
library of its own under pic1dp_tpu_torch/_build/grid_forms/, all nvcc
runs started at once), and times both f32 substeps in both nonlinear
delta-f layouts through FusedSubsteps at 16, 32 and 64 kept modes on 6.4M
markers (or 2^n_log2, if fewer), nx 192, and at 32 modes on 2^n_log2
markers, nx 1024, in turns over the variants and back.  A variant is a
text substitution in the source; the probe refuses a source whose text it
does not find.  The deposit variants compute the same function in another
order (atomic: in an order that varies from run to run), the last two a
wrong one: they only time what their part costs.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
import sys

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import bump_on_tail_default
from pic1dp_tpu_torch.ops import substep_kernels as sk
from pic1dp_tpu_torch.probes import describe, graph_ms
from pic1dp_tpu_torch.utils import nvcc

CSRC = nvcc.PACKAGE_DIR / "csrc"
OUT = nvcc.BUILD_DIR / "grid_forms"
MAIN_N, MAIN_NX, WIDE_NX = 6_400_000, 192, 1024

_DEPOSIT_START = "template <int W, typename T>\n__device__ __forceinline__ void deposit_group("
_DEPOSIT_END = "// push1 and push2 in the grid form"
_DEPOSIT_HEAD = """template <int W, typename T>
__device__ __forceinline__ void deposit_group(const GridRefs<T>& r, int nx, const int (&cell)[W],
                                              const T (&frac)[W], const T (&val)[W], bool on) {
  const unsigned lane = threadIdx.x & 31u;
  for (int ph = 0; ph < r.phases; ++ph) {
    if (ph == r.phase) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int c = on ? cell[k] : -1;
        const T a = val[k] * (T(1) - frac[k]), b = val[k] * frac[k];
"""
_DEPOSIT_TAIL = """      }
    }
    if (r.phases > 1) __syncthreads();
  }
}

"""
# one __match_any_sync for each hat half, as deposit_lanes does for both
_MATCH_HALF = """        for (int half = 0; half < 2; ++half) {
          const T val_h = half ? b : a;
          const unsigned peers = __match_any_sync(0xffffffffu, c);
          const bool lowest = (peers & ((1u << lane) - 1u)) == 0u;
          const unsigned above = peers & ~((2u << lane) - 1u);
          T sum = val_h;
          if (__any_sync(0xffffffffu, above != 0u)) {
            r.stage[lane] = val_h;
            __syncwarp();
            if (lowest)
              for (unsigned rest = above; rest != 0u; rest &= rest - 1u)
                sum += r.stage[__ffs(rest) - 1];
          }
          if (lowest && c >= 0) r.rho[half * nx + c] += sum;
          __syncwarp();
        }
"""
# the lanes of a warp one after another
_LANE_SERIAL = """        for (unsigned l = 0; l < 32u; ++l) {
          if (l == lane && c >= 0) {
            r.rho[c] += a;
            r.rho[nx + c] += b;
          }
          __syncwarp();
        }
"""
# shared-memory float atomics: no grouping, an order that varies
_ATOMIC = """        if (c >= 0) {
          atomicAdd(r.rho + c, a);
          atomicAdd(r.rho + nx + c, b);
        }
        (void)lane;
"""
_EGRID = ("    const T e = grid_e(a.angles, nx, p.nmode, j, a.re, a.im);",
          "    const T e = T(0);")
_EGRID0 = ("      const T e0 = grid_e(a.angles, nx, p.nmode, j, a.re0, a.im0);",
           "      const T e0 = T(0);")
_PROJECT = ("""  project_grid(p, a.angles, rho,
               a.partials + static_cast<long long>(blockIdx.x) * 2 * p.nmode);""",
            """  for (int k = threadIdx.x; k < 2 * p.nmode; k += kThreads)
    a.partials[static_cast<long long>(blockIdx.x) * 2 * p.nmode + k] = T(0);""")

# variant -> what it is
FORMS = {
    "kernel": "the grid bin as it is: one __match_any_sync a marker for both hat halves",
    "match_half": "one __match_any_sync for each hat half",
    "lane_serial": "the lanes of a warp deposit one after another",
    "atomic": "shared-memory float atomicAdd (an order that varies: a floor, timing only)",
    "no_egrid": "no E grid formed (E = 0): the most that forming it once per call could save",
    "no_project": "no projection (zero partials rows): what the per-block projection costs",
}


def _deposit(body: str, src: str) -> str:
    start, end = src.index(_DEPOSIT_START), src.index(_DEPOSIT_END)
    return src[:start] + _DEPOSIT_HEAD + body + _DEPOSIT_TAIL + src[end:]


def _swap(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"grid_forms: the source no longer holds {old.strip()!r}")
        src = src.replace(old, new)
    return src


def variant_sources() -> dict[str, str]:
    """Each variant's csrc/substep_kernels.cu."""
    src = (CSRC / "substep_kernels.cu").read_text()
    for anchor in (_DEPOSIT_START, _DEPOSIT_END):
        if src.count(anchor) != 1:
            raise SystemExit(f"grid_forms: the source no longer holds {anchor.strip()!r}")
    return {"kernel": src,
            "match_half": _deposit(_MATCH_HALF, src),
            "lane_serial": _deposit(_LANE_SERIAL, src),
            "atomic": _deposit(_ATOMIC, src),
            "no_egrid": _swap(src, _EGRID, _EGRID0),
            "no_project": _swap(src, _PROJECT)}


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every variant at once (headers copied beside each) and bind it."""
    procs = {}
    for name, text in variant_sources().items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "substep_kernels.cu").write_text(text)
        cmd = [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "substep_kernels.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"grid_forms: nvcc failed on {name}:\n{log[-4000:]}")
        libs[name] = sk.bind(ctypes.CDLL(str(OUT / name / "lib.so")))
    return libs


def run(n: int, say=functools.partial(print, flush=True)) -> dict:
    device = torch.device("cuda")
    say(describe(device, n))
    for name, what in FORMS.items():
        say(f"  {name:<12} {what}")
    libs = build_all()
    order = list(libs) + list(libs)[::-1]
    shapes = [(m, min(n, MAIN_N), MAIN_NX) for m in (16, 32, 64)] + [(32, n, WIDE_NX)]
    out = {}
    try:
        for nmode, markers, nx in shapes:
            cfg = bump_on_tail_default(nx=nx, nparticle_max=markers,
                                       modes=tuple(range(1, nmode + 1)), init_modes=(1,),
                                       verbosity=0)
            gen = torch.Generator(device=device).manual_seed(1)
            x = torch.rand((1, markers), generator=gen, device=device) * cfg.lx
            v = torch.randn((1, markers), generator=gen, device=device) * 2.0
            p = torch.rand((1, markers), generator=gen, device=device) * 1e-6
            w = torch.randn((1, markers), generator=gen, device=device) * 1e-7
            modes = [torch.rand(nmode, generator=gen, device=device) * 1e-3 for _ in range(4)]
            sp = dist.SpeciesParams.from_config(cfg, torch.float32, device)
            for stream_v1 in (True, False):
                for name in order:
                    sk._lib = libs[name]
                    subs = sk.FusedSubsteps(cfg, sp, stream_v1=stream_v1)
                    w1, v1, _ = subs.substep1(x, v, p, w, *modes[:2])
                    t1 = graph_ms(lambda: subs.substep1(x, v, p, w, *modes[:2]), device)
                    t2 = graph_ms(lambda: subs.substep2(x, v, p, w, w1, v1, *modes[2:],
                                                        *modes[:2]), device)
                    key = (nmode, markers, nx, subs.layout, name)
                    out.setdefault(key, []).append((t1, t2))
            del x, v, p, w
            torch.cuda.empty_cache()
    finally:
        sk._lib = None
    for (nmode, markers, nx, lay, name), turns in out.items():
        t1 = sum(t[0] for t in turns) / len(turns)
        t2 = sum(t[1] for t in turns) / len(turns)
        say(f"{nmode:>2} modes n {markers} nx {nx:<5} {lay:<9} {name:<12} substep1 {t1:.4f} ms "
            f"({', '.join(f'{t[0]:.4f}' for t in turns)})  substep2 {t2:.4f} ms "
            f"({', '.join(f'{t[1]:.4f}' for t in turns)})")
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("grid_forms times CUDA kernels: torch sees no CUDA device")
    return run(2 ** int(argv[0]) if argv else 2**26)


if __name__ == "__main__":
    main()
