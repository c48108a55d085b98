"""What each part of the hat deposits costs: csrc/hist_kernels.cu built in
variants, timed against it in turns.

    python -m pic1dp_tpu_torch.probes.hist_forms

The hat deposits (ops/hist_kernels.py) give every warp its own grid copy,
let a lane take a few markers a round with the next round's loads in
flight, match every marker of a round first and add to the grid last, and
deposit the x-v histogram (D1) one channel a block.  This probe builds the
source as it is and in the variants of FORMS (each a library of its own
under pic1dp_tpu_torch/_build/hist_forms/, all nvcc runs started at once;
a variant is a text substitution in the source, and the probe refuses a
source whose text it does not find; some variants only change a setting
of the module), and times D1, D2 and D3 at chip_smoke.time_hists' shapes
in f32 (6.4M markers, 64 x 64, three channels; 2^21, nv 128; 6.4M, nx 192)
per call (CUDA-graph replays) and their deposit and row-sum kernels apart
(probes.kernel_ms), in turns over the variants and back.  The last three
variants may compute a wrong sum: they only time what their part costs.  Needs
a CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess

import torch

from pic1dp_tpu_torch.config import bump_on_tail_default
from pic1dp_tpu_torch.ops import hist_kernels as hk
from pic1dp_tpu_torch.probes import describe, graph_ms, kernel_ms
from pic1dp_tpu_torch.utils import nvcc

CSRC = nvcc.PACKAGE_DIR / "csrc"
OUT = nvcc.BUILD_DIR / "hist_forms"
MAIN_N, OPT_N = 6_400_000, 2**21

_DEFAULTS = {k: getattr(hk, k) for k in ("MARKERS_XV", "MARKERS_X", "SHARE", "CLAIM_MAX",
                                          "LANE_WARPS_MIN")}
_MXV = f"constexpr int kMXV = {hk.MARKERS_XV};"
_MX = f"constexpr int kMX = {hk.MARKERS_X};"
_SHARE = f"constexpr int kShare = {hk.SHARE};"
_CLAIM_MAX = f"constexpr int kClaimMax = {hk.CLAIM_MAX};"
_LANES = f"constexpr int kLaneWarpsMin = {hk.LANE_WARPS_MIN};"
_CLAIM = "  if constexpr (KIND == kXV) {\n    const int slot"
_MATCH = "peers[j] = lanes_of_cell<KIND>(claim, slots, t[j].cell);"
_RMW = "    if (lead) add_pair("
_ROW_SYNC = "    if (lead) add_pair(grid, t.cell + r * row, t.v[r][0], t.v[r][1]);\n    __syncwarp();"
_PREFETCH = (
    ("  if (rounds > 0) load_batch(cur, a, ch, begin + lane_off, valid_from<M>(begin + lane_off, end));\n",
     ""),
    ("    if (r + 1 < rounds) load_batch(nxt, a, ch, next, valid_from<M>(next, end));",
     "    load_batch(cur, a, ch, base + lane_off, valid_from<M>(base + lane_off, end));"),
    ("        if (share > 1) group_sync(1 + copy, 32 * share);\n      }\n    }\n    cur = nxt;\n",
     "        if (share > 1) group_sync(1 + copy, 32 * share);\n      }\n    }\n"))

# variant -> (what it is, substitutions in the source, module settings)
FORMS = {
    "kernel": ("as it is: D2, D3 in lane copies; D1 one channel a block, two warps a grid "
               "copy, a claim before each match, 8 markers a lane", (), {}),
    "no_lanes": ("D2, D3 in warp copies with a match a marker, as D1",
                 ((_LANES, "constexpr int kLaneWarpsMin = 1000;"),), {"LANE_WARPS_MIN": 1000}),
    "no_claim": ("D1: a __match_any_sync for every marker, no claim first",
                 ((_CLAIM, _CLAIM.replace("kXV", "-1")),), {}),
    "mxv4": ("D1: 4 markers a lane a round", ((_MXV, "constexpr int kMXV = 4;"),),
             {"MARKERS_XV": 4}),
    "mxv16": ("D1: 16 markers a lane a round", ((_MXV, "constexpr int kMXV = 16;"),),
              {"MARKERS_XV": 16}),
    "mx8": ("D2, D3: 8 markers a lane a round", ((_MX, "constexpr int kMX = 8;"),),
            {"MARKERS_X": 8}),
    "mx32": ("D2, D3: 32 markers a lane a round", ((_MX, "constexpr int kMX = 32;"),),
             {"MARKERS_X": 32}),
    "share1": ("D1: a grid copy a warp", ((_SHARE, "constexpr int kShare = 1;"),), {"SHARE": 1}),
    "share3": ("D1: three warps a grid copy, their grid steps in turns",
               ((_SHARE, "constexpr int kShare = 3;"),), {"SHARE": 3}),
    "claim4k": ("D1: claim tables of 4096 slots, a slot a cell",
                ((_CLAIM_MAX, "constexpr int kClaimMax = 4096;"),), {"CLAIM_MAX": 4096}),
    "no_prefetch": ("D1: each round's loads issued at its start, none in flight while the "
                    "warp deposits", _PREFETCH, {}),
    "no_row_sync": ("D1: no __syncwarp between a marker's grid rows (rows may race: timing "
                    "only)", ((_ROW_SYNC, _ROW_SYNC.replace("\n    __syncwarp();", "")),), {}),
    "no_match": ("D1: no claim and no __match_any_sync, every lane leads its own cell (lanes "
                 "race: a wrong sum, timing only)",
                 ((_MATCH, "peers[j] = 1u << (threadIdx.x & 31);"),), {}),
    "no_rmw": ("D1: no read-modify-write of the grid (a wrong sum, timing only)",
               ((_RMW, "    if (lead && row < -1) add_pair("),), {}),
}


def _swap(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"hist_forms: the source no longer holds {old.strip()!r}")
        src = src.replace(old, new)
    return src


def variant_sources() -> dict[str, str]:
    """The source of the kernel and of each variant that changes it."""
    src = (CSRC / f"{hk.SOURCE}.cu").read_text()
    return {name: _swap(src, pairs) for name, (_, pairs, _) in FORMS.items()
            if name == "kernel" or pairs}


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every variant that changes the source, at once (headers
    copied beside each); the others share the kernel's library."""
    procs = {}
    for name, text in variant_sources().items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / f"{hk.SOURCE}.cu").write_text(text)
        cmd = [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / f"{hk.SOURCE}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"hist_forms: nvcc failed on {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return {name: libs.get(name, libs["kernel"]) for name in FORMS}


def _use(lib: ctypes.CDLL, settings: dict) -> None:
    """Bind lib with the module settings of its form (the others at their
    defaults)."""
    for k, v in {**_DEFAULTS, **settings}.items():
        setattr(hk, k, v)
    hk._configure.cache_clear()
    hk._lib = nvcc.Library(hk.bind(lib), OUT, 0.0, "")


def run(say=functools.partial(print, flush=True)) -> dict:
    device = torch.device("cuda")
    say(describe(device, MAIN_N))
    for name, (what, _, _) in FORMS.items():
        say(f"  {name:<15} {what}")
    libs = build_all()
    cfg = bump_on_tail_default()
    lx, vm = cfg.lx, cfg.v_max
    gen = torch.Generator(device=device).manual_seed(1)

    def markers(n):
        x = torch.rand(n, generator=gen, device=device) * lx
        v = (torch.rand(n, generator=gen, device=device) * 2.0 - 1.0) * (1.1 * vm)
        w = torch.randn(n, generator=gen, device=device) * 1e-3
        return x, v, w

    x, v, w = markers(MAIN_N)
    vals = torch.stack([torch.ones_like(x), torch.rand_like(x), w])
    xo, vo, wo = markers(OPT_N)
    live = torch.rand(OPT_N, generator=gen, device=device) > 0.1
    calls = {"D1 hist_xv": lambda: hk.hist_xv(x, v, vals, lx, vm, cfg.nx_opd, cfg.nv_opd),
             "D2 profile": lambda: hk.profile(vo[None], wo[None], live[None], vm, cfg.nv),
             "D3 grid_charge": lambda: hk.grid_charge(x, w, lx, cfg.nx)}
    out = {}
    try:
        for name in list(FORMS) + list(FORMS)[::-1]:
            _use(libs[name], FORMS[name][2])
            for label, fn in calls.items():
                split = kernel_ms(fn, device)
                out.setdefault((label, name), []).append((
                    graph_ms(fn, device),
                    sum(m for k, m in split.items() if "hist_kernel" in k),
                    sum(m for k, m in split.items() if "hist_sum_kernel" in k)))
    finally:
        for k, val in _DEFAULTS.items():
            setattr(hk, k, val)
        hk._configure.cache_clear()
        hk._lib = None
    for (label, name), turns in out.items():
        mean = [sum(t[i] for t in turns) / len(turns) for i in range(3)]
        say(f"{label:<15} {name:<15} {mean[0]:.4f} ms ({', '.join(f'{t[0]:.4f}' for t in turns)})"
            f"  deposit {mean[1]:.4f}  row sum {mean[2]:.4f}")
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("hist_forms times CUDA kernels: torch sees no CUDA device")
    return run()


if __name__ == "__main__":
    main()
