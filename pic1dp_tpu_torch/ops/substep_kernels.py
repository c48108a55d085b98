"""The two fused RK2 substeps of the matrix-free spectral step.

Port of the TPU kernel of pic1dp_tpu/ops/pallas_kernels.py
(make_substep_call, wrapped by FusedStepper.substep1/2) with separate
streams, in each of its layouts (pallas_kernels.py:499-508):

    nonlinear delta-f (stream_v1):
      substep 1:  read x0, v0, p, w0            write w1, v1
      substep 2:  read x0, v0, p, w0, w1, v1    write x2, v2, w2 over x0, v0, w0
    nonlinear delta-f, recompute (stream_v1=False; substep 2 rebuilds v1
    from the step-start modes, the same bits as substep 1's v1):
      substep 1:  read x0, v0, p, w0            write w1
      substep 2:  read x0, v0, p, w0, w1        write x2, v2, w2 over x0, v0, w0
    linear delta-f (v frozen, drive p E):
      substep 1:  read x0, v0, p, w0            write w1
      substep 2:  read x0, v0, p, w0, w1        write x2, w2 over x0, w0
    full-f (w unused, deposit p; substep 2 rebuilds v1 from the step-start
    modes):
      substep 1:  read x0, v0, p                write nothing
      substep 2:  read x0, v0, p                write x2, v2 over x0, v0

each also returning the (2, nmode) mode projections of charge * (w | p) at
the pushed positions, summed over species, and, asked with solve=True, the
E-field modes solved from them (spectral.solve_modes with the factor g =
grad_inv / lx that FusedSubsteps holds; the kernels' last block forms them,
so a step launches no solve of its own).  Every stream is at the config's
dtype, except under bf16_weights (delta-f only): there p and w1 are bfloat16
(cfg.p_dtype), upcast for the arithmetic, and w1 is rounded to bfloat16 by
round-to-nearest-even after substep 1 has deposited it unrounded
(pallas_kernels.py:555, :565-567, :586, :610).  For each substep this module
holds

  * the CUDA kernels of csrc/substep_kernels.cu, built by nvcc at first use
    and bound through ctypes: one body per substep for every layout, any
    number of species and of kept modes and every equilibrium (the C side
    picks the register bin of 1 or 4 modes, mode_bin, with the main path's
    instantiation for one bump-on-tail or Maxwellian species in nonlinear
    delta-f and the species loop otherwise; above 4 modes the grid bin,
    which gathers E from a grid of the nx cells and deposits onto a charge
    grid in shared memory, grid_smem); one launch counter per layout and
    build (KERNELS).  What they take beside the streams is made here: the
    grid-angle table (angle_table, staged into shared memory by the register
    bins when it fits, angle_smem_bytes), the species table (species_table:
    the species past the MAX_SPECIES the parameters hold read their
    constants from it), the grid bin's device buffer where its grids do not
    fit in shared memory, the grid (launch_grid: vector_width markers per
    thread and iteration, at most BLOCKS_PER_SM blocks per SM; species_grid
    in the species loop, one species per block), and the
    counter with which the last block finds out that it sums the partials
    into the projections;
  * the plain PyTorch version, FusedSubsteps.substep1_plain / substep2_plain,
    the same function written with the port's mode_trig / efield_at /
    project_modes and distributions.minus_dlnf0_dv, on any device;
  * the dispatch, FusedSubsteps.substep1 / substep2: a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises (a variant
    outside the kernels' set, a failed build, a failed launch).  Nothing
    falls back.

Substep 2 updates x, v and w in place in both versions, as the kernel does
(the TPU kernel aliases them too): the step-start state is consumed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, Equilibrium
from pic1dp_tpu_torch.ops import spectral as spectral_ops
from pic1dp_tpu_torch.ops.interp import wrap_x
from pic1dp_tpu_torch.ops.spectral import efield_at, mode_trig, project_modes
from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

# kMaxModes in csrc/substep_math.cuh: the modes SubstepParams holds (the
# register bins read the first 4)
MAX_MODES = 16
# kMaxSpecies: the species SubstepParams holds
MAX_SPECIES = 8
# kMaxGridSpecies: the species a launch takes, its grid's y extent
MAX_GRID_SPECIES = 65535
THREADS = 256           # kThreads in csrc/substep_kernels.cu
# kAngleSmemMax in csrc/substep_kernels.cu: the 48 KB a launch gets without
# an opt-in, less 4 KB kept for the kernels' static shared memory
ANGLE_SMEM_MAX = 48 * 1024 - 4096
# kGridSmemMax: the grid bin's dynamic shared memory at most, the 232,448
# bytes a block may have with an opt-in less 8 KB for its static arrays
GRID_SMEM_MAX = 232448 - 8192
# kWarps: the charge grids a grid-bin block keeps when they fit, one per warp
GRID_COPIES = THREADS // 32
# mode_bin's value for the grid bin (kGridBin)
GRID_BIN = 0
# shared memory of one H100 SM for its blocks (228 KB), and what a block
# takes beside its dynamic shared memory: the driver's 1 KB and the grid
# bin's static arrays (2 THREADS values of T and a flag)
SM_SMEM = 233472
BLOCK_SMEM_RESERVED = 1024
# blocks per SM at most (launch_grid), chosen by the blocks-per-SM sweep of
# probes/kernel_probe.py
BLOCKS_PER_SM = 4
SOURCE = "substep_kernels"
_SRC = f"pic1dp_tpu_torch/csrc/{SOURCE}.cu"
_TPU = "pic1dp_tpu/ops/pallas_kernels.py"

# nonlinear delta-f (any number of species: the block's species select,
# :543-547), linear (drive p E, :526; v1 = v0, :604-605) and full-f
# (deposit p, :629; v1 rebuilt, :601-603)
SUBSTEP1 = CudaKernel("substep1", _SRC, f"{_TPU}:558")
SUBSTEP2 = CudaKernel("substep2", _SRC, f"{_TPU}:592")
SUBSTEP1_BF16 = CudaKernel("substep1_bf16", _SRC, f"{_TPU}:586")
SUBSTEP2_BF16 = CudaKernel("substep2_bf16", _SRC, f"{_TPU}:610")
SUBSTEP1_LINEAR = CudaKernel("substep1_linear", _SRC, f"{_TPU}:526")
SUBSTEP2_LINEAR = CudaKernel("substep2_linear", _SRC, f"{_TPU}:604")
SUBSTEP1_LINEAR_BF16 = CudaKernel("substep1_linear_bf16", _SRC, f"{_TPU}:526")
SUBSTEP2_LINEAR_BF16 = CudaKernel("substep2_linear_bf16", _SRC, f"{_TPU}:604")
SUBSTEP1_FULLF = CudaKernel("substep1_fullf", _SRC, f"{_TPU}:629")
SUBSTEP2_FULLF = CudaKernel("substep2_fullf", _SRC, f"{_TPU}:601")
# nonlinear delta-f without stream_v1 (:501-507): substep 1 stores no v1
# (:588), substep 2 rebuilds it (:601)
SUBSTEP1_RECOMPUTE = CudaKernel("substep1_recompute", _SRC, f"{_TPU}:588")
SUBSTEP2_RECOMPUTE = CudaKernel("substep2_recompute", _SRC, f"{_TPU}:601")
SUBSTEP1_RECOMPUTE_BF16 = CudaKernel("substep1_recompute_bf16", _SRC, f"{_TPU}:588")
SUBSTEP2_RECOMPUTE_BF16 = CudaKernel("substep2_recompute_bf16", _SRC, f"{_TPU}:601")
KERNELS = (SUBSTEP1, SUBSTEP2, SUBSTEP1_BF16, SUBSTEP2_BF16,
           SUBSTEP1_LINEAR, SUBSTEP2_LINEAR, SUBSTEP1_LINEAR_BF16, SUBSTEP2_LINEAR_BF16,
           SUBSTEP1_FULLF, SUBSTEP2_FULLF, SUBSTEP1_RECOMPUTE, SUBSTEP2_RECOMPUTE,
           SUBSTEP1_RECOMPUTE_BF16, SUBSTEP2_RECOMPUTE_BF16)

# layouts: the int is enum Layout of csrc/substep_kernels.cu
NONLINEAR, LINEAR, FULLF, RECOMPUTE = "nonlinear", "linear", "fullf", "recompute"
_LAYOUT_IDS = {NONLINEAR: 0, LINEAR: 1, FULLF: 2, RECOMPUTE: 3}

# (arithmetic dtype, storage dtype of p and w1) -> C suffix
_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.float64, torch.float64): "f64",
           (torch.float32, torch.bfloat16): "f32_bf16"}
# (layout, bf16 storage) -> counters of substep 1 and 2
_COUNTERS = {
    (NONLINEAR, False): (SUBSTEP1, SUBSTEP2),
    (NONLINEAR, True): (SUBSTEP1_BF16, SUBSTEP2_BF16),
    (LINEAR, False): (SUBSTEP1_LINEAR, SUBSTEP2_LINEAR),
    (LINEAR, True): (SUBSTEP1_LINEAR_BF16, SUBSTEP2_LINEAR_BF16),
    (FULLF, False): (SUBSTEP1_FULLF, SUBSTEP2_FULLF),
    (RECOMPUTE, False): (SUBSTEP1_RECOMPUTE, SUBSTEP2_RECOMPUTE),
    (RECOMPUTE, True): (SUBSTEP1_RECOMPUTE_BF16, SUBSTEP2_RECOMPUTE_BF16),
}

# each species' constants after kform, in the order of SubstepParams' sp_*
# arrays and of a row of the species table (kSpeciesFields = 1 + 9)
_SPECIES_FIELDS = ("dtqm_half", "dtqm_full", "charge", "k_v0", "k_iv", "k_ivb",
                   "k_half_iv", "k_half_ivb", "k_log_ratio")
SPECIES_FIELDS = 1 + len(_SPECIES_FIELDS)


class SubstepParams(ctypes.Structure):
    """Host constants of one run; mirrors struct HostParams in
    csrc/substep_math.cuh field by field."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("nmode", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("modes", ctypes.c_int * MAX_MODES),
        ("cdm1", ctypes.c_double * MAX_MODES),
        ("sd", ctypes.c_double * MAX_MODES),
        *[(name, ctypes.c_double) for name in ("lx", "inv_lx", "nx_over_lx", "dt_half", "dt")],
        ("nspecies", ctypes.c_int),
        ("sp_kform", ctypes.c_int * MAX_SPECIES),
        *[(f"sp_{name}", ctypes.c_double * MAX_SPECIES) for name in _SPECIES_FIELDS],
    ]


def layout(cfg: Config, stream_v1: bool | None = None) -> str:
    """The kernel layout of a config: which streams the substeps update and
    stream.  stream_v1 chooses between the two nonlinear delta-f layouts
    (True streams v1, False rebuilds it, as pallas_kernels.FusedStepper's
    flag); None takes the one measured faster on the H100 for the config
    (rebuilds_v1_faster).  The other layouts ignore it."""
    if not cfg.deltaf:
        return FULLF
    if cfg.linear:
        return LINEAR
    if stream_v1 is None:
        stream_v1 = not rebuilds_v1_faster(cfg)
    return NONLINEAR if stream_v1 else RECOMPUTE


# markers (all species) above which rebuilding v1 is faster in the 1-mode
# bin and the grid bin
REBUILD_V1_MIN_MARKERS = 2**20


def rebuilds_v1_faster(cfg: Config) -> bool:
    """Whether nonlinear delta-f runs faster with substep 2 rebuilding v1
    than with v1 streamed, on the H100 (PERF.md, both layouts in turns):
    above REBUILD_V1_MIN_MARKERS markers with one kept mode, where the two
    streams it saves dominate (0.85-0.94x the streamed graph step, one
    species or the species loop, f32 and bf16), and with more than 4, where
    the grid bin rebuilds v1 from a second E grid in shared memory for two
    shared-memory reads a marker.  With 2 to 4 modes the 4-mode bin's extra
    per-mode gather costs more than the streams (1.02-1.06x), and at 1M
    markers or fewer the steps are launch-bound and equal within 2%."""
    return (cfg.nmode >= 1 and mode_bin(cfg.nmode) != 4
            and cfg.nspecies * cfg.nparticle_max > REBUILD_V1_MIN_MARKERS)


def _drive_constants(cfg: Config) -> list[dict]:
    """-f0'/f0 folded on the host for each species, as
    pallas_kernels._minus_dlnf0_dv_fast folds it (csrc/substep_math.cuh's
    minus_dlnf0_dv reads kform and the k_* constants)."""
    sps = cfg.species
    vth2 = [s.temperature / s.mass for s in sps]
    inv = [1.0 / t for t in vth2]
    eq = cfg.equilibrium
    if eq == Equilibrium.MAXWELLIAN:
        return [dict(kform=0, k_v0=s.v0, k_iv=iv) for s, iv in zip(sps, inv)]
    if eq == Equilibrium.TWO_STREAM1:
        return [dict(kform=2) for _ in sps]
    if eq == Equilibrium.TWO_STREAM2:
        return [dict(kform=3, k_v0=s.v0, k_iv=iv, k_ivb=2.0 * s.v0 * iv)
                for s, iv in zip(sps, inv)]
    vth2b = [s.temperature2 / s.mass for s in sps]
    c_core = [s.density / math.sqrt(t) for s, t in zip(sps, vth2)]
    c_beam = [(1.0 - s.density) / math.sqrt(tb) if tb > 0.0 else 0.0
              for s, tb in zip(sps, vth2b)]
    if all(cb <= 0.0 for cb in c_beam):                  # pure cores
        return [dict(kform=0, k_v0=0.0, k_iv=iv) for iv in inv]
    if all(cc <= 0.0 for cc in c_core):                  # pure beams
        return [dict(kform=0, k_v0=s.v0, k_iv=1.0 / tb) for s, tb in zip(sps, vth2b)]
    # the ratio form for every species; a degenerate species in a mixed set
    # gets the live component's width and a log_ratio of -+1e4, which the
    # +-60 clamp turns into r = e^-+60
    out = []
    for s, iv, tb, cc, cb in zip(sps, inv, vth2b, c_core, c_beam):
        safe_iv = iv if cc > 0.0 else 1.0 / tb
        safe_ivb = 1.0 / tb if cb > 0.0 else safe_iv
        log_ratio = (math.log(cb) - math.log(cc) if (cb > 0.0 and cc > 0.0)
                     else (-1e4 if cb <= 0.0 else 1e4))
        out.append(dict(kform=1, k_v0=s.v0, k_iv=safe_iv, k_ivb=safe_ivb,
                        k_half_iv=0.5 * safe_iv, k_half_ivb=0.5 * safe_ivb,
                        k_log_ratio=log_ratio))
    return out


def species_constants(cfg: Config) -> list[dict]:
    """Each species' kernel constants in double, as the kernels read them:
    kform and the k_* constants of its -f0'/f0 form, dt q/m at half and
    full dt, and its charge."""
    return [dict(drive, dtqm_half=0.5 * cfg.dt * (sp.charge / sp.mass),
                 dtqm_full=cfg.dt * (sp.charge / sp.mass), charge=sp.charge)
            for sp, drive in zip(cfg.species, _drive_constants(cfg))]


def mode_constants(cfg: Config) -> tuple[list[float], list[float]]:
    """cos(2 pi m / nx) - 1 and sin(2 pi m / nx) of each kept mode m, in
    double: the hat fold's constants (hat_mode)."""
    steps = [2.0 * math.pi * m / cfg.nx for m in cfg.modes]
    return [math.cos(a) - 1.0 for a in steps], [math.sin(a) for a in steps]


def kernel_params(cfg: Config) -> SubstepParams:
    """The kernels' constants for cfg (n is set per launch): the first
    MAX_MODES modes and MAX_SPECIES species (species_table holds them all);
    NotImplementedError for a config no kernel serves."""
    why = []
    if cfg.dtype not in ("float32", "float64"):
        why.append(f"dtype {cfg.dtype}")
    if cfg.bf16_weights and not cfg.deltaf:
        why.append("bf16_weights with full-f")
    if cfg.nmode < 1:
        why.append("no kept mode")
    if any(m < 1 or m * cfg.nx >= 2**31 for m in cfg.modes):
        why.append(f"modes {cfg.modes} with nx {cfg.nx}")
    if cfg.nspecies > MAX_GRID_SPECIES:
        why.append(f"{cfg.nspecies} species (at most {MAX_GRID_SPECIES})")
    if why:
        raise NotImplementedError("no CUDA substep kernel for this config: "
                                  + "; ".join(why))
    prm = SubstepParams()
    prm.nmode, prm.nx = cfg.nmode, cfg.nx
    cdm1, sd = mode_constants(cfg)
    for j, m in enumerate(cfg.modes[:MAX_MODES]):
        prm.modes[j], prm.cdm1[j], prm.sd[j] = m, cdm1[j], sd[j]
    prm.lx, prm.inv_lx, prm.nx_over_lx = cfg.lx, 1.0 / cfg.lx, cfg.nx / cfg.lx
    prm.dt_half, prm.dt = 0.5 * cfg.dt, cfg.dt
    prm.nspecies = cfg.nspecies
    for i, consts in enumerate(species_constants(cfg)[:MAX_SPECIES]):
        prm.sp_kform[i] = consts["kform"]
        for name in _SPECIES_FIELDS:
            getattr(prm, f"sp_{name}")[i] = consts.get(name, 0.0)
    return prm


def species_table(cfg: Config, dtype: torch.dtype, device) -> torch.Tensor:
    """(nspecies, SPECIES_FIELDS): each species' kform and constants
    (species_constants) rounded once to dtype, as Params<T> rounds the
    parameters; the kernels read the rows of species MAX_SPECIES and above."""
    rows = [[c["kform"], *(c.get(name, 0.0) for name in _SPECIES_FIELDS)]
            for c in species_constants(cfg)]
    return torch.tensor(rows, dtype=torch.float64).to(device=device, dtype=dtype)


_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        _lib = bind(nvcc.load(SOURCE).lib)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Check a build of csrc/substep_kernels.cu against this module's
    mirrors of its constants and declare its C signatures."""
    if lib.pic1dp_params_size() != ctypes.sizeof(SubstepParams):
        raise RuntimeError(f"SubstepParams does not match HostParams in {_SRC}")
    if lib.pic1dp_max_modes() != MAX_MODES:
        raise RuntimeError("MAX_MODES does not match kMaxModes")
    if lib.pic1dp_max_species() != MAX_SPECIES:
        raise RuntimeError("MAX_SPECIES does not match kMaxSpecies")
    if lib.pic1dp_species_fields() != SPECIES_FIELDS:
        raise RuntimeError("SPECIES_FIELDS does not match kSpeciesFields")
    if lib.pic1dp_angle_smem_max() != ANGLE_SMEM_MAX:
        raise RuntimeError("ANGLE_SMEM_MAX does not match kAngleSmemMax")
    if any(lib.pic1dp_vector_width(m, b) != vector_width(m, b)
           for m in range(1, 4 * MAX_MODES + 1) for b in (4, 8)):
        raise RuntimeError("vector_width does not match vec_width")
    if any(lib.pic1dp_mode_bin(m) != mode_bin(m) for m in range(1, 4 * MAX_MODES + 1)):
        raise RuntimeError("mode_bin does not match the C mode_bin")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pic1dp_grid_smem.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    if lib.pic1dp_grid_smem_max() != GRID_SMEM_MAX or any(
            _c_grid_smem(lib, nx, b, e) != grid_smem(nx, b, e)
            for nx in (*range(1, 20000, 37), 2**16)
            for b in (4, 8) for e in (1, 2)):
        raise RuntimeError("grid_smem does not match the C grid_smem")
    prm = ctypes.POINTER(SubstepParams)
    for suffix in _SUFFIX.values():
        getattr(lib, f"pic1dp_substep1_{suffix}").argtypes = \
            [prm, i32] + [ptr] * 16 + [i32, i32, i32, ptr]
        getattr(lib, f"pic1dp_substep2_{suffix}").argtypes = \
            [prm, i32] + [ptr] * 18 + [i32, i32, i32, ptr]
    lib.pic1dp_grid_angle_f32.argtypes = [ptr, i32, i64, ptr, ptr, ptr]
    for suffix in ("f32", "f64"):
        getattr(lib, f"pic1dp_angle_gather_{suffix}").argtypes = [ptr, i32, ptr, i64, ptr, ptr]
    lib.pic1dp_error_string.argtypes = [i32]
    lib.pic1dp_error_string.restype = ctypes.c_char_p
    return lib


def _c_grid_smem(lib, nx: int, itemsize: int, egrids: int) -> tuple[int, int]:
    copies = ctypes.c_int(0)
    nbytes = lib.pic1dp_grid_smem(nx, itemsize, egrids, ctypes.byref(copies))
    return nbytes, copies.value


def mode_bin(nmode: int) -> int:
    """The kernels' bin of nmode kept modes (mode_bin in
    csrc/substep_kernels.cu): the register bins 1 and 4, GRID_BIN above 4."""
    if nmode < 1:
        raise ValueError(f"no kept mode: {nmode}")
    return 1 if nmode == 1 else 4 if nmode <= 4 else GRID_BIN


def vector_width(nmode: int, itemsize: int) -> int:
    """Markers per thread and iteration of the kernel that runs nmode kept
    modes with arithmetic of `itemsize` bytes: one 16-byte load per stream,
    4 in float and 2 in double, in every bin (vec_width in
    csrc/substep_kernels.cu)."""
    return 16 // itemsize


def grid_egrids(substep: int) -> int:
    """E grids a grid-bin kernel has room for: substep 2 forms a second one
    where it rebuilds v1 from the step-start modes (full-f, recompute) and
    keeps the room in every layout, so that both nonlinear delta-f layouts
    share charge grids and grid, and so their bits (egrids in
    csrc/substep_kernels.cu)."""
    return 2 if substep == 2 else 1


@functools.lru_cache(maxsize=None)
def grid_smem(nx: int, itemsize: int, egrids: int) -> tuple[int, int]:
    """(bytes, copies) of the grid bin's dynamic shared memory: `egrids` E
    grids of nx + 1 values of `itemsize` bytes and `copies` charge grids of
    2 nx values (a marker's two hat halves, at its cell), the most copies of
    GRID_COPIES (one per warp), 4, 2, 1 that fit in GRID_SMEM_MAX; (0, 1)
    when not even one fits, and the block's grids then lie in a device
    buffer (grid_smem in csrc/substep_kernels.cu)."""
    copies = GRID_COPIES
    while copies >= 1:
        nbytes = (egrids * (nx + 1) + copies * 2 * nx) * itemsize
        if nbytes <= GRID_SMEM_MAX:
            return nbytes, copies
        copies //= 2
    return 0, 1


@functools.lru_cache(maxsize=None)
def grid_blocks_per_sm(nx: int, itemsize: int, egrids: int,
                       blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks per SM of a grid-bin launch: blocks_per_sm, or fewer where
    that many blocks' shared memory (grid_smem, the static arrays, the
    driver's reserve) does not fit in an SM, so that the grid is one wave
    of resident blocks (at nx 1024 in f32, 3 blocks of 72 KB)."""
    dynamic = grid_smem(nx, itemsize, egrids)[0]
    per_block = dynamic + 2 * THREADS * itemsize + 128 + BLOCK_SMEM_RESERVED
    return max(1, min(blocks_per_sm, SM_SMEM // per_block))


def launch_grid(markers: int, vec: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of a launch over `markers` markers (all species) at `vec`
    markers per thread and iteration: enough for one iteration per thread,
    at most blocks_per_sm per SM.  A pure function of its arguments, so a
    shape gets one grid on one card, and the order of the projection sum,
    which follows the grid, is the same from run to run."""
    return max(1, min(blocks_per_sm * sms, -(-markers // (THREADS * vec))))


def species_grid(nspecies: int, n: int, vec: int, sms: int,
                 blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of a species-loop launch over nspecies species of n markers:
    nspecies runs of bps blocks, each run walking one species alone (the
    kernels launch them as a (bps, nspecies) grid), with bps enough for one
    iteration per thread over a species, at most blocks_per_sm * sms //
    nspecies, and at least 1.  So every block has markers at any species
    count, and at one species it is launch_grid's grid.  A pure function of
    its arguments, as launch_grid."""
    bps = max(1, min(blocks_per_sm * sms // nspecies, -(-n // (THREADS * vec))))
    return nspecies * bps


def angle_table(cfg: Config, dtype: torch.dtype, device) -> torch.Tensor:
    """The kernels' grid-angle table, (nmode, nx, 2): (cos, sin) of
    2 pi (m_j ix mod nx) / nx for each kept mode m_j and cell ix, the angle
    reduced in integers and evaluated in float64, then rounded once to
    dtype.  Its storage is padded with zeros to a multiple of 16 bytes, so
    that the kernels can copy it whole with one bulk copy."""
    k = (np.asarray(cfg.modes, dtype=np.int64)[:, None] * np.arange(cfg.nx)) % cfg.nx
    theta = 2.0 * np.pi * k / cfg.nx
    table = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    host = torch.from_numpy(table.astype({torch.float32: np.float32,
                                          torch.float64: np.float64}[dtype]))
    per16 = 16 // host.element_size()
    flat = torch.zeros(-(-host.numel() // per16) * per16, dtype=dtype, device=device)
    flat[:host.numel()] = host.reshape(-1).to(device)
    return flat[:host.numel()].view(host.shape)


def angle_smem_bytes(nmode: int, nx: int, itemsize: int) -> int:
    """Bytes of the angle table a launch copies into shared memory: the
    table padded to 16 bytes if that fits in ANGLE_SMEM_MAX, else 0 (the
    kernels read it from device memory)."""
    nbytes = -(-nmode * nx * 2 * itemsize // 16) * 16
    return nbytes if nbytes <= ANGLE_SMEM_MAX else 0


def angle_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries idx of a CUDA angle table (flat indices j * nx + ix) as the
    substep kernels read them, staged into shared memory where they would
    stage it: (len(idx), 2) (checks only)."""
    if (table.device.type != "cuda" or idx.device != table.device
            or idx.dtype != torch.int32 or not idx.is_contiguous()):
        raise ValueError("angle_gather takes a CUDA table and contiguous int32 "
                         "indices on its device")
    out = torch.empty((idx.numel(), 2), dtype=table.dtype, device=table.device)
    lib = library()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[table.dtype]
    smem = angle_smem_bytes(table.shape[0], table.shape[1], table.element_size())
    rc = getattr(lib, f"pic1dp_angle_gather_{suffix}")(
        table.data_ptr(), smem, idx.data_ptr(), idx.numel(), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.pic1dp_error_string(rc).decode())
    return out


def grid_angle_f32(k: torch.Tensor, nx: int):
    """(cos, sin) of 2 pi k / nx for int32 k on the card, by the kernels' own
    trig (accuracy checks only)."""
    if k.device.type != "cuda" or k.dtype != torch.int32 or not k.is_contiguous():
        raise ValueError("grid_angle_f32 takes a contiguous int32 CUDA tensor")
    c = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    s = torch.empty_like(c)
    lib = library()
    rc = lib.pic1dp_grid_angle_f32(
        k.data_ptr(), nx, k.numel(), c.data_ptr(), s.data_ptr(),
        torch.cuda.current_stream(k.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.pic1dp_error_string(rc).decode())
    return c, s


class FusedSubsteps:
    """Both substeps of one Config: kernels, plain versions and dispatch.

    `sp` holds the species parameters at the state's dtype and device, for
    the plain versions; the kernels' angle table and counters (one int per
    substep, 0 between launches) are made once on the same device, outside
    any CUDA graph capture, and a launch refuses streams on another device;
    so is the species table.  stream_v1 picks the nonlinear
    delta-f layout: v1 streamed from substep 1 to substep 2 (True) or
    rebuilt by substep 2 (False, RECOMPUTE), by default the config's own
    (layout); the other layouts ignore it.  Streams a layout does not write come back as None from
    substep 1 and are ignored by substep 2 (full-f takes no w1 or v1, linear
    and recompute no v1); substep 2 takes the step-start modes as well where
    it rebuilds v1 from them (full-f and recompute).  g, (nmode,) at
    cfg.dtype on the species parameters' device, is grad_inv / lx, the
    factor of the mode solve (spectral.solve_modes) that solve=True asks of
    either substep and that Stepper._solve reads.  blocks_per_sm caps the
    grid (species_grid); grid_bin set takes the grid bin at any nmode (the
    probe of the bin line; a run leaves it False)."""

    def __init__(self, cfg: Config, sp: dist.SpeciesParams, stream_v1: bool | None = None):
        self.cfg = cfg
        self.sp = sp
        self.q_over_m = sp.charge / sp.mass
        self.layout = layout(cfg, stream_v1)
        self.has_v = self.layout != LINEAR
        self.has_w = self.layout != FULLF
        # substep 2 rebuilds v1 from the step-start modes
        self.rebuilds_v1 = self.layout in (FULLF, RECOMPUTE)
        # what each kernel takes, per stream: p and w1 at cfg.p_dtype, the
        # other streams and the modes at cfg.dtype
        dtype, narrow = getattr(torch, cfg.dtype), getattr(torch, cfg.p_dtype)
        self._dtypes = dict(x=dtype, v=dtype, p=narrow, w=dtype, w1=narrow, v1=dtype)
        self._suffix = _SUFFIX.get((dtype, narrow))
        # the launch counters of this config's substep 1 and 2 kernels
        self.counters = _COUNTERS.get((self.layout, narrow != dtype))
        try:
            self._params, self._unsupported = kernel_params(cfg), None
        except NotImplementedError as exc:
            # raised again at the first CUDA launch; CPU runs need no kernel
            self._params, self._unsupported = None, exc
        self.blocks_per_sm = BLOCKS_PER_SM
        self.grid_bin = False
        self._many_modes = cfg.nmode >= 1 and mode_bin(cfg.nmode) == GRID_BIN
        # torch's own division on the device (on a CUDA tensor a product with
        # the scalar's reciprocal, which may differ from a division in the
        # last bit): the kernels read g and never divide
        self.g = spectral_ops.inverse_gradient(cfg.modes, cfg.lx, dtype,
                                               sp.charge.device) / cfg.lx
        self.angles = self._done = self.species = None
        if self._unsupported is None:
            device = sp.charge.device
            self.angles = angle_table(cfg, dtype, device)
            self.species = species_table(cfg, dtype, device)
            self._done = torch.zeros(2, dtype=torch.int32, device=device)
            self._vec = vector_width(cfg.nmode, self.angles.element_size())
            self._angle_smem = angle_smem_bytes(cfg.nmode, cfg.nx, self.angles.element_size())

    # ---- plain versions ----

    def _push(self, x0, v0, p, w0, v_at, w_at, e, dt_eff: float):
        """The reference's update order from the step-start values x0, v0,
        w0 with the fields at the current substep: x, then w, then v
        (src/pic1dp_interaction.F90:238-339; JAX Stepper._push_math): linear
        freezes v and drives w with p E, full-f leaves w alone.  p and w_at
        may be stored narrower (bfloat16); they are upcast to the arithmetic
        dtype first."""
        cfg = self.cfg
        x_new = wrap_x(x0 + dt_eff * v_at, cfg.lx)
        w_new = w0
        if self.has_w:
            p, w_at = p.to(w0.dtype), w_at.to(w0.dtype)
            drive = p * e if cfg.linear else (p - w_at) * e
            kern = dist.minus_dlnf0_dv(cfg.equilibrium, self.sp, v_at)
            w_new = w0 + dt_eff * drive * kern * self.q_over_m
        v_new = v0 + dt_eff * e * self.q_over_m if self.has_v else v0
        return x_new, v_new, w_new

    def _project(self, x, val):
        return project_modes(mode_trig(x, self.cfg.lx, self.cfg.nx, self.cfg.modes),
                             val * self.sp.charge)

    def _deposit_val(self, p, w):
        """What a marker deposits: w in delta-f, p in full-f."""
        return w if self.has_w else p.to(w.dtype)

    def _efield(self, x, mode_re, mode_im):
        cfg = self.cfg
        return efield_at(mode_trig(x, cfg.lx, cfg.nx, cfg.modes), mode_re, mode_im)

    def substep1_plain(self, x, v, p, w, mode_re, mode_im, solve: bool = False):
        """(x0, v0, p, w0) + step-start modes -> (w1, v1, (p_c, p_s)), and
        with solve the midpoint modes (mode_re, mode_im) of those
        projections last.  w1 is returned at p's storage dtype (rounded to
        nearest even under bf16_weights); the projections deposit it
        unrounded.  w1 is None in full-f and v1 None outside the streamed
        nonlinear delta-f layout."""
        x1, v1, w1 = self._push(x, v, p, w, v, w, self._efield(x, mode_re, mode_im),
                                0.5 * self.cfg.dt)
        proj = self._project(x1, self._deposit_val(p, w1))
        return (w1.to(p.dtype) if self.has_w else None,
                v1 if self.layout == NONLINEAR else None, proj) + self._solved(proj, solve)

    def substep2_plain(self, x, v, p, w, w1, v1, mode_re1, mode_im1,
                       mode_re0=None, mode_im0=None, solve: bool = False):
        """(x0, v0, p, w0, w1, v1) + midpoint modes (and, where v1 is
        rebuilt, the step-start modes) -> (x2, v2, w2, (p_c, p_s)), and with
        solve the step's modes of those projections last; x2, v2, w2 are x,
        v, w updated in place where the layout updates them.  p and w1 are at
        p's storage dtype.  The rebuilt v1 is substep1_plain's expression on
        the same values, so the same bits."""
        cfg = self.cfg
        if self.rebuilds_v1:
            self._need_step_start_modes(mode_re0, mode_im0)
            v_mid = v + 0.5 * cfg.dt * self._efield(x, mode_re0, mode_im0) * self.q_over_m
        else:
            v_mid = v1 if self.layout == NONLINEAR else v
        x1 = wrap_x(x + 0.5 * cfg.dt * v, cfg.lx)
        e1 = self._efield(x1, mode_re1, mode_im1)
        x2, v2, w2 = self._push(x, v, p, w, v_mid, w1, e1, cfg.dt)
        proj = self._project(x2, self._deposit_val(p, w2))
        x.copy_(x2)
        if self.has_v:
            v.copy_(v2)
        if self.has_w:
            w.copy_(w2)
        return (x, v, w, proj) + self._solved(proj, solve)

    def _solved(self, proj, solve: bool) -> tuple:
        """((mode_re, mode_im),) of the projections where solve is set, else
        ()."""
        return (spectral_ops.solve_modes(*proj, self.g),) if solve else ()

    def _need_step_start_modes(self, mode_re0, mode_im0):
        if mode_re0 is None or mode_im0 is None:
            raise ValueError(f"{self.layout} substep 2 rebuilds v1 from the step-start "
                             "modes: pass mode_re0 and mode_im0")

    # ---- dispatch ----

    def substep1(self, x, v, p, w, mode_re, mode_im, solve: bool = False):
        if x.device.type == "cpu":
            return self.substep1_plain(x, v, p, w, mode_re, mode_im, solve)
        prm, lib, grid = self._prepare(dict(x=x, v=v, p=p, w=w), (mode_re, mode_im), 1)
        w1 = torch.empty_like(w, dtype=p.dtype) if self.has_w else None
        v1 = torch.empty_like(v) if self.layout == NONLINEAR else None
        sums = self._sums(x, grid)
        rc = getattr(lib, f"pic1dp_substep1_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, mode_re, mode_im, self.species, self._grids(x, grid, 1),
                       w1, v1, sums, sums[grid], self.g, sums[grid + 1] if solve else None,
                       self._done[0], self.angles),
            self._angle_smem, grid, int(self.grid_bin),
            torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[0].launched(rc, lib)
        return (w1, v1, (sums[grid, 0], sums[grid, 1])) + self._kernel_modes(sums, grid, solve)

    def substep2(self, x, v, p, w, w1, v1, mode_re1, mode_im1, mode_re0=None, mode_im0=None,
                 solve: bool = False):
        if x.device.type == "cpu":
            return self.substep2_plain(x, v, p, w, w1, v1, mode_re1, mode_im1,
                                       mode_re0, mode_im0, solve)
        streams = dict(x=x, v=v, p=p, w=w)
        modes = (mode_re1, mode_im1)
        if self.has_w:
            streams["w1"] = w1
        if self.layout == NONLINEAR:
            streams["v1"] = v1
        if self.rebuilds_v1:
            self._need_step_start_modes(mode_re0, mode_im0)
            modes += (mode_re0, mode_im0)
        prm, lib, grid = self._prepare(streams, modes, 2)
        sums = self._sums(x, grid)
        start = (mode_re0, mode_im0) if self.rebuilds_v1 else (None, None)
        rc = getattr(lib, f"pic1dp_substep2_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, streams.get("w1"), streams.get("v1"), mode_re1, mode_im1,
                       *start, self.species, self._grids(x, grid, 2), sums, sums[grid],
                       self.g, sums[grid + 1] if solve else None, self._done[1], self.angles),
            self._angle_smem, grid, int(self.grid_bin),
            torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[1].launched(rc, lib)
        return (x, v, w, (sums[grid, 0], sums[grid, 1])) + self._kernel_modes(sums, grid, solve)

    def _sums(self, x, grid: int):
        """One buffer of grid + 2 rows of (2, nmode): the blocks' partial
        sums, then the projections and the modes (mode_re, mode_im) the last
        block writes.  A launch reads no row of it, so the modes never alias
        a launch's input."""
        return torch.empty((grid + 2, 2, self.cfg.nmode), dtype=x.dtype, device=x.device)

    @staticmethod
    def _kernel_modes(sums, grid: int, solve: bool) -> tuple:
        """((mode_re, mode_im),) of the sums buffer's last row where the
        launch solved, else ()."""
        return ((sums[grid + 1, 0], sums[grid + 1, 1]),) if solve else ()

    def uses_grid_bin(self) -> bool:
        """Whether the kernels run the grid bin (above 4 kept modes, or
        grid_bin set)."""
        return self.grid_bin or self._many_modes

    def _grids(self, x, grid: int, substep: int):
        """The grid bin's device buffer, (grid, egrids (nx + 1) + 2 nx)
        values, where its grids do not fit in shared memory (grid_smem);
        else None."""
        egrids = grid_egrids(substep)
        if not self.uses_grid_bin() or grid_smem(self.cfg.nx, x.element_size(), egrids)[0]:
            return None
        return torch.empty((grid, egrids * (self.cfg.nx + 1) + 2 * self.cfg.nx),
                           dtype=x.dtype, device=x.device)

    def check_scratch(self, device: torch.device) -> None:
        """Refuse a launch on `device` unless the angle and species tables
        and the counters lie there."""
        for name, t in (("angle table", self.angles), ("counters", self._done),
                        ("species table", self.species)):
            if t.device != device:
                raise ValueError(f"the substep kernels' {name} lies on {t.device}, the "
                                 f"streams on {device}: build FusedSubsteps with species "
                                 f"parameters on the streams' device")

    def _prepare(self, streams: dict, modes, substep: int):
        """Check what the kernel is given; return its constants (n set to
        the markers per species), the library and the grid of substep
        `substep`."""
        x = streams["x"]
        if self._unsupported is not None:
            raise NotImplementedError(str(self._unsupported))
        checks = [(t, self._dtypes[k]) for k, t in streams.items()]
        checks += [(t, self._dtypes["x"]) for t in modes]
        for t, d in checks:
            if t.device != x.device or t.dtype != d or not t.is_contiguous():
                raise ValueError(
                    f"substep kernel streams are contiguous, on one device, with "
                    f"x, v, w, v1 and the modes at {self.cfg.dtype} and p, w1 at "
                    f"{self.cfg.p_dtype}; got {t.dtype} on {t.device} "
                    f"(contiguous: {t.is_contiguous()})")
        shape = (self.cfg.nspecies, x.shape[-1])
        if any(tuple(t.shape) != shape for t in streams.values()):
            raise ValueError(f"particle streams must all be {shape}")
        if any(tuple(t.shape) != (self.cfg.nmode,) for t in modes):
            raise ValueError(f"mode components must be ({self.cfg.nmode},)")
        if x.device.type != "cuda":
            raise ValueError(f"no substep kernel for device {x.device}")
        self.check_scratch(x.device)
        self._params.n = x.shape[-1]
        grid = self.grid_size(x.numel(), nvcc.sm_count(x.device), x.element_size(), substep)
        return self._params, library(), grid

    def grid_size(self, markers: int, sms: int, itemsize: int, substep: int) -> int:
        """Blocks of a launch of substep `substep` over `markers` markers
        (all species) on a card of `sms` SMs: species_grid with
        blocks_per_sm (at one species launch_grid's grid, which the main
        path's kernel takes), capped in the grid bin at the blocks whose
        shared memory fits in an SM (grid_blocks_per_sm)."""
        b = self.blocks_per_sm
        if self.uses_grid_bin():
            b = grid_blocks_per_sm(self.cfg.nx, itemsize, grid_egrids(substep), b)
        ns = self.cfg.nspecies
        return species_grid(ns, markers // ns, self._vec, sms, b)


def _pointers(*tensors):
    """Device addresses for the C entry points; None for a stream the
    layout does not touch."""
    return [None if t is None else t.data_ptr() for t in tensors]
