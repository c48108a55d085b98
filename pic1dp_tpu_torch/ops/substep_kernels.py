"""The two fused RK2 substeps of the matrix-free spectral step.

Port of the TPU kernel of pic1dp_tpu/ops/pallas_kernels.py
(make_substep_call, wrapped by FusedStepper.substep1/2) with separate
streams, in each of its layouts (pallas_kernels.py:499-508):

    nonlinear delta-f (stream_v1):
      substep 1:  read x0, v0, p, w0            write w1, v1
      substep 2:  read x0, v0, p, w0, w1, v1    write x2, v2, w2 over x0, v0, w0
    linear delta-f (v frozen, drive p E):
      substep 1:  read x0, v0, p, w0            write w1
      substep 2:  read x0, v0, p, w0, w1        write x2, w2 over x0, w0
    full-f (w unused, deposit p; substep 2 rebuilds v1 from the step-start
    modes):
      substep 1:  read x0, v0, p                write nothing
      substep 2:  read x0, v0, p                write x2, v2 over x0, v0

each also returning the (2, nmode) mode projections of charge * (w | p) at
the pushed positions, summed over species.  Every stream is at the config's
dtype, except under bf16_weights (delta-f only): there p and w1 are bfloat16
(cfg.p_dtype), upcast for the arithmetic, and w1 is rounded to bfloat16 by
round-to-nearest-even after substep 1 has deposited it unrounded
(pallas_kernels.py:555, :565-567, :586, :610).  For each substep this module
holds

  * the CUDA kernels of csrc/substep_kernels.cu, built by nvcc at first use
    and bound through ctypes: one body per substep for every layout, up to
    MAX_SPECIES species and every equilibrium (the C side picks the main
    path's instantiation for one bump-on-tail or Maxwellian species in
    nonlinear delta-f, the species loop otherwise); one launch counter per
    layout and build (KERNELS).  What they take beside the streams is made
    here: the grid-angle table (angle_table, staged into shared memory when
    it fits, angle_smem_bytes), the grid (launch_grid: vector_width markers
    per thread and iteration, at most BLOCKS_PER_SM blocks per SM), and the
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
import math

import numpy as np
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, Equilibrium
from pic1dp_tpu_torch.ops.interp import wrap_x
from pic1dp_tpu_torch.ops.spectral import efield_at, mode_trig, project_modes
from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

MAX_MODES = 16          # kMaxModes in csrc/substep_math.cuh
MAX_SPECIES = 8         # kMaxSpecies in csrc/substep_math.cuh
THREADS = 256           # kThreads in csrc/substep_kernels.cu
# kAngleSmemMax in csrc/substep_kernels.cu: the 48 KB a launch gets without
# an opt-in, less 4 KB kept for the kernels' static shared memory
ANGLE_SMEM_MAX = 48 * 1024 - 4096
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
KERNELS = (SUBSTEP1, SUBSTEP2, SUBSTEP1_BF16, SUBSTEP2_BF16,
           SUBSTEP1_LINEAR, SUBSTEP2_LINEAR, SUBSTEP1_LINEAR_BF16, SUBSTEP2_LINEAR_BF16,
           SUBSTEP1_FULLF, SUBSTEP2_FULLF)

# layouts: the int is enum Layout of csrc/substep_kernels.cu
NONLINEAR, LINEAR, FULLF = "nonlinear", "linear", "fullf"
_LAYOUT_IDS = {NONLINEAR: 0, LINEAR: 1, FULLF: 2}

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
}

_SPECIES_FIELDS = ("dtqm_half", "dtqm_full", "charge", "k_v0", "k_iv", "k_ivb",
                   "k_half_iv", "k_half_ivb", "k_log_ratio")


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


def layout(cfg: Config) -> str:
    """The kernel layout of a config: which streams the substeps update."""
    if not cfg.deltaf:
        return FULLF
    return LINEAR if cfg.linear else NONLINEAR


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


def kernel_params(cfg: Config) -> SubstepParams:
    """The kernels' constants for cfg (n is set per launch), or
    NotImplementedError for a variant outside the kernels' set."""
    why = []
    if cfg.nspecies > MAX_SPECIES:
        why.append(f"{cfg.nspecies} species (at most {MAX_SPECIES})")
    if cfg.dtype not in ("float32", "float64"):
        why.append(f"dtype {cfg.dtype}")
    if cfg.bf16_weights and not cfg.deltaf:
        why.append("bf16_weights with full-f")
    if not 1 <= cfg.nmode <= MAX_MODES:
        why.append(f"{cfg.nmode} kept modes (at most {MAX_MODES})")
    if any(m < 1 or m * cfg.nx >= 2**31 for m in cfg.modes):
        why.append(f"modes {cfg.modes} with nx {cfg.nx}")
    if why:
        raise NotImplementedError("no CUDA substep kernel for this config: "
                                  + "; ".join(why))
    prm = SubstepParams()
    prm.nmode, prm.nx = cfg.nmode, cfg.nx
    for j, m in enumerate(cfg.modes):
        step = 2.0 * math.pi * m / cfg.nx
        prm.modes[j], prm.cdm1[j], prm.sd[j] = m, math.cos(step) - 1.0, math.sin(step)
    prm.lx, prm.inv_lx, prm.nx_over_lx = cfg.lx, 1.0 / cfg.lx, cfg.nx / cfg.lx
    prm.dt_half, prm.dt = 0.5 * cfg.dt, cfg.dt
    prm.nspecies = cfg.nspecies
    for i, (sp, drive) in enumerate(zip(cfg.species, _drive_constants(cfg))):
        consts = dict(drive, dtqm_half=0.5 * cfg.dt * (sp.charge / sp.mass),
                      dtqm_full=cfg.dt * (sp.charge / sp.mass), charge=sp.charge)
        prm.sp_kform[i] = consts.pop("kform")
        for name, value in consts.items():
            getattr(prm, f"sp_{name}")[i] = value
    return prm


_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = nvcc.load(SOURCE).lib
        if lib.pic1dp_params_size() != ctypes.sizeof(SubstepParams):
            raise RuntimeError(f"SubstepParams does not match HostParams in {_SRC}")
        if lib.pic1dp_max_modes() != MAX_MODES:
            raise RuntimeError("MAX_MODES does not match kMaxModes")
        if lib.pic1dp_max_species() != MAX_SPECIES:
            raise RuntimeError("MAX_SPECIES does not match kMaxSpecies")
        if lib.pic1dp_angle_smem_max() != ANGLE_SMEM_MAX:
            raise RuntimeError("ANGLE_SMEM_MAX does not match kAngleSmemMax")
        if any(lib.pic1dp_vector_width(m, b) != vector_width(m, b)
               for m in range(1, MAX_MODES + 1) for b in (4, 8)):
            raise RuntimeError("vector_width does not match vec_width")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        prm = ctypes.POINTER(SubstepParams)
        for suffix in _SUFFIX.values():
            getattr(lib, f"pic1dp_substep1_{suffix}").argtypes = \
                [prm, i32] + [ptr] * 12 + [i32, i32, ptr]
            getattr(lib, f"pic1dp_substep2_{suffix}").argtypes = \
                [prm, i32] + [ptr] * 14 + [i32, i32, ptr]
        lib.pic1dp_grid_angle_f32.argtypes = [ptr, i32, i64, ptr, ptr, ptr]
        for suffix in ("f32", "f64"):
            getattr(lib, f"pic1dp_angle_gather_{suffix}").argtypes = [ptr, i32, ptr, i64, ptr, ptr]
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def vector_width(nmode: int, itemsize: int) -> int:
    """Markers per thread and iteration of the kernel that runs nmode kept
    modes with arithmetic of `itemsize` bytes: one 16-byte load per stream
    (4 in float, 2 in double) in the bins of at most 4 modes, 1 in the
    16-mode bin, whose per-mode sums fill the registers (vec_width in
    csrc/substep_kernels.cu)."""
    return 1 if nmode > 4 else 16 // itemsize


def launch_grid(markers: int, vec: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of a launch over `markers` markers (all species) at `vec`
    markers per thread and iteration: enough for one iteration per thread,
    at most blocks_per_sm per SM.  A pure function of its arguments, so a
    shape gets one grid on one card, and the order of the projection sum,
    which follows the grid, is the same from run to run."""
    return max(1, min(blocks_per_sm * sms, -(-markers // (THREADS * vec))))


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
    any CUDA graph capture, and a launch refuses streams on another device.
    Streams a layout does not write come back as None from substep 1 and are
    ignored by substep 2 (full-f takes no w1 or v1, linear no v1); substep 2
    takes the step-start modes as well in full-f, where it rebuilds v1 from
    them.  blocks_per_sm caps the grid (launch_grid)."""

    def __init__(self, cfg: Config, sp: dist.SpeciesParams):
        self.cfg = cfg
        self.sp = sp
        self.q_over_m = sp.charge / sp.mass
        self.layout = layout(cfg)
        self.has_v = self.layout != LINEAR
        self.has_w = self.layout != FULLF
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
        self.angles = self._done = None
        if self._unsupported is None:
            device = sp.charge.device
            self.angles = angle_table(cfg, dtype, device)
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

    def substep1_plain(self, x, v, p, w, mode_re, mode_im):
        """(x0, v0, p, w0) + step-start modes -> (w1, v1, (p_c, p_s)).  w1
        is returned at p's storage dtype (rounded to nearest even under
        bf16_weights); the projections deposit it unrounded.  w1 is None in
        full-f and v1 None outside nonlinear delta-f."""
        e0 = self._efield(x, mode_re, mode_im)
        x1, v1, w1 = self._push(x, v, p, w, v, w, e0, 0.5 * self.cfg.dt)
        proj = self._project(x1, self._deposit_val(p, w1))
        return (w1.to(p.dtype) if self.has_w else None,
                v1 if self.layout == NONLINEAR else None, proj)

    def substep2_plain(self, x, v, p, w, w1, v1, mode_re1, mode_im1,
                       mode_re0=None, mode_im0=None):
        """(x0, v0, p, w0, w1, v1) + midpoint modes (and, in full-f, the
        step-start modes) -> (x2, v2, w2, (p_c, p_s)); x2, v2, w2 are x, v, w
        updated in place where the layout updates them.  p and w1 are at p's
        storage dtype."""
        cfg = self.cfg
        if self.layout == FULLF:
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
        return x, v, w, proj

    @staticmethod
    def _need_step_start_modes(mode_re0, mode_im0):
        if mode_re0 is None or mode_im0 is None:
            raise ValueError("full-f substep 2 rebuilds v1 from the step-start "
                             "modes: pass mode_re0 and mode_im0")

    # ---- dispatch ----

    def substep1(self, x, v, p, w, mode_re, mode_im):
        if x.device.type == "cpu":
            return self.substep1_plain(x, v, p, w, mode_re, mode_im)
        prm, lib, grid = self._prepare(dict(x=x, v=v, p=p, w=w), (mode_re, mode_im))
        w1 = torch.empty_like(w, dtype=p.dtype) if self.has_w else None
        v1 = torch.empty_like(v) if self.layout == NONLINEAR else None
        sums = self._sums(x, grid)
        rc = getattr(lib, f"pic1dp_substep1_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, mode_re, mode_im, w1, v1, sums, sums[grid], self._done[0],
                       self.angles),
            self._angle_smem, grid, torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[0].launched(rc, lib)
        return w1, v1, (sums[grid, 0], sums[grid, 1])

    def substep2(self, x, v, p, w, w1, v1, mode_re1, mode_im1, mode_re0=None, mode_im0=None):
        if x.device.type == "cpu":
            return self.substep2_plain(x, v, p, w, w1, v1, mode_re1, mode_im1,
                                       mode_re0, mode_im0)
        streams = dict(x=x, v=v, p=p, w=w)
        modes = (mode_re1, mode_im1)
        if self.has_w:
            streams["w1"] = w1
        if self.layout == NONLINEAR:
            streams["v1"] = v1
        if self.layout == FULLF:
            self._need_step_start_modes(mode_re0, mode_im0)
            modes += (mode_re0, mode_im0)
        prm, lib, grid = self._prepare(streams, modes)
        sums = self._sums(x, grid)
        full = self.layout == FULLF
        rc = getattr(lib, f"pic1dp_substep2_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, streams.get("w1"), streams.get("v1"), mode_re1, mode_im1,
                       mode_re0 if full else None, mode_im0 if full else None,
                       sums, sums[grid], self._done[1], self.angles),
            self._angle_smem, grid, torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[1].launched(rc, lib)
        return x, v, w, (sums[grid, 0], sums[grid, 1])

    def _sums(self, x, grid: int):
        """One buffer of grid + 1 rows of (2, nmode): the blocks' partial
        sums, then the projections the last block writes."""
        return torch.empty((grid + 1, 2, self.cfg.nmode), dtype=x.dtype, device=x.device)

    def check_scratch(self, device: torch.device) -> None:
        """Refuse a launch on `device` unless the angle table and the
        counters lie there."""
        for name, t in (("angle table", self.angles), ("counters", self._done)):
            if t.device != device:
                raise ValueError(f"the substep kernels' {name} lies on {t.device}, the "
                                 f"streams on {device}: build FusedSubsteps with species "
                                 f"parameters on the streams' device")

    def _prepare(self, streams: dict, modes):
        """Check what the kernel is given; return its constants (n set to
        the markers per species), the library and the grid."""
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
        grid = launch_grid(x.numel(), self._vec, nvcc.sm_count(x.device), self.blocks_per_sm)
        return self._params, library(), grid


def _pointers(*tensors):
    """Device addresses for the C entry points; None for a stream the
    layout does not touch."""
    return [None if t is None else t.data_ptr() for t in tensors]
