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
    layout and build (KERNELS);
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

import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config, Equilibrium
from pic1dp_tpu_torch.ops.interp import wrap_x
from pic1dp_tpu_torch.ops.spectral import efield_at, mode_trig, project_modes
from pic1dp_tpu_torch.utils import nvcc
from pic1dp_tpu_torch.utils.nvcc import CudaKernel

MAX_MODES = 16          # kMaxModes in csrc/substep_math.cuh
MAX_SPECIES = 8         # kMaxSpecies in csrc/substep_math.cuh
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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        prm = ctypes.POINTER(SubstepParams)
        for suffix in _SUFFIX.values():
            getattr(lib, f"pic1dp_substep1_{suffix}").argtypes = [prm, i32] + [ptr] * 9 + [i32, ptr]
            getattr(lib, f"pic1dp_substep2_{suffix}").argtypes = \
                [prm, i32] + [ptr] * 11 + [i32, ptr]
        lib.pic1dp_grid_angle_f32.argtypes = [ptr, i32, i64, ptr, ptr, ptr]
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_grid(device: torch.device) -> int:
    """The fixed grid: 4 blocks per SM.  A fixed grid fixes the order of the
    projection sum, so it is the same from run to run."""
    return 4 * nvcc.sm_count(device)


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
    the plain versions.  Streams a layout does not write come back as None
    from substep 1 and are ignored by substep 2 (full-f takes no w1 or v1,
    linear no v1); substep 2 takes the step-start modes as well in full-f,
    where it rebuilds v1 from them."""

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
        prm, lib = self._prepare(dict(x=x, v=v, p=p, w=w), (mode_re, mode_im))
        w1 = torch.empty_like(w, dtype=p.dtype) if self.has_w else None
        v1 = torch.empty_like(v) if self.layout == NONLINEAR else None
        partials = self._partials(x)
        rc = getattr(lib, f"pic1dp_substep1_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, mode_re, mode_im, w1, v1, partials),
            partials.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[0].launched(rc, lib)
        proj = partials.sum(0)
        return w1, v1, (proj[0], proj[1])

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
        prm, lib = self._prepare(streams, modes)
        partials = self._partials(x)
        full = self.layout == FULLF
        rc = getattr(lib, f"pic1dp_substep2_{self._suffix}")(
            ctypes.byref(prm), _LAYOUT_IDS[self.layout],
            *_pointers(x, v, p, w, streams.get("w1"), streams.get("v1"), mode_re1, mode_im1,
                       partials, mode_re0 if full else None, mode_im0 if full else None),
            partials.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
        self.counters[1].launched(rc, lib)
        proj = partials.sum(0)
        return x, v, w, (proj[0], proj[1])

    def _partials(self, x):
        return torch.empty((launch_grid(x.device), 2, self.cfg.nmode),
                           dtype=x.dtype, device=x.device)

    def _prepare(self, streams: dict, modes):
        """Check what the kernel is given; return its constants (n set to
        the markers per species) and the library."""
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
        self._params.n = x.shape[-1]
        return self._params, library()


def _pointers(*tensors):
    """Device addresses for the C entry points; None for a stream the
    layout does not touch."""
    return [None if t is None else t.data_ptr() for t in tensors]
