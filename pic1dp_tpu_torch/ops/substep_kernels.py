"""The two fused RK2 substeps of the matrix-free spectral step.

Port of the TPU kernel of pic1dp_tpu/ops/pallas_kernels.py
(make_substep_call, wrapped by FusedStepper.substep1/2) in its stream_v1
layout with separate streams:

    substep 1:  read x0, v0, p, w0            write w1, v1
    substep 2:  read x0, v0, p, w0, w1, v1    write x2, v2, w2 over x0, v0, w0

each also returning the (2, nmode) mode projections of charge * w at the
pushed positions.  Every stream is at the config's dtype, except under
bf16_weights: there p and w1 are bfloat16 (cfg.p_dtype), upcast for the
arithmetic, and w1 is rounded to bfloat16 by round-to-nearest-even after
substep 1 has deposited it unrounded (pallas_kernels.py:555, :565-567,
:586, :610).  For each substep this module holds

  * the CUDA kernel (csrc/substep_kernels.cu, built by nvcc at first use and
    bound through ctypes) and its launch counters: SUBSTEP1 / SUBSTEP2 for
    the f32 and f64 builds, SUBSTEP1_BF16 / SUBSTEP2_BF16 for bf16_weights;
  * the plain PyTorch version, FusedSubsteps.substep1_plain / substep2_plain,
    the same function written with the port's mode_trig / efield_at /
    project_modes and distributions.minus_dlnf0_dv, on any device;
  * the dispatch, FusedSubsteps.substep1 / substep2: a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises (a variant
    outside the kernel's set, a failed build, a failed launch).  Nothing
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

MAX_MODES = 16          # kMaxModes in csrc/substep_kernels.cu
SOURCE = "substep_kernels"
_SRC = f"pic1dp_tpu_torch/csrc/{SOURCE}.cu"

SUBSTEP1 = CudaKernel("substep1", _SRC, "pic1dp_tpu/ops/pallas_kernels.py:558")
SUBSTEP2 = CudaKernel("substep2", _SRC, "pic1dp_tpu/ops/pallas_kernels.py:592")
SUBSTEP1_BF16 = CudaKernel("substep1_bf16", _SRC, "pic1dp_tpu/ops/pallas_kernels.py:586")
SUBSTEP2_BF16 = CudaKernel("substep2_bf16", _SRC, "pic1dp_tpu/ops/pallas_kernels.py:610")
KERNELS = (SUBSTEP1, SUBSTEP2, SUBSTEP1_BF16, SUBSTEP2_BF16)

# (arithmetic dtype, storage dtype of p and w1) -> C suffix and counters
_BUILDS = {
    (torch.float32, torch.float32): ("f32", SUBSTEP1, SUBSTEP2),
    (torch.float64, torch.float64): ("f64", SUBSTEP1, SUBSTEP2),
    (torch.float32, torch.bfloat16): ("f32_bf16", SUBSTEP1_BF16, SUBSTEP2_BF16),
}


class SubstepParams(ctypes.Structure):
    """Host constants of one run; mirrors struct HostParams in
    csrc/substep_kernels.cu field by field."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("nmode", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("kform", ctypes.c_int),
        ("modes", ctypes.c_int * MAX_MODES),
        ("cdm1", ctypes.c_double * MAX_MODES),
        ("sd", ctypes.c_double * MAX_MODES),
        *[(name, ctypes.c_double) for name in (
            "lx", "inv_lx", "nx_over_lx", "dt_half", "dt", "dtqm_half",
            "dtqm_full", "charge", "k_v0", "k_iv", "k_ivb", "k_half_iv",
            "k_half_ivb", "k_log_ratio")],
    ]


def kernel_params(cfg: Config) -> SubstepParams:
    """The kernels' constants for cfg (n is set per launch), or
    NotImplementedError for a variant outside the kernels' set."""
    why = []
    if cfg.nspecies != 1:
        why.append("more than one species")
    if cfg.linear or not cfg.deltaf:
        why.append("linear or full-f (the kernels are nonlinear delta-f)")
    if cfg.dtype not in ("float32", "float64"):
        why.append(f"dtype {cfg.dtype}")
    if cfg.equilibrium not in (Equilibrium.BUMP_ON_TAIL, Equilibrium.MAXWELLIAN):
        why.append(f"equilibrium {cfg.equilibrium.value}")
    if not 1 <= cfg.nmode <= MAX_MODES:
        why.append(f"{cfg.nmode} kept modes (at most {MAX_MODES})")
    if any(m < 1 or m * cfg.nx >= 2**31 for m in cfg.modes):
        why.append(f"modes {cfg.modes} with nx {cfg.nx}")
    if why:
        raise NotImplementedError("no CUDA substep kernel for this config: "
                                  + "; ".join(why))
    sp = cfg.species[0]
    prm = SubstepParams()
    prm.nmode, prm.nx = cfg.nmode, cfg.nx
    for j, m in enumerate(cfg.modes):
        step = 2.0 * math.pi * m / cfg.nx
        prm.modes[j], prm.cdm1[j], prm.sd[j] = m, math.cos(step) - 1.0, math.sin(step)
    prm.lx, prm.inv_lx, prm.nx_over_lx = cfg.lx, 1.0 / cfg.lx, cfg.nx / cfg.lx
    prm.dt_half, prm.dt = 0.5 * cfg.dt, cfg.dt
    prm.dtqm_half = 0.5 * cfg.dt * (sp.charge / sp.mass)
    prm.dtqm_full = cfg.dt * (sp.charge / sp.mass)
    prm.charge = sp.charge
    # -f0'/f0 folded on the host (pallas_kernels._minus_dlnf0_dv_fast):
    # kform 0 is (v - k_v0) * k_iv, kform 1 the two-Gaussian ratio form
    vth2 = sp.temperature / sp.mass
    iv = 1.0 / vth2
    prm.kform, prm.k_v0, prm.k_iv = 0, sp.v0, iv
    if cfg.equilibrium == Equilibrium.BUMP_ON_TAIL:
        vth2b = sp.temperature2 / sp.mass
        c_core = sp.density / math.sqrt(vth2)
        c_beam = (1.0 - sp.density) / math.sqrt(vth2b) if vth2b > 0.0 else 0.0
        if c_beam <= 0.0:                       # pure core
            prm.k_v0 = 0.0
        elif c_core <= 0.0:                     # pure beam
            prm.k_iv = 1.0 / vth2b
        else:
            prm.kform = 1
            prm.k_ivb = 1.0 / vth2b
            prm.k_half_iv, prm.k_half_ivb = 0.5 * iv, 0.5 / vth2b
            prm.k_log_ratio = math.log(c_beam) - math.log(c_core)
    return prm


_lib: nvcc.Library | None = None


def library() -> nvcc.Library:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        built = nvcc.load(SOURCE)
        lib = built.lib
        if lib.pic1dp_params_size() != ctypes.sizeof(SubstepParams):
            raise RuntimeError("SubstepParams does not match HostParams in "
                               "csrc/substep_kernels.cu")
        if lib.pic1dp_max_modes() != MAX_MODES:
            raise RuntimeError("MAX_MODES does not match kMaxModes")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        prm = ctypes.POINTER(SubstepParams)
        for dt, _, _ in _BUILDS.values():
            getattr(lib, f"pic1dp_substep1_{dt}").argtypes = [prm] + [ptr] * 9 + [i32, ptr]
            getattr(lib, f"pic1dp_substep2_{dt}").argtypes = [prm] + [ptr] * 9 + [i32, ptr]
        lib.pic1dp_grid_angle_f32.argtypes = [ptr, i32, i64, ptr, ptr, ptr]
        lib.pic1dp_error_string.argtypes = [i32]
        lib.pic1dp_error_string.restype = ctypes.c_char_p
        _lib = built
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
    rc = library().lib.pic1dp_grid_angle_f32(
        k.data_ptr(), nx, k.numel(), c.data_ptr(), s.data_ptr(),
        torch.cuda.current_stream(k.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(library().lib.pic1dp_error_string(rc).decode())
    return c, s


class FusedSubsteps:
    """Both substeps of one Config: kernels, plain versions and dispatch.

    `sp` holds the species parameters at the state's dtype and device, for
    the plain versions."""

    def __init__(self, cfg: Config, sp: dist.SpeciesParams):
        self.cfg = cfg
        self.sp = sp
        self.q_over_m = sp.charge / sp.mass
        # what each kernel takes, per stream: p and w1 at cfg.p_dtype, the
        # other streams and the modes at cfg.dtype
        dtype, narrow = getattr(torch, cfg.dtype), getattr(torch, cfg.p_dtype)
        self._dtypes = {1: (dtype, dtype, narrow, dtype, dtype, dtype),
                        2: (dtype, dtype, narrow, dtype, narrow, dtype, dtype, dtype)}
        self._build = _BUILDS.get((dtype, narrow))
        try:
            self._params, self._unsupported = kernel_params(cfg), None
        except NotImplementedError as exc:
            # raised again at the first CUDA launch; CPU runs need no kernel
            self._params, self._unsupported = None, exc

    # ---- plain versions ----

    def _push(self, x0, v0, p, w0, v_at, w_at, e, dt_eff: float):
        """The reference's update order from the step-start values x0, v0,
        w0 with the fields at the current substep: x, then w, then v
        (src/pic1dp_interaction.F90:238-339; JAX Stepper._push_math for
        nonlinear delta-f).  p and w_at may be stored narrower (bfloat16);
        they are upcast to the arithmetic dtype first."""
        cfg = self.cfg
        p, w_at = p.to(w0.dtype), w_at.to(w0.dtype)
        x_new = wrap_x(x0 + dt_eff * v_at, cfg.lx)
        kern = dist.minus_dlnf0_dv(cfg.equilibrium, self.sp, v_at)
        w_new = w0 + dt_eff * ((p - w_at) * e) * kern * self.q_over_m
        v_new = v0 + dt_eff * e * self.q_over_m
        return x_new, v_new, w_new

    def _project(self, x, w):
        cfg = self.cfg
        return project_modes(mode_trig(x, cfg.lx, cfg.nx, cfg.modes),
                             w * self.sp.charge)

    def substep1_plain(self, x, v, p, w, mode_re, mode_im):
        """(x0, v0, p, w0) + step-start modes -> (w1, v1, (p_c, p_s)).  w1
        is returned at p's storage dtype (rounded to nearest even under
        bf16_weights); the projections deposit it unrounded."""
        cfg = self.cfg
        e0 = efield_at(mode_trig(x, cfg.lx, cfg.nx, cfg.modes), mode_re, mode_im)
        x1, v1, w1 = self._push(x, v, p, w, v, w, e0, 0.5 * cfg.dt)
        return w1.to(p.dtype), v1, self._project(x1, w1)

    def substep2_plain(self, x, v, p, w, w1, v1, mode_re1, mode_im1):
        """(x0, v0, p, w0, w1, v1) + midpoint modes -> (x2, v2, w2,
        (p_c, p_s)); x2, v2, w2 are x, v, w updated in place.  p and w1 are
        at p's storage dtype."""
        cfg = self.cfg
        x1 = wrap_x(x + 0.5 * cfg.dt * v, cfg.lx)
        e1 = efield_at(mode_trig(x1, cfg.lx, cfg.nx, cfg.modes), mode_re1, mode_im1)
        x2, v2, w2 = self._push(x, v, p, w, v1, w1, e1, cfg.dt)
        proj = self._project(x2, w2)
        x.copy_(x2)
        v.copy_(v2)
        w.copy_(w2)
        return x, v, w, proj

    # ---- dispatch ----

    def substep1(self, x, v, p, w, mode_re, mode_im):
        if x.device.type == "cpu":
            return self.substep1_plain(x, v, p, w, mode_re, mode_im)
        prm, lib, (suffix, kernel, _) = self._prepare(1, (x, v, p, w), (mode_re, mode_im))
        w1, v1 = torch.empty_like(w, dtype=p.dtype), torch.empty_like(v)
        partials = self._partials(x)
        rc = getattr(lib, f"pic1dp_substep1_{suffix}")(
            ctypes.byref(prm), *(t.data_ptr() for t in (
                x, v, p, w, mode_re, mode_im, w1, v1, partials)),
            partials.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
        kernel.launched(rc, lib)
        proj = partials.sum(0)
        return w1, v1, (proj[0], proj[1])

    def substep2(self, x, v, p, w, w1, v1, mode_re1, mode_im1):
        if x.device.type == "cpu":
            return self.substep2_plain(x, v, p, w, w1, v1, mode_re1, mode_im1)
        prm, lib, (suffix, _, kernel) = self._prepare(2, (x, v, p, w, w1, v1),
                                                      (mode_re1, mode_im1))
        partials = self._partials(x)
        rc = getattr(lib, f"pic1dp_substep2_{suffix}")(
            ctypes.byref(prm), *(t.data_ptr() for t in (
                x, v, p, w, w1, v1, mode_re1, mode_im1, partials)),
            partials.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
        kernel.launched(rc, lib)
        proj = partials.sum(0)
        return x, v, w, (proj[0], proj[1])

    def _partials(self, x):
        return torch.empty((launch_grid(x.device), 2, self.cfg.nmode),
                           dtype=x.dtype, device=x.device)

    def _prepare(self, substep: int, streams, modes):
        """Check what the kernel is given; return its constants, library and
        build (C suffix and launch counters)."""
        x = streams[0]
        if self._unsupported is not None:
            raise NotImplementedError(str(self._unsupported))
        for t, d in zip(streams + modes, self._dtypes[substep]):
            if t.device != x.device or t.dtype != d or not t.is_contiguous():
                raise ValueError(
                    f"substep kernel streams are contiguous, on one device, with "
                    f"x, v, w, v1 and the modes at {self.cfg.dtype} and p, w1 at "
                    f"{self.cfg.p_dtype}; got {t.dtype} on {t.device} "
                    f"(contiguous: {t.is_contiguous()})")
        shape = (self.cfg.nspecies, x.shape[-1])
        if any(tuple(t.shape) != shape for t in streams):
            raise ValueError(f"particle streams must all be {shape}")
        if any(tuple(t.shape) != (self.cfg.nmode,) for t in modes):
            raise ValueError(f"mode components must be ({self.cfg.nmode},)")
        if x.device.type != "cuda":
            raise ValueError(f"no substep kernel for device {x.device}")
        self._params.n = x.numel()
        return self._params, library().lib, self._build
