"""The port's fused substeps (ops/substep_kernels.py) against the TPU kernel.

The plain PyTorch versions are held against JAX FusedStepper(cfg,
interpret=True, stream_v1=True) — the Pallas kernels in interpret mode — on
the same arrays, for every variant of tests/test_spectral_path.py's
_pallas_cases (each layout, two-stream, several species) and TWO_STREAM1:
in float64 at 1e-12 relative to max, in float32 at the f32 tolerances of
tests/test_spectral_path.py:141-170, and under bf16_weights (linear and two
species) with w1 to one bf16 ulp plus 1e-4 of max.  The CUDA kernels run
only on the card (chip_smoke.py); here a numpy model of their arithmetic,
fed the constants the wrapper hands them, is held against the plain
versions, and the CPU dispatch is checked to take the plain versions and
launch nothing.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port import (CASES, GRID_CASES, WIDE_CASES, assert_bf16_close, assert_rel, host,
                         to_port)

import pic1dp_tpu.config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops.pallas_kernels import FusedStepper
from pic1dp_tpu.ops.spectral import solve_modes_from_projections
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.ops import substep_kernels as sk


BF16_CASES = ("landau_linear", "two_species_maxwellian")
ALL_CASES = {**CASES, **WIDE_CASES, **GRID_CASES}


def _params():
    out = [pytest.param(n, dt, id=f"{n}-{dt}") for n in CASES
           for dt in ("float64", "float32")]
    return out + [pytest.param(n, "bf16", id=f"{n}-bf16") for n in BF16_CASES]


def _configs(name, dtype):
    """The same config in both packages; dtype "bf16" is float32 with
    bf16_weights."""
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        cfg = CASES[name](mod, "float32" if dtype == "bf16" else dtype)
        if dtype == "bf16":
            cfg = dataclasses.replace(cfg, bf16_weights=True)
        out.append(cfg)
    return out


def _state(jcfg, seed=3):
    return JaxStepper(jcfg).initial_field(jax_load(jcfg, jax.random.PRNGKey(seed)))


def _substeps(tcfg, stream_v1=True):
    return sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(
        tcfg, getattr(torch, tcfg.dtype), "cpu"), stream_v1=stream_v1)


# f32: x and v absolute, w and each projection component (p_c, p_s)
# relative to its own max
_TOL = {"float64": dict(x=1e-12, v=1e-12, w=1e-12, proj=1e-12),
        "float32": dict(x=5e-5, v=1e-5, w=1e-4, proj=1e-4)}
_TOL["bf16"] = _TOL["float32"]
# Cases whose substep-2 projections are held as one (2, nmode) pair
# relative to the pair's max, each where a cos projection is a sum that cancels to far below
# its terms, so two summation orders differ by more than the bound relative
# to the sum itself:
#  * f32 against the Pallas kernel, two_species_bump_mixed: p_c2 reads
#    1.16e-4 of its own max (p_s2 3.4e-7); chip_smoke.py holds the kernels
#    to the pair bound;
#  * f64 kernel model, two_stream2: with the model's midpoint modes p_c2 is
#    2.1e-8 against p_s2's 1.6e-4, and reads 1.18e-12 of its own max (the
#    pair 1.7e-16).
_PAIR_SCALE_F32 = ("two_species_bump_mixed",)
_PAIR_SCALE_MODEL = ("two_stream2",)


def _check(name, got, want, tol, kind):
    if kind in ("x", "v") and tol > 1e-12:
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=0, atol=tol,
                                   err_msg=name)
    else:
        assert_rel(got, want, tol, name)


def _check_proj(name, got, want, tol, pair):
    """The projections (p_c, p_s) each relative to its own max, or as one
    pair relative to the pair's max."""
    if pair:
        assert_rel(np.stack([host(g) for g in got]), np.stack([host(w) for w in want]),
                   tol, name)
        return
    for label, g, w in zip(("p_c", "p_s"), got, want):
        assert_rel(g, w, tol, f"{name}:{label}")


def _tensor(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("name,dtype", _params())
def test_plain_substeps_match_pallas_interpret(name, dtype):
    jcfg, tcfg = _configs(name, dtype)
    tol = _TOL[dtype]
    js = _state(jcfg)
    fused = FusedStepper(jcfg, interpret=True, stream_v1=True)
    subs = _substeps(tcfg)
    ts = to_port(js)

    jw1, jv1, (jpc1, jps1) = fused.substep1(js.x, js.v, js.p, js.w,
                                            js.mode_re, js.mode_im)
    w1, v1, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w,
                                             ts.mode_re, ts.mode_im)
    assert (w1 is None) == (not tcfg.deltaf)
    assert (v1 is None) == (tcfg.linear or not tcfg.deltaf)
    if w1 is not None and dtype == "bf16":
        assert w1.dtype == torch.bfloat16
        assert_bf16_close(w1.float(), np.asarray(jw1, np.float32), 1e-4, f"{name}:w1")
    elif w1 is not None:
        _check(f"{name}:w1", w1, jw1, tol["w"], "w")
    if v1 is not None:
        _check(f"{name}:v1", v1, jv1, tol["v"], "v")
    _check_proj(f"{name}:proj1", (pc1, ps1), (jpc1, jps1), tol["proj"], False)

    # substep 2 from the same midpoint streams and modes in both
    grad_inv = JaxStepper(jcfg).spectral.grad_inv
    mre1, mim1 = solve_modes_from_projections(jpc1, jps1, grad_inv, jcfg.lx)
    jx2, jv2, jw2, (jpc2, jps2) = fused.substep2(
        js.x, js.v, js.p, js.w, jw1, js.mode_re, js.mode_im, mre1, mim1, v1=jv1)
    t = {k: None if a is None else _tensor(a) for k, a in
         dict(w1=jw1 if tcfg.deltaf else None, v1=jv1, mre1=mre1, mim1=mim1).items()}
    x2, v2, w2, (pc2, ps2) = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, t["w1"], t["v1"], t["mre1"], t["mim1"],
        ts.mode_re, ts.mode_im)
    assert x2 is ts.x and v2 is ts.v and w2 is ts.w   # updated in place
    _check(f"{name}:x2", x2, jx2, tol["x"], "x")
    _check(f"{name}:v2", v2, jv2, tol["v"], "v")
    _check(f"{name}:w2", w2, jw2, tol["w"], "w")
    _check_proj(f"{name}:proj2", (pc2, ps2), (jpc2, jps2), tol["proj"],
                dtype != "float64" and name in _PAIR_SCALE_F32)


def _kernel_model(subs, x, v, p, w, modes, substep, w1=None, v1=None):
    """The arithmetic of csrc/substep_kernels.cu in every layout, in numpy
    float64 on (ns, n) arrays, driven by what the wrapper passes: the
    SubstepParams, the angle table (nmode, nx, 2) and the species table.  In
    the register bins (at most 4 modes) the (cos, sin) of each marker's cell
    gathered from the table with the hat fold; in the grid bin (above 4, or
    subs.grid_bin) E on the grid from the table and the modes, the hat lerp
    of it at the marker, and the hat deposit onto a charge grid projected
    with the table.  Then the reciprocal wrap, each species' host-folded
    -f0'/f0 and dt q/m.  `modes` is (re, im) in substep 1, (re1, im1, re0,
    im0) in substep 2.  The recompute layout's substep 1 returns no w1 and
    its substep 2 rebuilds w1 (and v1) from E at x0 of the step-start
    modes."""
    prm, layout = sk.kernel_params(subs.cfg), subs.layout
    table, species = host(subs.angles), host(subs.species)
    cdm1, sd = sk.mode_constants(subs.cfg)
    nm, nx = prm.nmode, prm.nx
    grid = subs.uses_grid_bin()
    assert species.shape == (x.shape[0], sk.SPECIES_FIELDS)

    def col(k):
        return species[:, k][:, None]

    kform = col(0).astype(np.int64)
    c = {name: col(1 + k) for k, name in enumerate(sk._SPECIES_FIELDS)}

    def cell(xx):
        s = xx * prm.nx_over_lx
        fl = np.floor(s)
        return s - fl, np.clip(fl.astype(np.int64), 0, nx - 1)

    def hat_trig(xx):
        f, ix0 = cell(xx)
        out = []
        for j in range(nm):
            cs, sn = table[j, ix0, 0], table[j, ix0, 1]
            a, b = 1.0 + f * cdm1[j], f * sd[j]
            out.append((cs * a - sn * b, sn * a + cs * b))
        return out

    def gather(xx, re, im):
        if grid:
            e = 2.0 * (re @ table[..., 0] - im @ table[..., 1])
            f, ix0 = cell(xx)
            a = e[ix0]
            return a + f * (np.append(e, e[0])[ix0 + 1] - a)
        return 2.0 * sum(cc * re[j] - ss * im[j] for j, (cc, ss) in enumerate(hat_trig(xx)))

    def wrap(xx):
        y = xx - prm.lx * np.floor(xx * prm.inv_lx)
        return np.where(y >= prm.lx, y - prm.lx, np.where(y < 0.0, y + prm.lx, y))

    def kern(vv):
        dv = vv - c["k_v0"]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            r1 = np.exp(np.clip(vv * vv * c["k_half_iv"] - dv * dv * c["k_half_ivb"]
                                + c["k_log_ratio"], -60.0, 60.0))
            r3 = np.exp(np.clip(vv * c["k_ivb"], -60.0, 60.0))
            forms = [dv * c["k_iv"],
                     (vv * c["k_iv"] + r1 * (dv * c["k_ivb"])) / (1.0 + r1),
                     vv - 2.0 / vv,
                     ((vv + c["k_v0"]) + (vv - c["k_v0"]) * r3) * c["k_iv"] / (1.0 + r3)]
        return np.choose(np.broadcast_to(kform, vv.shape), forms)

    def project(xx, val):
        val = c["charge"] * val
        if grid:
            f, ix0 = cell(xx)
            rho = np.zeros(nx)
            np.add.at(rho, ix0.ravel(), (val * (1.0 - f)).ravel())
            np.add.at(rho, ((ix0 + 1) % nx).ravel(), (val * f).ravel())
            return table[..., 0] @ rho, table[..., 1] @ rho
        cs = hat_trig(xx)
        return (np.array([np.sum(val * cc) for cc, _ in cs]),
                np.array([np.sum(val * ss) for _, ss in cs]))

    def drive(e, ww):
        return p * e if layout == sk.LINEAR else (p - ww) * e

    if substep == 1:
        e = gather(x, *modes)
        x1 = wrap(x + prm.dt_half * v)
        if layout == sk.FULLF:
            return None, None, project(x1, p)
        w_1 = w + c["dtqm_half"] * drive(e, w) * kern(v)
        v_1 = v + c["dtqm_half"] * e if layout == sk.NONLINEAR else None
        return w_1 if layout != sk.RECOMPUTE else None, v_1, project(x1, w_1)
    if layout in (sk.FULLF, sk.RECOMPUTE):
        e0 = gather(x, *modes[2:])
        v1 = v + c["dtqm_half"] * e0
        if layout == sk.RECOMPUTE:
            w1 = w + c["dtqm_half"] * drive(e0, w) * kern(v)
    elif layout == sk.LINEAR:
        v1 = v
    e = gather(wrap(x + prm.dt_half * v), *modes[:2])
    x2 = wrap(x + prm.dt * v1)
    v2 = v if layout == sk.LINEAR else v + c["dtqm_full"] * e
    if layout == sk.FULLF:
        return x2, v2, w, project(x2, p)
    w2 = w + c["dtqm_full"] * drive(e, w1) * kern(v1)
    return x2, v2, w2, project(x2, w2)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_matches_plain(name):
    """What the CUDA kernels compute, from the constants and the tables
    they are given, equals the plain versions in float64 for each layout,
    nonlinear delta-f with v1 streamed and rebuilt (the kernels' own
    float64 build is held to the plain version on the card by
    chip_smoke.py)."""
    jcfg, tcfg = _configs(name, "float64")
    js = _state(jcfg)
    for stream_v1 in (True, False):
        subs = _substeps(tcfg, stream_v1)
        if not stream_v1 and subs.layout != sk.RECOMPUTE:
            continue
        _check_kernel_model(name, subs, to_port(js))


@pytest.mark.parametrize("name", list(WIDE_CASES) + ["bot_5_modes", "bot_16_modes"])
def test_kernel_arithmetic_past_the_tables(name):
    """The same past the register bins and what SubstepParams holds: the
    grid bin (5 to 33 modes) and the species table, both nonlinear delta-f
    layouts."""
    jcfg, tcfg = (ALL_CASES[name](m, "float64") for m in (jcfg_mod, tcfg_mod))
    js = _state(jcfg)
    for stream_v1 in (True, False):
        _check_kernel_model(name, _substeps(tcfg, stream_v1), to_port(js))


def _check_kernel_model(name, subs, ts):
    """_kernel_model against the plain versions of subs on state ts, in
    float64 at 1e-12 of each field's max."""
    a = {k: host(getattr(ts, k)) for k in ("x", "v", "p", "w")}
    mre, mim = host(ts.mode_re), host(ts.mode_im)

    w1, v1, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w, ts.mode_re, ts.mode_im)
    mw1, mv1, (mpc1, mps1) = _kernel_model(subs, a["x"], a["v"], a["p"], a["w"],
                                           (mre, mim), substep=1)
    for label, got, want in (("w1", mw1, w1), ("v1", mv1, v1)):
        assert (got is None) == (want is None), label
        if got is not None:
            assert_rel(got, want, 1e-12, f"{name}:{label}")
    _check_proj(f"{name}:proj1", (mpc1, mps1), (pc1, ps1), 1e-12, False)

    mre1, mim1 = -host(ps1) * 0.3, -host(pc1) * 0.3   # any midpoint modes
    mx2, mv2, mw2, (mpc2, mps2) = _kernel_model(
        subs, a["x"], a["v"], a["p"], a["w"], (mre1, mim1, mre, mim), substep=2,
        w1=None if w1 is None else host(w1), v1=None if v1 is None else host(v1))
    x2, v2, w2, (pc2, ps2) = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, w1, v1, torch.from_numpy(mre1), torch.from_numpy(mim1),
        ts.mode_re, ts.mode_im)
    for label, got, want in (("x2", mx2, x2), ("v2", mv2, v2), ("w2", mw2, w2)):
        assert_rel(got, want, 1e-12, f"{name}:{label}")
    _check_proj(f"{name}:proj2", (mpc2, mps2), (pc2, ps2), 1e-12,
                name in _PAIR_SCALE_MODEL)


@pytest.mark.parametrize("name,counters,kform", [
    ("bot_nonlinear_deltaf", ("substep1", "substep2"), [1]),
    ("landau_linear", ("substep1_linear", "substep2_linear"), [0]),
    ("landau_fullf", ("substep1_fullf", "substep2_fullf"), [0]),
    ("two_stream2", ("substep1", "substep2"), [3]),
    ("two_stream1", ("substep1", "substep2"), [2]),
    ("two_species_maxwellian", ("substep1", "substep2"), [0, 0]),
    ("two_species_bump_mixed", ("substep1", "substep2"), [1, 1]),
    ("bot_density_1", ("substep1", "substep2"), [0]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_kernel_route_and_constants(name, counters, kform):
    """Which layout's kernels a config launches (one counter per layout and
    build), and the constants its species get: the -f0'/f0 form, dt q/m
    and charge of each species, and the mixed-degenerate clamp."""
    _, tcfg = _configs(name, "float64")
    prm = sk.kernel_params(tcfg)
    assert tuple(k.name for k in _substeps(tcfg).counters) == counters
    assert prm.nspecies == tcfg.nspecies
    assert [prm.sp_kform[s] for s in range(tcfg.nspecies)] == kform
    for s, sp in enumerate(tcfg.species):
        assert prm.sp_charge[s] == sp.charge
        assert prm.sp_dtqm_full[s] == tcfg.dt * (sp.charge / sp.mass)
    if name == "two_species_bump_mixed":     # the degenerate species' clamp
        assert prm.sp_k_log_ratio[1] == -1e4
        assert prm.sp_k_ivb[1] == prm.sp_k_iv[1] == 1.0 / 1.5


def test_cpu_dispatch_takes_plain_and_launches_nothing():
    for name in ("bot_nonlinear_deltaf", "landau_fullf"):
        jcfg, tcfg = _configs(name, "float64")
        js = _state(jcfg)
        a, b = to_port(js), to_port(js)
        subs = _substeps(tcfg)
        before = [k.launches for k in sk.KERNELS]
        got1 = subs.substep1(a.x, a.v, a.p, a.w, a.mode_re, a.mode_im)
        want1 = subs.substep1_plain(b.x, b.v, b.p, b.w, b.mode_re, b.mode_im)
        for g, w in zip((got1[0], got1[1], *got1[2]), (want1[0], want1[1], *want1[2])):
            assert (g is None and w is None) or torch.equal(g, w)
        got2 = subs.substep2(a.x, a.v, a.p, a.w, got1[0], got1[1], a.mode_re, a.mode_im,
                             a.mode_re, a.mode_im)
        want2 = subs.substep2_plain(b.x, b.v, b.p, b.w, want1[0], want1[1],
                                    b.mode_re, b.mode_im, b.mode_re, b.mode_im)
        for g, w in zip((*got2[:3], *got2[3]), (*want2[:3], *want2[3])):
            assert torch.equal(g, w)
        assert [k.launches for k in sk.KERNELS] == before == [0] * len(sk.KERNELS)


def test_fullf_substep2_needs_the_step_start_modes():
    _, tcfg = _configs("landau_fullf", "float64")
    subs = _substeps(tcfg)
    x = torch.zeros((1, 8), dtype=torch.float64)
    modes = torch.zeros((1,), dtype=torch.float64)
    with pytest.raises(ValueError, match="step-start modes"):
        subs.substep2_plain(x, x.clone(), x, x, None, None, modes, modes)


@pytest.mark.parametrize("change", [
    dict(modes=tuple(range(1, 18)), init_modes=(1,)),
    dict(species=(tcfg_mod.SpeciesConfig(),) * 9),
], ids=["17_modes", "9_species"])
def test_variants_past_the_parameter_tables_run(change):
    """More kept modes or species than SubstepParams holds: kernel_params
    accepts the config (the first MAX_MODES modes and MAX_SPECIES species
    in the parameters, every species in the species table; the grid bin
    needs no per-mode constant), a launch off the CPU gets as far as the
    device check, and the CPU dispatch runs the plain version."""
    cfg = dataclasses.replace(
        tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=1024, dtype="float64"),
        **change)
    prm = sk.kernel_params(cfg)
    assert prm.nmode == cfg.nmode and prm.nspecies == cfg.nspecies
    subs = _substeps(cfg)
    assert subs.uses_grid_bin() == (cfg.nmode > 4)
    assert tuple(subs.angles.shape) == (cfg.nmode, cfg.nx, 2)
    assert tuple(subs.species.shape) == (cfg.nspecies, sk.SPECIES_FIELDS)
    meta = [torch.empty((cfg.nspecies, 1024), dtype=torch.float64, device="meta")] * 4
    modes = [torch.empty((cfg.nmode,), dtype=torch.float64, device="meta")] * 2
    with pytest.raises(ValueError, match="no substep kernel for device meta"):
        subs.substep1(*meta, *modes)
    cpu = [torch.zeros((cfg.nspecies, 64), dtype=torch.float64) for _ in range(4)]
    before = [k.launches for k in sk.KERNELS]
    w1, _, _ = subs.substep1(*cpu, *[torch.zeros(cfg.nmode, dtype=torch.float64)] * 2)
    assert w1.shape == (cfg.nspecies, 64)
    assert [k.launches for k in sk.KERNELS] == before


def test_variants_outside_the_kernel_set_raise():
    """A config no kernel serves (a mode whose m nx overflows the kernels'
    int cell index) raises off the CPU; nothing falls back to the plain
    version.  On the CPU the plain version still runs."""
    cfg = dataclasses.replace(
        tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=1024, dtype="float64"),
        modes=(1, 2**25), init_modes=(1,))
    with pytest.raises(NotImplementedError, match="modes"):
        sk.kernel_params(cfg)
    subs = _substeps(cfg)
    meta = [torch.empty((cfg.nspecies, 1024), dtype=torch.float64, device="meta")] * 4
    modes = [torch.empty((cfg.nmode,), dtype=torch.float64, device="meta")] * 2
    with pytest.raises(NotImplementedError, match="modes"):
        subs.substep1(*meta, *modes)
    cpu = [torch.zeros((cfg.nspecies, 64), dtype=torch.float64) for _ in range(4)]
    w1, _, _ = subs.substep1(*cpu, *[torch.zeros(cfg.nmode, dtype=torch.float64)] * 2)
    assert w1.shape == (cfg.nspecies, 64)


def test_supported_variant_off_cuda_raises():
    for name in ("bot_nonlinear_deltaf", "landau_linear", "two_species_maxwellian"):
        _, cfg = _configs(name, "float64")
        subs = _substeps(cfg)
        meta = [torch.empty((cfg.nspecies, 1024), dtype=torch.float64, device="meta")] * 6
        modes = [torch.empty((cfg.nmode,), dtype=torch.float64, device="meta")] * 2
        with pytest.raises(ValueError, match="no substep kernel for device meta"):
            subs.substep2(*meta, *modes)


@pytest.mark.parametrize("name,counter", [
    ("void (anonymous namespace)::substep1_kernel<float, float, float, 1, 0, false>"
     "((anonymous namespace)::Params<float>, float const*)", "substep1"),
    ("void (anonymous namespace)::substep2_kernel<float, __nv_bfloat16, __nv_bfloat16, 4, 1,"
     " true>((anonymous namespace)::Params<float>)", "substep2_linear_bf16"),
    ("_ZN38_GLOBAL__N__0a1b2c3d_18_substep_kernels_cu_115substep1_kernelIf13__nv_bfloat16"
     "S1_Li1ELi0ELb0EEEvN6ParamsIT_EE", "substep1_bf16"),
    ("_ZN38_GLOBAL__N__0a1b2c3d_18_substep_kernels_cu_115substep2_kernelIdddLi16ELi2ELb1EEEv",
     "substep2_fullf"),
    ("_ZN51_GLOBAL__N__98291d35_18_substep_kernels_cu_bf26865015substep1_kernelIf13__nv_bfloat16"
     "S1_Li0ELi0ELb1ELb1EEEvNS_6ParamsIT_EENS_4ArgsIS3_T0_T1_EENS_12SpeciesTableIS3_EE",
     "substep1_bf16"),
    ("void (anonymous namespace)::substep2_kernel<float, float, float, 0, 3, true, true>"
     "((anonymous namespace)::Params<float>)", "substep2_recompute"),
    ("_ZN38_GLOBAL__N__0a1b2c3d_18_substep_kernels_cu_115substep1_kernelIf13__nv_bfloat16"
     "S1_Li1ELi3ELb0ELb0EEEvN6ParamsIT_EE", "substep1_recompute_bf16"),
    ("_ZN38_GLOBAL__N__0a1b2c3d_18_substep_kernels_cu_117grid_angle_kernelEPKiixPfS2_", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", None),
], ids=["demangled", "demangled_linear_bf16", "mangled_bf16", "mangled_fullf_f64",
        "mangled_grid_bf16", "demangled_recompute_grid", "mangled_recompute_bf16", "grid_angle",
        "other"])
def test_profiler_kernel_names_map_to_counters(name, counter):
    """chip_smoke.py reads each substep kernel's launches off a profiler
    trace by its device name: the substep, the layout (template argument L)
    and the bf16 storage give the wrapper's counter."""
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    assert chip_smoke.substep_counter(name) == counter
    assert counter is None or counter in {k.name for k in sk.KERNELS}
