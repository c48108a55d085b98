"""The port's fused substeps (ops/substep_kernels.py) against the TPU kernel.

The plain PyTorch versions are held against JAX FusedStepper(cfg,
interpret=True, stream_v1=True) — the Pallas kernels in interpret mode — on
the same arrays: in float64 at 1e-12 relative to max, in float32 at the f32
tolerances of tests/test_spectral_path.py:141-170.  The CUDA kernels run only
on the card (chip_smoke.py); here a numpy model of their arithmetic, fed the
constants the wrapper hands them, is held against the plain versions, and
the CPU dispatch is checked to take the plain versions and launch nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host, to_port

import pic1dp_tpu.config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops.pallas_kernels import FusedStepper
from pic1dp_tpu.ops.spectral import solve_modes_from_projections
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.ops import substep_kernels as sk


def _cases(dtype):
    """The main-path variant and the kernel set's others, from
    tests/test_spectral_path.py's _pallas_cases and degenerate densities."""
    bot = dict(nx=192, nparticle_max=4096, dtype=dtype, verbosity=0)
    lan = dict(nx=64, nparticle=4096, dtype=dtype, verbosity=0)
    yield "bot_nonlinear_deltaf", ("bump_on_tail_default", bot, {})
    yield "multimode", ("landau_damping", lan, dict(
        modes=(1, 2, 3), init_modes=(1, 2), init_amp_cos=(1e-5, 0.0),
        init_amp_sin=(1e-4, 5e-5)))
    for density in (1.0, 0.0):
        yield f"bot_density_{density:g}", (
            "bump_on_tail_default", dict(bot, nx=64), dict(density=density))


def _configs(spec):
    """The same config in both packages."""
    preset, kw, over = spec
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        cfg = getattr(mod, preset)(**kw)
        if "density" in over:
            sp = dataclasses.replace(cfg.species[0], density=over["density"])
            cfg = dataclasses.replace(cfg, species=(sp,))
        else:
            cfg = dataclasses.replace(cfg, **over)
        out.append(cfg)
    return out


def _state(jcfg, seed=3):
    return JaxStepper(jcfg).initial_field(
        jax_load(jcfg, jax.random.PRNGKey(seed)))


def _substeps(tcfg):
    dtype = getattr(torch, tcfg.dtype)
    return sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(tcfg, dtype, "cpu"))


# f32: x and v absolute, w and the projections relative to max
_TOL = {"float64": dict(x=1e-12, v=1e-12, w=1e-12, proj=1e-12),
        "float32": dict(x=5e-5, v=1e-5, w=1e-4, proj=1e-4)}


def _check(name, got, want, tol, kind):
    if kind in ("x", "v") and tol > 1e-12:
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=0, atol=tol,
                                   err_msg=name)
    else:
        assert_rel(got, want, tol, name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,spec", [pytest.param(n, c, id=n)
                                       for n, c in _cases("float64")])
def test_plain_substeps_match_pallas_interpret(name, spec, dtype):
    spec = (spec[0], dict(spec[1], dtype=dtype), spec[2])
    jcfg, tcfg = _configs(spec)
    tol = _TOL[dtype]
    js = _state(jcfg)
    fused = FusedStepper(jcfg, interpret=True, stream_v1=True)
    subs = _substeps(tcfg)
    ts = to_port(js)

    jw1, jv1, (jpc1, jps1) = fused.substep1(js.x, js.v, js.p, js.w,
                                            js.mode_re, js.mode_im)
    w1, v1, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w,
                                             ts.mode_re, ts.mode_im)
    _check(f"{name}:w1", w1, jw1, tol["w"], "w")
    _check(f"{name}:v1", v1, jv1, tol["v"], "v")
    _check(f"{name}:p_c1", pc1, jpc1, tol["proj"], "proj")
    _check(f"{name}:p_s1", ps1, jps1, tol["proj"], "proj")

    # substep 2 from the same midpoint streams and modes in both
    grad_inv = JaxStepper(jcfg).spectral.grad_inv
    mre1, mim1 = solve_modes_from_projections(jpc1, jps1, grad_inv, jcfg.lx)
    jx2, jv2, jw2, (jpc2, jps2) = fused.substep2(
        js.x, js.v, js.p, js.w, jw1, None, None, mre1, mim1, v1=jv1)
    t = {k: torch.from_numpy(np.array(a)) for k, a in
         dict(w1=jw1, v1=jv1, mre1=mre1, mim1=mim1).items()}
    x2, v2, w2, (pc2, ps2) = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, t["w1"], t["v1"], t["mre1"], t["mim1"])
    assert x2 is ts.x and v2 is ts.v and w2 is ts.w   # updated in place
    _check(f"{name}:x2", x2, jx2, tol["x"], "x")
    _check(f"{name}:v2", v2, jv2, tol["v"], "v")
    _check(f"{name}:w2", w2, jw2, tol["w"], "w")
    _check(f"{name}:p_c2", pc2, jpc2, tol["proj"], "proj")
    _check(f"{name}:p_s2", ps2, jps2, tol["proj"], "proj")


def _kernel_model(prm, x, v, p, w, mre, mim, substep, w1=None, v1=None):
    """The arithmetic of csrc/substep_kernels.cu in numpy float64, driven by
    the SubstepParams the wrapper passes: integer-reduced grid angles with
    the hat fold, the reciprocal wrap, the host-folded -f0'/f0."""
    nm, nx = prm.nmode, prm.nx

    def hat_trig(xx):
        s = xx * prm.nx_over_lx
        fl = np.floor(s)
        f = s - fl
        ix0 = np.clip(fl.astype(np.int64), 0, nx - 1)
        out = []
        for j in range(nm):
            k = (prm.modes[j] * ix0) % nx
            t = 2.0 * np.where(2 * k > nx, k - nx, k) / nx
            sn, cs = np.sin(np.pi * t), np.cos(np.pi * t)
            a, b = 1.0 + f * prm.cdm1[j], f * prm.sd[j]
            out.append((cs * a - sn * b, sn * a + cs * b))
        return out

    def gather(xx, re, im):
        return 2.0 * sum(c * re[j] - s * im[j] for j, (c, s) in enumerate(hat_trig(xx)))

    def wrap(xx):
        y = xx - prm.lx * np.floor(xx * prm.inv_lx)
        return np.where(y >= prm.lx, y - prm.lx, np.where(y < 0.0, y + prm.lx, y))

    def kern(vv):
        if prm.kform == 0:
            return (vv - prm.k_v0) * prm.k_iv
        dv = vv - prm.k_v0
        r = np.exp(np.clip(vv * vv * prm.k_half_iv - dv * dv * prm.k_half_ivb
                           + prm.k_log_ratio, -60.0, 60.0))
        return (vv * prm.k_iv + r * (dv * prm.k_ivb)) / (1.0 + r)

    def project(xx, ww):
        cs = hat_trig(xx)
        val = prm.charge * ww
        return (np.array([np.sum(val * c) for c, _ in cs]),
                np.array([np.sum(val * s) for _, s in cs]))

    if substep == 1:
        e = gather(x, mre, mim)
        x1 = wrap(x + prm.dt_half * v)
        w_1 = w + prm.dtqm_half * ((p - w) * e) * kern(v)
        return w_1, v + prm.dtqm_half * e, project(x1, w_1)
    e = gather(wrap(x + prm.dt_half * v), mre, mim)
    x2 = wrap(x + prm.dt * v1)
    w2 = w + prm.dtqm_full * ((p - w1) * e) * kern(v1)
    return x2, v + prm.dtqm_full * e, w2, project(x2, w2)


@pytest.mark.parametrize("name,spec", [pytest.param(n, c, id=n)
                                       for n, c in _cases("float64")])
def test_kernel_arithmetic_matches_plain(name, spec):
    """What the CUDA kernels compute, from the constants they are given,
    equals the plain versions in float64 (the kernel's own float64 build is
    held to the plain version on the card by chip_smoke.py)."""
    jcfg, tcfg = _configs(spec)
    ts = to_port(_state(jcfg))
    subs = _substeps(tcfg)
    prm = sk.kernel_params(tcfg)
    a = {k: host(getattr(ts, k))[0] for k in ("x", "v", "p", "w")}
    mre, mim = host(ts.mode_re), host(ts.mode_im)

    w1, v1, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w, ts.mode_re, ts.mode_im)
    mw1, mv1, (mpc1, mps1) = _kernel_model(prm, a["x"], a["v"], a["p"], a["w"],
                                           mre, mim, substep=1)
    for label, got, want in (("w1", mw1, w1[0]), ("v1", mv1, v1[0]),
                             ("p_c1", mpc1, pc1), ("p_s1", mps1, ps1)):
        assert_rel(got, want, 1e-12, f"{name}:{label}")

    mre1, mim1 = -host(ps1) * 0.3, -host(pc1) * 0.3   # any midpoint modes
    mx2, mv2, mw2, (mpc2, mps2) = _kernel_model(
        prm, a["x"], a["v"], a["p"], a["w"], mre1, mim1, substep=2,
        w1=host(w1)[0], v1=host(v1)[0])
    x2, v2, w2, (pc2, ps2) = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, w1, v1, torch.from_numpy(mre1), torch.from_numpy(mim1))
    for label, got, want in (("x2", mx2, x2[0]), ("v2", mv2, v2[0]), ("w2", mw2, w2[0]),
                             ("p_c2", mpc2, pc2), ("p_s2", mps2, ps2)):
        assert_rel(got, want, 1e-12, f"{name}:{label}")


def test_cpu_dispatch_takes_plain_and_launches_nothing():
    jcfg, tcfg = _configs(next(iter(_cases("float64")))[1])
    js = _state(jcfg)
    a, b = to_port(js), to_port(js)
    subs = _substeps(tcfg)
    before = [k.launches for k in sk.KERNELS]
    got1 = subs.substep1(a.x, a.v, a.p, a.w, a.mode_re, a.mode_im)
    want1 = subs.substep1_plain(b.x, b.v, b.p, b.w, b.mode_re, b.mode_im)
    for g, w in zip((got1[0], got1[1], *got1[2]), (want1[0], want1[1], *want1[2])):
        assert torch.equal(g, w)
    got2 = subs.substep2(a.x, a.v, a.p, a.w, got1[0], got1[1], a.mode_re, a.mode_im)
    want2 = subs.substep2_plain(b.x, b.v, b.p, b.w, want1[0], want1[1],
                                b.mode_re, b.mode_im)
    for g, w in zip((*got2[:3], *got2[3]), (*want2[:3], *want2[3])):
        assert torch.equal(g, w)
    assert [k.launches for k in sk.KERNELS] == before == [0] * len(sk.KERNELS)


@pytest.mark.parametrize("change,reason", [
    (dict(linear=True), "linear"),
    (dict(deltaf=False), "full-f"),
    (dict(equilibrium=tcfg_mod.Equilibrium.TWO_STREAM2), "two_stream2"),
    (dict(species=(tcfg_mod.SpeciesConfig(),) * 2), "more than one species"),
    (dict(modes=tuple(range(1, 18)), init_modes=(1,)), "17 kept modes"),
], ids=["linear", "fullf", "two_stream2", "two_species", "17_modes"])
def test_variants_outside_the_kernel_set_raise(change, reason):
    """Off the CPU, a variant the kernels do not cover raises; nothing falls
    back to the plain version.  On the CPU the plain version still runs."""
    cfg = dataclasses.replace(
        tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=1024, dtype="float64"),
        **change)
    with pytest.raises(NotImplementedError, match=reason):
        sk.kernel_params(cfg)
    subs = _substeps(cfg)
    meta = [torch.empty((cfg.nspecies, 1024), dtype=torch.float64, device="meta")] * 4
    modes = [torch.empty((cfg.nmode,), dtype=torch.float64, device="meta")] * 2
    with pytest.raises(NotImplementedError, match=reason):
        subs.substep1(*meta, *modes)


def test_supported_variant_off_cuda_raises():
    cfg = tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=1024, dtype="float64")
    subs = _substeps(cfg)
    meta = [torch.empty((1, 1024), dtype=torch.float64, device="meta")] * 6
    modes = [torch.empty((1,), dtype=torch.float64, device="meta")] * 2
    with pytest.raises(ValueError, match="no substep kernel for device meta"):
        subs.substep2(*meta, *modes)
