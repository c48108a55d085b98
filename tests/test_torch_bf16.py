"""bf16_weights in the port against the JAX package: the state carry, the
plain substeps against the TPU kernel in interpret mode (separate bf16
streams, FusedStepper(cfg, interpret=True, stream_v1=True)), the Stepper
against the JAX Pallas Stepper, the bf16-against-f32 budget of
tests/test_spectral_path.py:195-231, and a short Simulation on the CPU.

Tolerances: x 5e-5 and v 1e-5 absolute, w and the projections 1e-4 of
their max (the f32 bounds of tests/test_spectral_path.py:141-170).  w1 is
bfloat16 on both sides: one bfloat16 ulp per marker, where the two f32
values before rounding differ by a few f32 ulp and flip the rounding, plus
1e-4 of max|w1|, where w1 is the difference of two nearly equal f32 terms
and their f32 roundoff is itself many bfloat16 ulp of w1.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from _torch_port import CASES, assert_bf16_close, assert_rel, host, to_jax, to_port

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.analysis.output_data import OutputData
from pic1dp_tpu.config import DepositMethod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.simulation import Simulation as JaxSimulation
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops.pallas_kernels import FusedStepper
from pic1dp_tpu.ops.spectral import solve_modes_from_projections
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(nx=192, nparticle_max=4096, dtype="float32", bf16_weights=True, verbosity=0)


def _pair(**over):
    kw = dict(KW, **over)
    return (jcfg_mod.bump_on_tail_default(deposit_method=DepositMethod.PALLAS, **kw),
            tcfg_mod.bump_on_tail_default(**kw))


def _loaded(jcfg, seed):
    return JaxStepper(jcfg).initial_field(jax_load(jcfg, jax.random.PRNGKey(seed)))


def test_bf16_state_round_trip_is_bitwise():
    """A JAX bf16 SimState goes to the port and back bit for bit, dtypes kept."""
    jcfg, _ = _pair()
    js = _loaded(jcfg, 1)
    ts = to_port(js)
    assert ts.p.dtype == torch.bfloat16 and ts.x.dtype == torch.float32
    back = to_jax(ts)
    for field in ("x", "v", "p", "w", "live", "rho", "electric", "mode_re", "mode_im"):
        a, b = np.asarray(getattr(js, field)), np.asarray(getattr(back, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=field)
    assert str(back.p.dtype) == "bfloat16"
    # the port's own bits: torch's bfloat16 is JAX's
    np.testing.assert_array_equal(host(ts.p.view(torch.int16)),
                                  np.asarray(js.p).view(np.int16))


def test_bf16_plain_substeps_match_pallas_interpret():
    jcfg, tcfg = _pair()
    js = _loaded(jcfg, 11)
    fused = FusedStepper(jcfg, interpret=True, stream_v1=True)
    subs = sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(tcfg, torch.float32, "cpu"))
    ts = to_port(js)

    jw1, jv1, (jpc1, jps1) = fused.substep1(js.x, js.v, js.p, js.w, js.mode_re, js.mode_im)
    w1, v1, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w, ts.mode_re, ts.mode_im)
    assert str(jw1.dtype) == "bfloat16" and w1.dtype == torch.bfloat16
    assert v1.dtype == torch.float32
    assert_bf16_close(w1.float(), np.asarray(jw1, np.float32), 1e-4, "w1")
    np.testing.assert_allclose(host(v1), np.asarray(jv1), rtol=0, atol=1e-5)
    # the projections deposit the UNROUNDED w1 in both
    assert_rel(pc1, jpc1, 1e-4, "p_c1")
    assert_rel(ps1, jps1, 1e-4, "p_s1")

    grad_inv = JaxStepper(jcfg).spectral.grad_inv
    mre1, mim1 = solve_modes_from_projections(jpc1, jps1, grad_inv, jcfg.lx)
    jx2, jv2, jw2, (jpc2, jps2) = fused.substep2(
        js.x, js.v, js.p, js.w, jw1, None, None, mre1, mim1, v1=jv1)
    t = {k: torch.from_numpy(np.array(a, np.float32)) for k, a in
         dict(v1=jv1, mre1=mre1, mim1=mim1).items()}
    tw1 = torch.from_numpy(np.asarray(jw1).view(np.int16).copy()).view(torch.bfloat16)
    x2, v2, w2, (pc2, ps2) = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, tw1, t["v1"], t["mre1"], t["mim1"])
    assert x2.dtype == v2.dtype == w2.dtype == torch.float32
    np.testing.assert_allclose(host(x2), np.asarray(jx2), rtol=0, atol=5e-5)
    np.testing.assert_allclose(host(v2), np.asarray(jv2), rtol=0, atol=1e-5)
    assert_rel(w2, jw2, 1e-4, "w2")
    assert_rel(pc2, jpc2, 1e-4, "p_c2")
    assert_rel(ps2, jps2, 1e-4, "p_s2")


def test_bf16_deposit_uses_unrounded_w1():
    """Depositing the rounded w1 would be a silent physics change: the
    projections must be those of the f32 w1, not of its bf16 rounding."""
    jcfg, tcfg = _pair()
    ts = to_port(_loaded(jcfg, 11))
    subs = sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(tcfg, torch.float32, "cpu"))
    w1, _, (pc1, ps1) = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w, ts.mode_re, ts.mode_im)
    f32 = sk.FusedSubsteps(dataclasses.replace(tcfg, bf16_weights=False), subs.sp)
    w1_full, _, (fc, fs) = f32.substep1_plain(ts.x, ts.v, ts.p.float(), ts.w,
                                             ts.mode_re, ts.mode_im)
    assert torch.equal(w1, w1_full.to(torch.bfloat16))
    assert torch.equal(pc1, fc) and torch.equal(ps1, fs)
    rounded = subs._project(ts.x, w1.float())   # any position: only w differs
    unrounded = subs._project(ts.x, w1_full)
    assert not torch.equal(rounded[0], unrounded[0])


def test_bf16_stepper_matches_jax_pallas():
    jcfg, tcfg = _pair()
    st_j = JaxStepper(jcfg)
    assert st_j.deposit_method == DepositMethod.PALLAS
    a = _loaded(jcfg, 11)
    stepper = Stepper(tcfg, "cpu")
    b = to_port(a)
    for _ in range(3):
        a, b = st_j.step(a), stepper.step(b)
    assert b.p.dtype == torch.bfloat16 and b.w.dtype == torch.float32
    np.testing.assert_allclose(host(b.x), np.asarray(a.x), rtol=0, atol=5e-5)
    np.testing.assert_allclose(host(b.v), np.asarray(a.v), rtol=0, atol=1e-5)
    for field in ("w", "mode_re", "mode_im"):
        assert_rel(getattr(b, field), getattr(a, field), 1e-4, field)
    np.testing.assert_array_equal(host(b.p.view(torch.int16)), np.asarray(a.p).view(np.int16))


@pytest.mark.parametrize("name", ["landau_linear", "two_species_maxwellian"])
def test_bf16_layout_stepper_matches_jax_pallas(name):
    """bf16_weights in the linear layout and with two species: 3 steps of
    the port's Stepper against the JAX Pallas Stepper (interpret mode) from
    one state, at the f32 tolerances, p kept bit for bit."""
    def cfg(mod, **kw):
        return dataclasses.replace(CASES[name](mod, "float32"), bf16_weights=True, **kw)

    jcfg, tcfg = cfg(jcfg_mod, deposit_method=DepositMethod.PALLAS), cfg(tcfg_mod)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the shifted-species warning
        st_j, stepper = JaxStepper(jcfg), Stepper(tcfg, "cpu")
    a = st_j.initial_field(jax_load(jcfg, jax.random.PRNGKey(13)))
    b = to_port(a)
    for _ in range(3):
        a, b = st_j.step(a), stepper.step(b)
    assert b.p.dtype == torch.bfloat16 and b.w.dtype == torch.float32
    np.testing.assert_allclose(host(b.x), np.asarray(a.x), rtol=0, atol=5e-5)
    np.testing.assert_allclose(host(b.v), np.asarray(a.v), rtol=0, atol=1e-5)
    for field in ("w", "mode_re", "mode_im"):
        assert_rel(getattr(b, field), getattr(a, field), 1e-4, field)
    np.testing.assert_array_equal(host(b.p.view(torch.int16)), np.asarray(a.p).view(np.int16))


def test_bf16_weights_matches_f32():
    """The port's mirror of tests/test_spectral_path.py:195-231: bf16 changes
    only the p storage and the w1 stream, so x is bitwise the f32 run's after
    one step, v agrees to 1e-5, and w to the ~0.4%/step budget after 3."""
    jcfg, tcfg = _pair()
    jcfg32 = dataclasses.replace(jcfg, bf16_weights=False)
    s32 = to_port(jax_load(jcfg32, jax.random.PRNGKey(11)))
    s16 = to_port(jax_load(jcfg, jax.random.PRNGKey(11)))
    assert s16.p.dtype == torch.bfloat16 and s16.w.dtype == torch.float32
    assert torch.equal(s16.x, s32.x)
    st32 = Stepper(dataclasses.replace(tcfg, bf16_weights=False), "cpu")
    st16 = Stepper(tcfg, "cpu")
    a, b = st32.step(st32.initial_field(s32)), st16.step(st16.initial_field(s16))
    assert b.p.dtype == torch.bfloat16 and b.w.dtype == torch.float32
    assert torch.equal(b.x, a.x)
    np.testing.assert_allclose(host(b.v), host(a.v), rtol=0, atol=1e-5)
    for _ in range(2):
        a, b = st32.step(a), st16.step(b)
    assert_rel(b.w, a.w, 2e-2, "w")
    assert_rel(b.mode_re, a.mode_re, 2e-2, "mode_re")


def test_bf16_simulation_on_cpu(tmp_path):
    """A short bf16 run keeps p bfloat16, writes a pic1dp.out that reads
    back, and follows the JAX Pallas bf16 run from the same state."""
    kw = dict(time_max=0.5, output_interval=0.25)
    jcfg, tcfg = _pair(**kw)
    raw = jax_load(jcfg, jax.random.PRNGKey(5))
    snaps = {"jax": [], "torch": []}
    jsim = JaxSimulation(jcfg, out_path=str(tmp_path / "jax"))
    jsim.state = jsim.stepper.initial_field(raw)
    jsim.run(snapshot_callback=snaps["jax"].append)
    sim = Simulation(tcfg, out_path=str(tmp_path / "torch"), device="cpu")
    sim.state = sim.stepper.initial_field(to_port(raw))
    sim.run(snapshot_callback=snaps["torch"].append)
    assert sim.state.p.dtype == torch.bfloat16 and sim.state.w.dtype == torch.float32
    od = OutputData(str(tmp_path / "torch"))
    assert od.ntime == 3 and od.nx == tcfg.nx and od.nspecies == 1
    energies = od.get_scalar_t()[1]
    assert np.all(np.isfinite(energies)) and np.all(energies > 0)
    assert [s["time"] for s in snaps["torch"]] == [s["time"] for s in snaps["jax"]]
    for a, b in zip(snaps["torch"], snaps["jax"]):
        np.testing.assert_allclose(a["field_energy"], b["field_energy"], rtol=1e-3)
        assert_rel(a["mode_re"], b["mode_re"], 1e-4, f"t={a['time']}")


def test_shifted_multispecies_bf16_warns_as_the_reference():
    sp = dict(temperature=1.0, mass=1.0, density=0.5)
    species = (jcfg_mod.SpeciesConfig(charge=-1.0, v0=3.0, **sp),
               jcfg_mod.SpeciesConfig(charge=-1.0, v0=-3.0, **sp))
    jcfg = dataclasses.replace(
        jcfg_mod.two_stream(nx=64, nparticle=2048, dtype="float32", verbosity=0),
        bf16_weights=True, equilibrium=jcfg_mod.Equilibrium.MAXWELLIAN, species=species)
    tcfg = tcfg_mod.Config.from_dict(jcfg.to_dict())
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        JaxStepper(jcfg)
    with pytest.warns(RuntimeWarning) as tw:
        Stepper(tcfg, "cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw
                                            if "strongly shifted" in str(w.message)]
    assert "strongly shifted" in str(tw[0].message)


def test_bf16_kernel_inputs_are_checked():
    """The CUDA path takes p and w1 as bfloat16 and everything else as
    float32, and refuses any other mix before it reaches the card."""
    _, tcfg = _pair(nparticle_max=1024)
    subs = sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(tcfg, torch.float32, "cpu"))

    def meta(dtype, n=1024):
        return torch.empty((1, n), dtype=dtype, device="meta")

    f32, b16 = torch.float32, torch.bfloat16
    modes = [torch.empty((1,), dtype=f32, device="meta")] * 2
    with pytest.raises(ValueError, match="no substep kernel for device meta"):
        subs.substep1(meta(f32), meta(f32), meta(b16), meta(f32), *modes)
    with pytest.raises(ValueError, match="no substep kernel for device meta"):
        subs.substep2(meta(f32), meta(f32), meta(b16), meta(f32), meta(b16), meta(f32), *modes)
    for bad in ((meta(f32), meta(f32), meta(f32), meta(f32)),       # p at f32
                (meta(b16), meta(f32), meta(b16), meta(f32))):      # x at bf16
        with pytest.raises(ValueError, match="p, w1 at bfloat16"):
            subs.substep1(*bad, *modes)
    with pytest.raises(ValueError, match="p, w1 at bfloat16"):   # w1 at f32
        subs.substep2(meta(f32), meta(f32), meta(b16), meta(f32), meta(f32), meta(f32), *modes)
    assert sk.kernel_params(tcfg).nmode == 1


def test_run_cli_bf16_on_cpu(tmp_path):
    sets = ["nx=64", "nparticle_max=2048", "time_max=0.2", "output_interval=0.1",
            "bf16_weights=True", "verbosity=0"]
    cmd = [sys.executable, "-m", "pic1dp_tpu_torch.run", "--device", "cpu",
           "-o", str(tmp_path)] + [a for s in sets for a in ("-s", s)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    od = OutputData(str(tmp_path))
    assert od.ntime == 3 and od.nx == 64
    assert np.all(np.isfinite(od.get_scalar_t()[1]))
