"""The substep kernels' last layouts against the TPU kernel — the
recompute layout, more kept modes and more species than the kernel
parameters hold — and the phase table and profiler that time them.

The plain versions (ops/substep_kernels.py) are held against JAX
FusedStepper(cfg, interpret=True, stream_v1=...) — the Pallas kernels in
interpret mode — on the same arrays, in float64 at 1e-12 of each field's
max: the recompute layout of nonlinear delta-f (substep 2 rebuilds v1 from
the step-start modes, stream_v1=False), more kept modes than the kernels'
parameters hold (17 and 33: the grid bin) and more species (9 and 12: the
species table).  The kernels' own arithmetic on those tables is held in
tests/test_torch_substep.py; the CUDA kernels run on the card only
(chip_smoke.py).  Then the Stepper's PIC1DP_STREAM_V1, bit for bit between
its two layouts, and utils/phase_split.py and run.py's --phase-table and
--profile on the CPU.
"""

import dataclasses
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port import CASES, WIDE_CASES, assert_bf16_close, assert_rel, host, to_port

import pic1dp_tpu.config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops.pallas_kernels import FusedStepper
from pic1dp_tpu.ops.spectral import solve_modes_from_projections
from pic1dp_tpu.utils import phase_split as jax_phase_split
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch import run as trun
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk
from pic1dp_tpu_torch.utils import phase_split

REPO = Path(__file__).resolve().parents[1]
ALL_CASES = {**CASES, **WIDE_CASES}


def _configs(name, dtype):
    """The same config in both packages; dtype "bf16" is float32 with
    bf16_weights."""
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        cfg = ALL_CASES[name](mod, "float32" if dtype == "bf16" else dtype)
        if dtype == "bf16":
            cfg = dataclasses.replace(cfg, bf16_weights=True)
        out.append(cfg)
    return out


def _tensor(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _compare(name, dtype, stream_v1):
    """Both substeps of the plain version against the interpret kernel of
    the same layout, from one JAX-loaded state; substep 2 from the JAX
    midpoint streams and modes."""
    jcfg, tcfg = _configs(name, dtype)
    js = JaxStepper(jcfg).initial_field(jax_load(jcfg, jax.random.PRNGKey(5)))
    fused = FusedStepper(jcfg, interpret=True, stream_v1=stream_v1)
    subs = sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(
        tcfg, getattr(torch, tcfg.dtype), "cpu"), stream_v1=stream_v1)
    ts = to_port(js)
    f64 = dtype == "float64"

    def close(label, got, want, kind):
        if f64 or kind in ("w", "proj"):
            assert_rel(got, want, 1e-12 if f64 else 1e-4, f"{name}:{label}")
        else:
            np.testing.assert_allclose(host(got), np.asarray(want), rtol=0,
                                       atol=dict(x=5e-5, v=1e-5)[kind], err_msg=label)

    jw1, jv1, jproj1 = fused.substep1(js.x, js.v, js.p, js.w, js.mode_re, js.mode_im)
    w1, v1, proj1 = subs.substep1_plain(ts.x, ts.v, ts.p, ts.w, ts.mode_re, ts.mode_im)
    assert (v1 is None) == (jv1 is None) == (subs.layout != sk.NONLINEAR)
    # the recompute layout returns no w1: substep 2 rebuilds it (JAX's
    # kernel still streams it, and its substep 2 takes it)
    assert (w1 is None) == (subs.layout == sk.RECOMPUTE)
    if w1 is not None and dtype == "bf16":
        assert w1.dtype == torch.bfloat16
        assert_bf16_close(w1.float(), np.asarray(jw1, np.float32), 1e-4, f"{name}:w1")
    elif w1 is not None:
        close("w1", w1, jw1, "w")
    if v1 is not None:
        close("v1", v1, jv1, "v")
    for label, g, w in zip(("p_c1", "p_s1"), proj1, jproj1):
        close(label, g, w, "proj")

    grad_inv = JaxStepper(jcfg).spectral.grad_inv
    mre1, mim1 = solve_modes_from_projections(*jproj1, grad_inv, jcfg.lx)
    jx2, jv2, jw2, jproj2 = fused.substep2(js.x, js.v, js.p, js.w, jw1, js.mode_re,
                                           js.mode_im, mre1, mim1, v1=jv1)
    x2, v2, w2, proj2 = subs.substep2_plain(
        ts.x, ts.v, ts.p, ts.w, None if w1 is None else _tensor(jw1),
        None if jv1 is None else _tensor(jv1), _tensor(mre1), _tensor(mim1), ts.mode_re,
        ts.mode_im)
    close("x2", x2, jx2, "x")
    close("v2", v2, jv2, "v")
    close("w2", w2, jw2, "w")
    for label, g, w in zip(("p_c2", "p_s2"), proj2, jproj2):
        close(label, g, w, "proj")


@pytest.mark.parametrize("name,dtype", [
    ("bot_nonlinear_deltaf", "float64"), ("two_stream2", "float64"),
    ("two_species_bump_mixed", "float64"), ("bot_nonlinear_deltaf", "bf16"),
], ids=["bot", "two_stream2", "two_species_bump_mixed", "bot-bf16"])
def test_recompute_plain_substeps_match_pallas_interpret(name, dtype):
    """stream_v1=False: substep 1 returns no v1 and substep 2 rebuilds it
    from the step-start modes, in both packages; the port's substep 1
    returns no w1 either (its substep 2 rebuilds it from the same E at x0),
    so substep 1 is held to JAX's on the projections alone."""
    _compare(name, dtype, stream_v1=False)


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_plain_substeps_past_the_tables_match_pallas_interpret(name):
    _compare(name, "float64", stream_v1=True)


def test_wide_recompute_matches_pallas_interpret():
    _compare("bot_33_modes", "float64", stream_v1=False)


@pytest.mark.parametrize("kernel_bin", ["register", "grid"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bf16"])
def test_rebuilt_w1_is_the_streamed_w1_bit_for_bit(dtype, kernel_bin):
    """substep2_plain of the recompute layout, which rebuilds w1 (and v1)
    from the step-start modes, equals substep2_plain of the streamed layout
    fed substep1_plain's w1 and v1, bit for bit: x2, v2, w2, the
    projections and their modes; under bf16_weights the rebuilt w1 is
    rounded to bfloat16 as the stream carries it.  In the register bin (one
    kept mode) and the grid bin (16 modes, grid_bin set)."""
    cfg = tcfg_mod.bump_on_tail_default(
        nx=64, nparticle_max=4096, verbosity=0,
        dtype="float32" if dtype == "bf16" else dtype, bf16_weights=dtype == "bf16")
    if kernel_bin == "grid":
        cfg = dataclasses.replace(cfg, modes=tuple(range(1, 17)), init_modes=(1,),
                                  init_amp_cos=(0.0,), init_amp_sin=(cfg.init_amp_sin[0],))
    cfg = cfg.validate()
    sp = tdist.SpeciesParams.from_config(cfg, getattr(torch, cfg.dtype), "cpu")
    streamed, rebuilt = (sk.FusedSubsteps(cfg, sp, stream_v1=s) for s in (True, False))
    for subs in (streamed, rebuilt):
        subs.grid_bin = kernel_bin == "grid"
    assert rebuilt.layout == sk.RECOMPUTE and rebuilt.rebuilds_w1
    assert streamed.layout == sk.NONLINEAR and not streamed.rebuilds_w1
    s = Stepper(cfg, "cpu").initial_field(load_particles(cfg, "cpu"))
    x, v, p, w, mre, mim = s.x, s.v, s.p, s.w, s.mode_re, s.mode_im
    w1, v1, proj1, modes1 = streamed.substep1_plain(x, v, p, w, mre, mim, solve=True)
    rw1, rv1, rproj1, rmodes1 = rebuilt.substep1_plain(x, v, p, w, mre, mim, solve=True)
    assert rw1 is None and rv1 is None and w1.dtype == p.dtype
    assert all(torch.equal(a, b) for a, b in zip((*proj1, *modes1), (*rproj1, *rmodes1)))
    a, b = ([t.clone() for t in (x, v, w)] for _ in range(2))
    want = streamed.substep2_plain(a[0], a[1], p, a[2], w1, v1, *modes1, mre, mim, solve=True)
    got = rebuilt.substep2_plain(b[0], b[1], p, b[2], None, None, *modes1, mre, mim,
                                 solve=True)
    for k, (g, t) in enumerate(zip((*got[:3], *got[3], *got[4]),
                                   (*want[:3], *want[3], *want[4]))):
        assert torch.equal(g, t), k


def test_wrapper_refuses_species_or_mode_table_on_another_device():
    """The species table, like the angle table and the counters
    (tests/test_torch_substep_design.py), must lie on the streams' device;
    the grid bin needs no mode table, so after those nothing else does."""
    _, cfg = _configs("landau_9_species", "float64")
    cfg = dataclasses.replace(cfg, modes=tuple(range(1, 18)))
    subs = sk.FusedSubsteps(cfg, tdist.SpeciesParams.from_config(cfg, torch.float64, "cpu"))
    assert subs.uses_grid_bin() and not hasattr(subs, "modes")
    subs.angles, subs._done = subs.angles.to("meta"), subs._done.to("meta")
    with pytest.raises(ValueError, match="species table lies on cpu, the streams on meta"):
        subs.check_scratch(torch.device("meta"))
    subs.species = subs.species.to("meta")
    subs.check_scratch(torch.device("meta"))


def _stepper(cfg, monkeypatch, value):
    monkeypatch.setenv("PIC1DP_STREAM_V1", value)
    st = Stepper(cfg, "cpu")
    monkeypatch.delenv("PIC1DP_STREAM_V1")
    return st


def test_layout_follows_the_measured_line():
    """Nonlinear delta-f rebuilds v1 above REBUILD_V1_MIN_MARKERS markers
    (all species) with one kept mode or more than 4 (the grid bin), and
    streams it otherwise; an explicit stream_v1 wins; linear and full-f
    have one layout each."""
    cfg = tcfg_mod.bump_on_tail_default(nparticle_max=sk.REBUILD_V1_MIN_MARKERS)
    two = dataclasses.replace(_configs("two_species_bump_mixed", "float64")[1],
                              nparticle_max=sk.REBUILD_V1_MIN_MARKERS // 2)
    assert sk.layout(cfg) == sk.layout(two) == sk.NONLINEAR
    for c in (cfg, two):
        more = dataclasses.replace(c, nparticle_max=c.nparticle_max + 1)
        assert sk.layout(more) == sk.RECOMPUTE and sk.rebuilds_v1_faster(more)
        assert sk.layout(more, stream_v1=True) == sk.NONLINEAR
        assert sk.layout(dataclasses.replace(more, modes=(1, 2, 3, 4))) == sk.NONLINEAR
        for wide in (5, 16, 33):
            modes = tuple(range(1, wide + 1))
            assert sk.layout(dataclasses.replace(more, modes=modes)) == sk.RECOMPUTE
            assert sk.layout(dataclasses.replace(c, modes=modes)) == sk.NONLINEAR
        assert sk.layout(c, stream_v1=False) == sk.RECOMPUTE
    big = dataclasses.replace(cfg, nparticle_max=2 * sk.REBUILD_V1_MIN_MARKERS)
    assert sk.layout(dataclasses.replace(big, linear=True), stream_v1=False) == sk.LINEAR
    assert sk.layout(dataclasses.replace(big, deltaf=False), stream_v1=True) == sk.FULLF


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stream_v1_env_bitwise_equals_recompute(bf16, monkeypatch):
    """The port's counterpart of tests/test_spectral_path.py:504-528: three
    steps with PIC1DP_STREAM_V1=0 (substep 2 rebuilds v1) equal three with
    PIC1DP_STREAM_V1=1 (v1 streamed) bit for bit."""
    cfg = tcfg_mod.bump_on_tail_default(nx=192, nparticle_max=4096, verbosity=0,
                                        bf16_weights=bf16)
    streamed, rebuilt = (_stepper(cfg, monkeypatch, v) for v in ("1", "0"))
    assert streamed.stream_v1 and streamed.substeps.layout == sk.NONLINEAR
    assert not rebuilt.stream_v1 and rebuilt.substeps.layout == sk.RECOMPUTE
    assert [k.name for k in rebuilt.substeps.counters] == [
        f"substep{i}_recompute{'_bf16' if bf16 else ''}" for i in (1, 2)]
    state = streamed.initial_field(load_particles(cfg, "cpu"))
    a, b = state.clone(), state.clone()
    for _ in range(3):
        a, b = streamed.step(a), rebuilt.step(b)
    for field in ("x", "v", "w", "mode_re", "mode_im"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_stream_v1_env_read_once_per_stepper(monkeypatch):
    """The variable is read when a Stepper is made, and only for nonlinear
    delta-f; a later change reaches the next Stepper only.  Unset, the
    layout is the config's (substep_kernels.layout: the one measured faster
    on the H100 for its kernel, PERF.md)."""
    cfg = tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=1024, dtype="float64")
    monkeypatch.setenv("PIC1DP_STREAM_V1", "0")
    st = Stepper(cfg, "cpu")
    monkeypatch.setenv("PIC1DP_STREAM_V1", "1")
    assert not st.stream_v1 and st.substeps.layout == sk.RECOMPUTE
    assert Stepper(cfg, "cpu").substeps.layout == sk.NONLINEAR
    monkeypatch.delenv("PIC1DP_STREAM_V1")
    many = dataclasses.replace(cfg, nparticle_max=sk.REBUILD_V1_MIN_MARKERS + 1)
    for c, layout in ((cfg, sk.NONLINEAR), (many, sk.RECOMPUTE),
                      (dataclasses.replace(many, modes=(1, 2)), sk.NONLINEAR)):
        st = Stepper(c, "cpu")
        assert sk.layout(c) == st.substeps.layout == layout
        assert st.stream_v1 == (layout == sk.NONLINEAR)
    monkeypatch.setenv("PIC1DP_STREAM_V1", "not read")
    for other, layout in ((dict(linear=True), sk.LINEAR), (dict(deltaf=False), sk.FULLF)):
        st = Stepper(dataclasses.replace(cfg, **other), "cpu")
        assert not st.stream_v1 and st.substeps.layout == layout


def test_format_phase_table_matches_jax():
    table = dict(zip(_jax_keys(), (1.25e-4, 3.5e-5, 4e-5, 2.5e-6, 6.1e-5, 9.3e-5,
                                   2.025e-4, 2.05e-4)))
    assert phase_split.format_phase_table(table) == jax_phase_split.format_phase_table(table)
    tiny = dict.fromkeys(table, 1e-9)
    assert phase_split.format_phase_table(tiny) == jax_phase_split.format_phase_table(tiny)


def _jax_keys():
    """The JAX package's phase-table keys in the order it fills them (its
    fused-kernel path included), read from its source."""
    src = (REPO / "pic1dp_tpu/utils/phase_split.py").read_text()
    keys = re.findall(r'table\["([^"]+)"\] =', src)
    assert len(keys) == 8
    return keys


@pytest.mark.parametrize("stream_v1", ["1", "0"], ids=["streamed", "recompute"])
def test_measure_phase_split_keys_on_cpu(stream_v1, monkeypatch):
    cfg = tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=4096, dtype="float64",
                                        verbosity=0)
    st = _stepper(cfg, monkeypatch, stream_v1)
    state = st.initial_field(load_particles(cfg, "cpu"))
    before = state.clone()
    table = phase_split.measure_phase_split(st, state, steps=2)
    assert list(table) == _jax_keys()
    assert all(np.isfinite(v) and v >= 0.0 for v in table.values())
    assert table["sum of phases (unfused)"] == pytest.approx(
        sum(table[k] for k in _jax_keys()[:4]))
    for field in ("x", "v", "w", "mode_re", "mode_im"):       # the loops ran on copies
        assert torch.equal(getattr(state, field), getattr(before, field)), field


_TINY = ["--device", "cpu", "-s", "nparticle_max=4096", "-s", "nx=64", "-s", "time_max=0.5",
         "-s", "dtype='float64'", "-s", "verbosity=0"]


def test_run_phase_table_prints_the_table(tmp_path, capsys):
    assert trun.main(_TINY + ["-o", str(tmp_path), "--phase-table"]) == 0
    err = capsys.readouterr().err
    assert "Info: per-phase step decomposition (scan-slope method):" in err
    for key in _jax_keys() + ["fusion gain"]:
        assert re.search(rf"^\s*{re.escape(key)}\s+-?\d+\.\d{{4}}\s", err, re.M), key


def test_run_profile_writes_a_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert trun.main(_TINY + ["--no-output", "--profile", str(trace_dir)]) == 0
    path = trace_dir / trun.TRACE_FILE
    assert f"profiler trace written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    names = {ev.get("name", "") for ev in events}
    assert len(events) > 10 and any("aten::" in n for n in names)
