"""The port's particle optimization (core/optimize.py, Stepper.push_pair /
apply_optimizations, the scheduled-event main loop) against the JAX package, in
float64 on the CPU.  Both packages get one JAX-loaded state and the same
random numbers (drawn once with jax.random).  Tolerances: live masks equal
exactly; the profile and x, v, p, w within 1e-12 of each field's max; the
merge oracle's own bounds (tests/test_merge_oracle.py)."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host, to_jax, to_port

import test_merge_oracle as oracle
from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.core import optimize as jopt
from pic1dp_tpu.core.diagnostics import dist_pertb_abs_v as jax_profile
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.simulation import Simulation as JaxSimulation
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core import optimize as topt
from pic1dp_tpu_torch.core.diagnostics import dist_pertb_abs_v
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.core.step import Stepper

PARTICLE_FIELDS = ("x", "v", "p", "w")


def _cfg(mod, n=8192, **over):
    return mod.landau_damping(nx=32, nparticle=n, amp=1e-2, dtype="float64", verbosity=0,
                              **over)


@pytest.fixture(scope="module")
def loaded():
    """tests/test_optimize.py's _loaded: a Landau state after 10 steps, so
    that w has structure in v; as a JAX state and moved into the port."""
    jcfg = _cfg(jcfg_mod)
    st = JaxStepper(jcfg)
    state = st.initial_field(jax_load(jcfg, jax.random.PRNGKey(3)))
    for _ in range(10):
        state = st.step(state)
    return jcfg, _cfg(tcfg_mod), state


def _half_dead(jstate):
    """Every other slot dead, its p and w zeroed: room for split."""
    live = jstate.live & (jnp.arange(jstate.live.shape[1]) % 2 == 0)
    return dataclasses.replace(jstate, live=live, p=jnp.where(live, jstate.p, 0.0),
                               w=jnp.where(live, jstate.w, 0.0))


def _assert_states_agree(got: SimState, want, msg: str):
    np.testing.assert_array_equal(host(got.live), np.asarray(want.live), err_msg=f"{msg}: live")
    for f in PARTICLE_FIELDS:
        assert_rel(getattr(got, f), getattr(want, f), 1e-12, f"{msg}: {f}")


def _randoms(jcfg, jstate, seed):
    """The dice and normals jax's apply_optimizations draws from key `seed`,
    as numpy arrays, and that key."""
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    ns, n = jstate.x.shape
    dice = jax.random.uniform(k1, (ns, n), jstate.x.dtype)
    normals = jax.random.normal(k2, (ns, n, jcfg.optimization.split_ngroup), jstate.x.dtype)
    return key, np.array(dice), np.array(normals)


# ---- the profile ----

def test_profile_matches_jax(loaded):
    jcfg, tcfg, jstate = loaded
    want = jopt._profile(jcfg, jstate)
    got = topt._profile(tcfg, to_port(jstate))
    assert got.shape == (1, tcfg.nv)
    assert_rel(got, want, 1e-12, "profile")


def test_profile_two_species_and_out_of_range_markers():
    rng = np.random.default_rng(0)
    v = rng.uniform(-9.0, 9.0, (2, 3000))      # some beyond v_max = 8
    w = rng.normal(size=(2, 3000))
    live = rng.uniform(size=(2, 3000)) < 0.8
    want = jax_profile(jnp.asarray(v), jnp.asarray(w), jnp.asarray(live), 8.0, 48, chunk=512)
    got = dist_pertb_abs_v(torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(live),
                           8.0, 48)
    assert_rel(got, want, 1e-12, "two-species profile")
    df_t = topt._df_at_particles(got[1], torch.from_numpy(v[1]), 8.0, 48)
    df_j = jopt._df_at_particles(want[1], jnp.asarray(v[1]), 8.0, 48)
    assert_rel(df_t, df_j, 1e-12, "profile at the markers, clamped at the edges")


# ---- merge ----

@pytest.mark.parametrize("thsh", [0.3, 0.5])
def test_merge_matches_jax(loaded, thsh):
    jcfg, tcfg, jstate = loaded
    want = jopt.merge_particles(jcfg, jstate, thsh)
    got = topt.merge_particles(tcfg, to_port(jstate), thsh)
    assert int(got.live.sum()) < int(jstate.live.sum())
    _assert_states_agree(got, want, f"merge {thsh}")


def test_merge_conserves_moments_and_spares_important_markers(loaded):
    """tests/test_optimize.py TestMerge on the port."""
    _, tcfg, jstate = loaded
    state = to_port(jstate)
    merged = topt.merge_particles(tcfg, state, 0.3)
    for f in ("p", "w"):
        a = torch.where(state.live, getattr(state, f), 0.0).sum()
        b = torch.where(merged.live, getattr(merged, f), 0.0).sum()
        np.testing.assert_allclose(host(b), host(a), rtol=1e-12, err_msg=f)
    prof = topt._profile(tcfg, state)
    df = topt._df_at_particles(prof[0], state.v[0], tcfg.v_max, tcfg.nv)
    important = state.live[0] & (df >= prof[0].max() * 0.3)
    assert torch.equal(merged.x[0][important], state.x[0][important])
    assert bool(merged.live[0][important].all())


def _port_merge(cfg, x, v, p, w, thsh):
    z = torch.zeros
    state = SimState(*(torch.from_numpy(np.asarray([a])) for a in (x, v, p, w)),
                     live=torch.ones((1, len(x)), dtype=torch.bool), rho=z(cfg.nx),
                     electric=z(cfg.nx), mode_re=z(cfg.nmode), mode_im=z(cfg.nmode))
    out = topt.merge_particles(cfg, state, thsh)
    live = host(out.live[0])
    return tuple(host(getattr(out, f)[0])[live] for f in "xvpw"), host(topt._profile(cfg, state))[0]


def _oracle_cfg():
    return tcfg_mod.landau_damping(nx=8, nparticle=1024, dtype="float64", verbosity=0, nv=8)


def test_merge_oracle_identical_when_no_backfill_interference():
    """tests/test_merge_oracle.py's first test on the port's merge."""
    cfg = _oracle_cfg()
    rng = np.random.default_rng(3)
    n = 256
    x, v, p, w = oracle._random_particles(rng, n, cfg)
    v[-64:] = cfg.v_max * 0.99
    w[-64:] = 50.0
    (xb, vb, pb, wb), profile = _port_merge(cfg, x, v, p, w, 0.5)
    xo, vo, po, wo = oracle.reference_merge(x, v, p, w, profile, 0.5, cfg.lx, cfg.nx,
                                            cfg.v_max, cfg.nv)
    assert len(xo) < n and len(xo) == len(xb)
    np.testing.assert_allclose(oracle._sorted_tuples((xo, vo, po, wo)),
                               oracle._sorted_tuples((xb, vb, pb, wb)), rtol=0, atol=1e-11)


def test_merge_oracle_invariants_under_backfill_interference():
    cfg = _oracle_cfg()
    for seed in range(5):
        rng = np.random.default_rng(seed)
        x, v, p, w = oracle._random_particles(rng, 512, cfg)
        (xb, vb, pb, wb), profile = _port_merge(cfg, x, v, p, w, 0.9)
        xo, vo, po, wo = oracle.reference_merge(x, v, p, w, profile, 0.9, cfg.lx, cfg.nx,
                                                cfg.v_max, cfg.nv)
        assert len(xo) < 512 and len(xo) == len(xb), (seed, len(xo), len(xb))
        for qo, qb in zip(oracle._per_bin_sums(cfg, xo, vo, po, wo),
                          oracle._per_bin_sums(cfg, xb, vb, pb, wb)):
            np.testing.assert_allclose(qo, qb, rtol=0, atol=1e-11)


def test_merge_oracle_conserves_totals():
    cfg = _oracle_cfg()
    rng = np.random.default_rng(11)
    x, v, p, w = oracle._random_particles(rng, 512, cfg)
    (xb, vb, pb, wb), _ = _port_merge(cfg, x, v, p, w, 0.9)
    np.testing.assert_allclose(pb.sum(), p.sum(), rtol=1e-12)
    np.testing.assert_allclose(wb.sum(), w.sum(), rtol=1e-12)
    np.testing.assert_allclose((wb * xb).sum(), (w * x).sum(), rtol=1e-11)
    np.testing.assert_allclose((wb * vb).sum(), (w * v).sum(), rtol=1e-11)


# ---- remove ----

@pytest.mark.parametrize("typeremove,thsh", [(2, 0.0), (1, 0.4)])
def test_remove_matches_jax(loaded, typeremove, thsh):
    jcfg, tcfg, jstate = loaded
    opt = dict(typeremove=typeremove, remove_frac=0.5)
    jcfg = dataclasses.replace(jcfg, optimization=jcfg_mod.OptimizationConfig(**opt))
    tcfg = dataclasses.replace(tcfg, optimization=tcfg_mod.OptimizationConfig(**opt))
    key = jax.random.PRNGKey(7)
    dice = np.array(jax.random.uniform(key, jstate.x.shape, jstate.x.dtype))
    want = jopt.remove_particles(jcfg, jstate, key, thsh)
    state = to_port(jstate)
    got = topt.remove_particles(tcfg, state, torch.from_numpy(dice), thsh)
    assert int(got.live.sum()) < int(jstate.live.sum())
    _assert_states_agree(got, want, f"remove type {typeremove}")
    assert torch.equal(got.x, state.x) and torch.equal(got.v, state.v)
    # survivors: p and w scaled by the same factor >= 1
    both = state.live[0] & got.live[0]
    pr, wr = (got.p[0] / state.p[0])[both], (got.w[0] / state.w[0])[both]
    np.testing.assert_allclose(host(pr), host(wr), rtol=1e-10)
    assert bool((pr >= 1.0 - 1e-12).all())


def test_remove_zero_profile_is_noop():
    """tests/test_optimize.py:144 on the port: an identically-zero profile
    must not NaN the weights."""
    cfg = _cfg(tcfg_mod, n=4096)
    cfg = dataclasses.replace(cfg, init_amp_sin=(0.0,), init_amp_cos=(0.0,))
    sim = Simulation(cfg, device="cpu")
    state = sim.load()
    assert float(state.w.abs().max()) == 0.0
    dice = torch.rand(state.x.shape, dtype=state.x.dtype,
                      generator=torch.Generator().manual_seed(1))
    out = topt.remove_particles(cfg, state, dice, 0.0)
    assert bool(torch.isfinite(out.p).all())
    assert torch.equal(out.p, state.p) and torch.equal(out.live, state.live)


# ---- split ----

@pytest.mark.parametrize("thsh", [0.5, 0.05])
def test_split_matches_jax(loaded, thsh):
    """thsh 0.05 makes more parents eligible than the dead slots hold, so
    the capacity guard cuts the list."""
    jcfg, tcfg, jstate = loaded
    jstate = _half_dead(jstate)
    key = jax.random.PRNGKey(9)
    g = jcfg.optimization.split_ngroup
    normals = np.array(jax.random.normal(key, (1, jstate.x.shape[1], g), jstate.x.dtype))
    want = jopt.split_particles(jcfg, jstate, key, thsh)
    state = to_port(jstate)
    got = topt.split_particles(tcfg, state, torch.from_numpy(normals), thsh)
    n0, n1 = int(state.live.sum()), int(got.live.sum())
    assert n1 > n0 and (n1 - n0) % (2 * g - 1) == 0
    _assert_states_agree(got, want, f"split {thsh}")
    for f in ("p", "w"):
        a = torch.where(state.live, getattr(state, f), 0.0).sum()
        b = torch.where(got.live, getattr(got, f), 0.0).sum()
        np.testing.assert_allclose(host(b), host(a), rtol=1e-12, err_msg=f)


def test_split_capacity_guard(loaded):
    _, tcfg, jstate = loaded
    state = to_port(jstate)   # every slot live: no room at all
    normals = torch.randn((1, state.x.shape[1], tcfg.optimization.split_ngroup),
                          dtype=state.x.dtype, generator=torch.Generator().manual_seed(10))
    out = topt.split_particles(tcfg, state, normals, 0.01)
    assert torch.equal(out.live, state.live) and torch.equal(out.v, state.v)


# ---- all three, and the stepper's entry points ----

def test_apply_optimizations_matches_jax(loaded):
    jcfg, tcfg, jstate = loaded
    jstate = _half_dead(jstate)
    key, dice, normals = _randoms(jcfg, jstate, 4)
    want = jopt.apply_optimizations(jcfg, None, jstate, key, merge=0.5, remove=0.0, split=0.6)
    got = topt.apply_optimizations(tcfg, to_port(jstate), torch.from_numpy(dice),
                                   torch.from_numpy(normals), merge=0.5, remove=0.0, split=0.6)
    _assert_states_agree(got, want, "merge + remove + split")
    dead = ~got.live
    assert float(got.p[dead].abs().max()) == 0.0 and float(got.w[dead].abs().max()) == 0.0


def test_apply_optimizations_leaves_its_input_alone(loaded):
    _, tcfg, jstate = loaded
    state = to_port(_half_dead(jstate))
    before = state.clone()
    st = Stepper(tcfg, "cpu")
    out = st.apply_optimizations(state, torch.Generator().manual_seed(0), merge=0.5,
                                 remove=0.0, split=0.6)
    for f in PARTICLE_FIELDS + ("live",):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
        assert getattr(out, f).is_contiguous()
    assert not torch.equal(out.live, state.live)


def test_optimizations_preserve_bf16_p_dtype():
    """tests/test_optimize.py:157 on the port: p comes back bfloat16 and the
    dead-slot invariant holds."""
    cfg = dataclasses.replace(
        tcfg_mod.landau_damping(nx=32, nparticle=8192, amp=1e-2, dtype="float32", verbosity=0),
        bf16_weights=True)
    sim = Simulation(cfg, device="cpu")
    state = sim.stepper.multi_step(sim.load(), 5)
    out = sim.stepper.apply_optimizations(state, sim.generator, merge=0.5, remove=0.3, split=2.0)
    assert out.p.dtype == torch.bfloat16 and out.w.dtype == torch.float32
    assert out.x.dtype == out.v.dtype == torch.float32
    dead = ~out.live
    assert float(out.p[dead].float().abs().max()) == 0.0
    assert float(out.w[dead].abs().max()) == 0.0


@pytest.mark.parametrize("shape", ["MATRIX_FREE", "EXPLICIT"])
def test_optimization_step_matches_jax(loaded, shape):
    """push_pair, apply_optimizations with shared numbers, collect_and_solve:
    one whole optimization step in both packages, on both paths."""
    jcfg, tcfg, jstate = loaded
    jcfg = dataclasses.replace(jcfg, shape=jcfg_mod.ParticleShape[shape])
    tcfg = dataclasses.replace(tcfg, shape=tcfg_mod.ParticleShape[shape])
    jst, st = JaxStepper(jcfg), Stepper(tcfg, "cpu")
    jstate = jst.initial_field(_half_dead(jstate))
    key, dice, normals = _randoms(jcfg, jstate, 5)
    want = jst.collect_and_solve(jst.apply_optimizations(
        jst.push_pair(jstate), key, merge=0.4, remove=0.0, split=0.6))
    pushed = st.push_pair(to_port(jstate))
    got = st.collect_and_solve(topt.apply_optimizations(
        tcfg, pushed, torch.from_numpy(dice), torch.from_numpy(normals),
        merge=0.4, remove=0.0, split=0.6))
    _assert_states_agree(got, want, shape)
    for f in ("mode_re", "mode_im", "electric"):
        assert_rel(getattr(got, f), getattr(want, f), 1e-12, f"{shape}: {f}")


# ---- the scheduled run ----

def _scheduled(mod, **kw):
    return dataclasses.replace(
        _cfg(mod, time_max=4.0, output_interval=0.5, **kw),
        optimization=mod.OptimizationConfig(
            tmerge=(1.0,), thshmerge=(0.4,), tremove=(2.0,), thshremove=(),
            tsplit=(3.0,), thshsplit=(0.6,)))


def test_scheduled_optimization_run():
    """tests/test_optimize.py:117-141 on the port."""
    sim = Simulation(_scheduled(tcfg_mod), device="cpu")
    counts, snaps = [], []

    def cb(s):
        snaps.append(s)
        counts.append(int(sim.state.nparticles().sum()))

    sim.run(snapshot_callback=cb)
    assert len(set(counts)) > 1, "optimizations never changed the count"
    assert all(np.isfinite(s["field_energy"]) for s in snaps)
    assert [s["time"] for s in snaps] == pytest.approx(np.arange(9) * 0.5)
    dead = ~sim.state.live
    assert float(sim.state.p[dead].abs().max()) == 0.0
    assert float(sim.state.w[dead].abs().max()) == 0.0
    assert (sim._imerge, sim._iremove, sim._isplit) == (1, 1, 1)
    assert sim.itime == 80
    for phase in ("step: push pair", "optimize particle", "step: collect + solve"):
        assert sim.timers.seconds(phase) > 0.0, phase


def test_schedule_walk_matches_jax():
    """The same events at the same steps: _plain_steps_ahead and
    _optimization_due of both packages' Simulation, walked over the whole schedule."""
    jsim = JaxSimulation(_scheduled(jcfg_mod))
    sim = Simulation(_scheduled(tcfg_mod), device="cpu")
    events = []
    while not sim._check_termination():
        kj, kt = jsim._plain_steps_ahead(), sim._plain_steps_ahead()
        assert kj == kt
        k, itime, time = kt
        if k == 0:
            due = sim._optimization_due()
            assert due == jsim._optimization_due()
            events.append((sim.itime, due))
            for s in (sim, jsim):
                s._imerge += due[0] is not None
                s._iremove += due[1] is not None
                s._isplit += due[2] is not None
                s.itime, s.time = s.itime + 1, s.time + s.cfg.dt
        else:
            for s in (sim, jsim):
                s.itime, s.time = itime, time
    # the step that crosses t = 1, 2, 3 (time is a running sum of dt = 0.05,
    # so a crossing may fall one step late, in both packages alike)
    assert all(0 <= e[0] - want <= 1 for e, want in zip(events, (19, 39, 59)))
    assert [e[1] for e in events] == [(0.4, None, None), (None, 0.0, None), (None, None, 0.6)]


def test_merge_run_matches_jax(tmp_path):
    """A run with a merge event (no random numbers) through both packages'
    Simulation from one state: every snapshot agrees."""
    def cfg(mod):
        return dataclasses.replace(
            _cfg(mod, time_max=1.0, output_interval=0.25),
            optimization=mod.OptimizationConfig(tmerge=(0.5,), thshmerge=(0.4,)))

    raw = jax_load(cfg(jcfg_mod), jax.random.PRNGKey(2))
    snaps = {"jax": [], "torch": []}
    jsim = JaxSimulation(cfg(jcfg_mod))
    jsim.state = jsim.stepper.initial_field(raw)
    jsim.run(snapshot_callback=snaps["jax"].append)
    sim = Simulation(cfg(tcfg_mod), device="cpu")
    sim.state = sim.stepper.initial_field(to_port(raw))
    sim.run(snapshot_callback=snaps["torch"].append)
    assert sim._imerge == 1 and int(sim.state.live.sum()) < 8192
    np.testing.assert_array_equal(host(sim.state.live), np.asarray(jsim.state.live))
    for a, b in zip(snaps["torch"], snaps["jax"]):
        assert a["time"] == b["time"]
        np.testing.assert_allclose(a["field_energy"], b["field_energy"], rtol=1e-10)
        for key in ("marker", "total", "pertb", "mode_re", "mode_im"):
            assert_rel(a[key], b[key], 1e-12, f"t={a['time']}:{key}")


def test_fullf_ignores_the_schedule():
    """Optimization is delta-f only (reference :762)."""
    cfg = dataclasses.replace(_scheduled(tcfg_mod, n=2048), deltaf=False, time_max=1.5)
    sim = Simulation(cfg, device="cpu")
    sim.run()
    assert (sim._imerge, sim._iremove, sim._isplit) == (0, 0, 0)
    assert int(sim.state.live.sum()) == 2048


@pytest.mark.parametrize("verbosity", [1, 2])
def test_verbosity_lines_with_optimization(verbosity):
    """tests/test_verbosity.py's optimize=True cases on the port."""
    cfg = tcfg_mod.bump_on_tail_default(
        nx=64, nparticle_max=8192, time_max=1.0, output_interval=0.5, dtype="float64",
        verbosity=verbosity,
        optimization=tcfg_mod.OptimizationConfig(tmerge=(0.6,), thshmerge=(0.3,)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        Simulation(cfg, device="cpu").run()
    err = err.getvalue()
    if verbosity == 1:
        assert "pic1dp_tpu_torch version" in err
        assert "progrss  itime     time  int E^2 dx" in err
        assert ": optimization performed, current # of particles" in err
        assert "Info: finished" not in err
    else:
        assert "Info: finished itime =" in err
        assert "Info: particle_optimize performed, current # of particles:" in err
        assert "progrss" not in err and "Info: diagnostics:" not in err
    for phase in ("step: push pair", "optimize particle", "step: collect + solve"):
        assert phase in err


def test_jax_state_round_trip_helper(loaded):
    """to_jax(to_port(s)) is s: the parity tests above compare like with like."""
    _, _, jstate = loaded
    back = to_jax(to_port(jstate))
    for f in PARTICLE_FIELDS + ("live",):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(jstate, f)))
