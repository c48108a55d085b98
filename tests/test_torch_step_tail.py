"""The step's tail: the substeps solve their own modes, and E and rho on the
grid are formed once after k steps (Stepper.advance), not once a step.

On the CPU the substeps run their plain versions; with solve=True they hand
back the modes of their own projections, which must be Stepper._solve's bit
for bit (on the card the kernels' last block computes the same two products
from the same factor g; chip_smoke.py holds them there).  advance(state, k)
must be k calls of `step` bit for bit, and k steps must match the JAX
package's make_multi_step in float64 at 1e-12 of each field's max over the
variants tests/test_torch_step.py steps.  torch runs on two threads
(_torch_port).
"""

import dataclasses

import jax
import pytest
import torch
from _torch_port import CASES, WIDE_CASES, assert_rel, to_port
from test_torch_step import STEP_CASES, _pair

from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk

FIELDS = ("x", "v", "w", "mode_re", "mode_im", "electric", "rho")


def _cfg(dtype: str, nmode: int, nspecies: int):
    """Nonlinear delta-f with modes 1..nmode (mode 1 perturbed): the
    bump-on-tail case at one species, Landau damping carried by nine
    identical species at nine; dtype "bf16" is float32 with bf16_weights."""
    base = "float32" if dtype == "bf16" else dtype
    if nspecies == 1:
        cfg = CASES["bot_nonlinear_deltaf"](tcfg_mod, base)
        cfg = dataclasses.replace(cfg, nx=64, nparticle_max=1024)
    else:
        cfg = dataclasses.replace(WIDE_CASES["landau_9_species"](tcfg_mod, base),
                                  nparticle_max=256)
    cfg = dataclasses.replace(cfg, modes=tuple(range(1, nmode + 1)), init_modes=(1,),
                              init_amp_cos=(0.0,), init_amp_sin=(cfg.init_amp_sin[0],),
                              bf16_weights=dtype == "bf16")
    return cfg.validate()


def _stepper(cfg, monkeypatch, stream_v1: bool) -> Stepper:
    monkeypatch.setenv("PIC1DP_STREAM_V1", str(int(stream_v1)))
    return Stepper(cfg, "cpu")


def _equal(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b, strict=True))


@pytest.mark.parametrize("stream_v1", [True, False], ids=["streamed", "recompute"])
@pytest.mark.parametrize("nspecies", [1, 9])
@pytest.mark.parametrize("nmode", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bf16"])
def test_plain_substeps_solve_their_projections(dtype, nmode, nspecies, stream_v1,
                                                monkeypatch):
    """Both substeps with solve=True hand back Stepper._solve of their own
    projections bit for bit, through the dispatch and the plain versions,
    and solve=False returns what it returned before: the same projections,
    no modes."""
    cfg = _cfg(dtype, nmode, nspecies)
    st = _stepper(cfg, monkeypatch, stream_v1)
    assert st.substeps.layout == (sk.NONLINEAR if stream_v1 else sk.RECOMPUTE)
    s = st.initial_field(load_particles(cfg, "cpu"))
    x, v, p, w, mre, mim = s.x, s.v, s.p, s.w, s.mode_re, s.mode_im
    subs = st.substeps
    w1, v1, proj1, modes1 = subs.substep1(x, v, p, w, mre, mim, solve=True)
    assert modes1[0].dtype == x.dtype and modes1[0].shape == (nmode,)
    assert _equal(modes1, st._solve(*proj1))
    unsolved = subs.substep1_plain(x, v, p, w, mre, mim)
    assert len(unsolved) == 3 and _equal(unsolved[2], proj1)
    streams = [t.clone() for t in (x, v, w)]
    *_, proj2, modes2 = subs.substep2(*streams[:2], p, streams[2], w1, v1, *modes1, mre, mim,
                                      solve=True)
    assert _equal(modes2, st._solve(*proj2))
    again = [t.clone() for t in (x, v, w)]
    unsolved = subs.substep2_plain(*again[:2], p, again[2], w1, v1, *modes1, mre, mim)
    assert len(unsolved) == 4 and _equal(unsolved[3], proj2)
    assert _equal(again, streams)


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_advance_is_k_steps_bitwise(dtype, k):
    """advance(state, k), with E and rho formed after the last step only,
    and multi_step (which runs it) are k calls of `step` bit for bit."""
    cfg = _cfg(dtype, 1, 1)
    st = Stepper(cfg, "cpu")
    s0 = st.initial_field(load_particles(cfg, "cpu"))
    want = s0.clone()
    for _ in range(k):
        want = st.step(want)
    for got in (st.advance(s0.clone(), k), st.multi_step(s0.clone(), k)):
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("nmode", [1, 16])
def test_solving_after_the_reduce_is_the_same_step(nmode):
    """A Stepper whose substeps solve nothing (a rank's, whose projections
    are partial sums: it solves after the all_reduce) steps to the same
    bits as one whose substeps solve."""
    cfg = _cfg("float32", nmode, 1)
    solving, after = Stepper(cfg, "cpu"), Stepper(cfg, "cpu")
    after.kernel_solves = False
    s0 = solving.initial_field(load_particles(cfg, "cpu"))
    a, b = solving.advance(s0.clone(), 3), after.advance(s0.clone(), 3)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", STEP_CASES)
def test_advance_matches_jax_multi_step(name):
    """k = 3 steps of advance against the JAX Stepper's make_multi_step
    from one loaded state, float64, 1e-12 of each field's max."""
    jcfg, tcfg = _pair(name)
    jst = JaxStepper(jcfg)
    a = jst.initial_field(jax_load(jcfg, jax.random.PRNGKey(5)))
    st = Stepper(tcfg, "cpu")
    t = st.advance(st.initial_field(to_port(a)), 3)
    a = jst.make_multi_step(3)(a)
    for f in FIELDS:
        assert_rel(getattr(t, f), getattr(a, f), 1e-12, f"{name}:{f}")


def test_mode_factor_is_torchs_division_and_solve_reads_it():
    """FusedSubsteps.g is grad_inv / lx by torch's own op on the species'
    device; Stepper._solve multiplies by that buffer and no other."""
    cfg = _cfg("float64", 4, 1)
    st = Stepper(cfg, "cpu")
    g = st.substeps.g
    assert g.dtype == torch.float64 and g.device == st.sp.charge.device
    assert torch.equal(g, st.spectral.grad_inv / cfg.lx)
    p_c = torch.linspace(-1.0, 1.0, cfg.nmode, dtype=torch.float64)
    p_s = torch.linspace(0.5, -2.0, cfg.nmode, dtype=torch.float64)
    assert _equal(st._solve(p_c, p_s), (-p_s * g, -p_c * g))
    st.substeps.g = 2.0 * g
    assert _equal(st._solve(p_c, p_s), (-p_s * (2.0 * g), -p_c * (2.0 * g)))
