"""The recompute layout rebuilds w1 in substep 2 (ops/substep_kernels.py,
csrc/substep_kernels.cu): substep 1 writes no marker stream, substep 2
rebuilds v1 and w1 from E at x0 of the step-start modes, and the Stepper
counts each such substep 2 as "w1 rebuilds".

On the CPU: a run counts one rebuild a step in the recompute layout, the
steps with an optimization event (push_pair) included, and none in the
streamed, linear and full-f layouts.  The tests marked `chip` run on a
CUDA device only: the recompute kernels after one step equal the plain
versions at chip_smoke.py's bounds and the streamed kernels bit for bit, in
f32 and bf16_weights at 6.4M markers and in the grid bin at 32 modes, and
a CUDA graph's replays count one rebuild a replayed step.  This file
imports no jax, so the card's machine runs it:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_w1_rebuild.py -m chip"""

import dataclasses

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import OptimizationConfig, landau_damping
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk

SMALL = dict(nx=64, nparticle_max=4096, time_max=1.0, dtype="float64", verbosity=0)


def _landau(**kw):
    cfg = landau_damping(nx=SMALL["nx"], nparticle=SMALL["nparticle_max"],
                         time_max=SMALL["time_max"])
    return dataclasses.replace(cfg, verbosity=0, dtype="float64", **kw).validate()


# (config, PIC1DP_STREAM_V1, the layout the Stepper takes)
RUNS = {
    "recompute": (lambda: bot(**SMALL), "0", sk.RECOMPUTE),
    "recompute_events": (lambda: bot(**dict(SMALL, optimization=OptimizationConfig(
        tmerge=(0.3, 0.7), thshmerge=(0.3, 0.3)))), "0", sk.RECOMPUTE),
    "streamed": (lambda: bot(**SMALL), "1", sk.NONLINEAR),
    "linear": (lambda: _landau(linear=True), "0", sk.LINEAR),
    "fullf": (lambda: _landau(deltaf=False), "0", sk.FULLF),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_a_run_counts_one_rebuild_a_recompute_step(case, tmp_path, monkeypatch):
    """"w1 rebuilds" equals the steps run in the recompute layout, the
    steps of the optimization path (push_pair) included, and is 0 in the
    layouts that stream w1 or take none."""
    make, env, layout = RUNS[case]
    monkeypatch.setenv("PIC1DP_STREAM_V1", env)
    sim = Simulation(make(), out_path=str(tmp_path), device="cpu")
    monkeypatch.delenv("PIC1DP_STREAM_V1")
    assert sim.stepper.substeps.layout == layout
    assert sim.stepper.substeps.rebuilds_w1 == (layout == sk.RECOMPUTE)
    sim.run()
    assert sim.itime > 0
    rebuilds = sim.timers.counter("w1 rebuilds")
    assert rebuilds == (sim.itime if layout == sk.RECOMPUTE else 0)


# ---- on a CUDA device ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the substep kernels run on the card only")
    return torch.device("cuda")


FULL_N = 6_400_000
# chip_smoke.py's f32 bounds (tests/test_spectral_path.py:141-170): x and v
# absolute, w and the projections relative to their max
F32_TOL = dict(x=5e-5, v=1e-5, w=1e-4, proj=1e-4)

CHIP_CASES = {
    "f32": lambda: bot(nparticle_max=FULL_N, verbosity=0),
    "bf16_weights": lambda: bot(nparticle_max=FULL_N, verbosity=0, bf16_weights=True),
    "grid_32_modes": lambda: dataclasses.replace(
        bot(nparticle_max=FULL_N, verbosity=0), modes=tuple(range(1, 33)), init_modes=(1,),
        init_amp_cos=(0.0,), init_amp_sin=(bot().init_amp_sin[0],)).validate(),
}


def _inputs(cfg, device):
    """The loader's markers for cfg and mode components of a saturated
    amplitude (step-start and midpoint)."""
    dtype = getattr(torch, cfg.dtype)
    st = load_particles(cfg, device)
    rng = np.random.default_rng(20261018)
    modes = [torch.from_numpy(rng.uniform(-0.05, 0.05, cfg.nmode)).to(device, dtype)
             for _ in range(4)]
    return st, modes, dist.SpeciesParams.from_config(cfg, dtype, device)


def _step(subs, st, modes, kernel: bool):
    """One step of both substeps of subs on copies of st's x, v, w:
    (substep 1's w1, v1 and projections, x2, v2, w2, substep 2's
    projections)."""
    mre0, mim0, mre1, mim1 = modes
    x, v, w = (t.clone() for t in (st.x, st.v, st.w))
    one = subs.substep1 if kernel else subs.substep1_plain
    two = subs.substep2 if kernel else subs.substep2_plain
    w1, v1, proj1 = one(x, v, st.p, w, mre0, mim0)
    x2, v2, w2, proj2 = two(x, v, st.p, w, w1, v1, mre1, mim1, mre0, mim0)
    return w1, v1, torch.stack(proj1), x2, v2, w2, torch.stack(proj2)


def _max_err(got, want, periodic=None):
    d = got.double() - want.double()
    if periodic is not None:
        d = torch.remainder(d + 0.5 * periodic, periodic) - 0.5 * periodic
    return float(d.abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CHIP_CASES))
def test_the_recompute_kernels_rebuild_w1(cuda, case):
    """No w1 or v1 leaves substep 1; after one step x2, v2, w2 and both
    substeps' projections are the plain versions' within chip_smoke.py's
    f32 bounds, and the streamed layout's kernels' bit for bit."""
    cfg = CHIP_CASES[case]()
    st, modes, sp = _inputs(cfg, cuda)
    rebuilt = sk.FusedSubsteps(cfg, sp, stream_v1=False)
    streamed = sk.FusedSubsteps(cfg, sp, stream_v1=True)
    assert rebuilt.layout == sk.RECOMPUTE and rebuilt.uses_grid_bin() == (cfg.nmode > 4)
    kernel = _step(rebuilt, st, modes, kernel=True)
    plain = _step(rebuilt, st, modes, kernel=False)
    other = _step(streamed, st, modes, kernel=True)
    torch.cuda.synchronize()
    assert kernel[0] is None and kernel[1] is None and plain[0] is None
    assert other[0] is not None and other[1] is not None
    for got, want in zip(kernel[2:], other[2:]):
        assert torch.equal(got, want)
    proj1, x2, v2, w2, proj2 = kernel[2:]
    pproj1, px2, pv2, pw2, pproj2 = plain[2:]
    assert _max_err(x2, px2, cfg.lx) <= F32_TOL["x"]
    assert _max_err(v2, pv2) <= F32_TOL["v"]
    for label, got, want in (("w2", w2, pw2), ("proj1", proj1, pproj1),
                             ("proj2", proj2, pproj2)):
        scale = float(want.double().abs().max())
        assert _max_err(got, want) <= F32_TOL["proj" if label.startswith("proj") else "w"] \
            * scale, label


@pytest.mark.chip
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_weights"])
def test_graph_replays_count_one_rebuild_a_step(cuda, bf16, monkeypatch):
    """Eager steps and a CUDA graph's replayed steps each count one
    "w1 rebuilds", as many as substep 2 kernels launched, and the replays
    are the eager steps bit for bit."""
    monkeypatch.setenv("PIC1DP_STREAM_V1", "0")
    cfg = bot(nparticle_max=1 << 20, verbosity=0, bf16_weights=bf16)
    graphed, eager = Stepper(cfg, cuda), Stepper(cfg, cuda)
    monkeypatch.delenv("PIC1DP_STREAM_V1")
    s0 = graphed.initial_field(load_particles(cfg, cuda))
    a, b = s0.clone(), s0.clone()
    kernel = graphed.substeps.counters[1]
    before = kernel.launches
    a = graphed.multi_step(a, 3)              # eager: loads the kernels
    a = graphed.multi_step(a, 7)              # one graph of 7 steps, replayed
    a = graphed.multi_step(a, 7)
    for _ in range(17):
        b = eager.step(b)
    torch.cuda.synchronize()
    t = graphed.timers
    assert t.counter("graph replays") == 2
    assert t.counter("w1 rebuilds") == 17 == eager.timers.counter("w1 rebuilds")
    assert kernel.launches - before == 2 * 17
    for f in ("x", "v", "w", "mode_re", "mode_im"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
