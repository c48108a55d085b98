"""The grid bin's lane form (csrc/substep_kernels.cu, grid_lanes): where
GRID_LANE_BLOCKS blocks of its copies fit in an SM, each warp deposits onto
GRID_LANE_COPIES copies of the nx cells, each lane on its own copy in its
turn, with no __match_any_sync.

On the CPU: the Python mirror of the form's rule (ops/substep_kernels.py,
grid_lanes) over nx, the item size and the E grids, which shapes take the
form, and the grid a launch gets.  The tests marked `chip` run on a CUDA
device only: the lane form at nx 192 with 16 and 32 kept modes in f32, both
nonlinear delta-f layouts, against the plain versions at chip_smoke.py's
bounds, two launches bit for bit, the streamed and the recompute layout bit
for bit; a CUDA graph's replays equal to eager steps, with the counter
"grid-bin lane deposits" equal to the profiled lane-form launches, and at
nx 1024 the warp form.  This file imports no jax, so the card's machine runs
it: python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grid_lanes.py -m chip"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.core.step import Stepper
from pic1dp_tpu_torch.ops import substep_kernels as sk

SMS = 132                    # an H100's SMs


def _need(nx, itemsize, egrids):
    """The lane form's dynamic bytes and what GRID_LANE_BLOCKS such blocks
    hold in an SM with the static arrays and the driver's reserve."""
    nbytes = (egrids * (nx + 1) + sk.GRID_LANE_COPIES * sk.GRID_COPIES * nx) * itemsize
    block = nbytes + 2 * sk.THREADS * itemsize + 128 + sk.BLOCK_SMEM_RESERVED
    return nbytes, sk.GRID_LANE_BLOCKS * block


def _largest(itemsize, egrids):
    """The widest grid that takes the lane form."""
    nx = 1
    while _need(nx + 1, itemsize, egrids)[1] <= sk.SM_SMEM:
        nx += 1
    return nx


@pytest.mark.parametrize("egrids", [1, 2])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_grid_lanes_takes_the_lane_form_where_its_blocks_fit(itemsize, egrids):
    """grid_lanes is a pure function of its arguments, gives the lane form's
    bytes exactly where GRID_LANE_BLOCKS blocks of it fit in an SM (never
    above GRID_SMEM_MAX) and 0 (the warp form) elsewhere, from nx 1 to 300,
    around the widest grid that takes it and at the wide grids; a lane-form
    launch holds GRID_LANE_BLOCKS blocks an SM, the warp form's residency
    at those shapes."""
    assert (sk.GRID_LANE_COPIES, sk.GRID_LANE_BLOCKS, sk.GRID_COPIES) == (8, 4, 8)
    top = _largest(itemsize, egrids)
    assert top == {(4, 1): 212, (4, 2): 208, (8, 1): 102, (8, 2): 100}[itemsize, egrids]
    for nx in [*range(1, 301), top - 1, top, top + 1, 1024, 4096, 32768]:
        nbytes = sk.grid_lanes(nx, itemsize, egrids)
        assert nbytes == sk.grid_lanes(nx, itemsize, egrids)
        need, held = _need(nx, itemsize, egrids)
        assert (nbytes > 0) == (held <= sk.SM_SMEM) == (nx <= top)
        if nbytes:
            assert nbytes == need <= sk.GRID_SMEM_MAX
            assert sk.grid_blocks_per_sm(nx, itemsize, egrids) == sk.GRID_LANE_BLOCKS
        else:
            assert 1 <= sk.grid_blocks_per_sm(nx, itemsize, egrids) <= sk.BLOCKS_PER_SM


def test_the_shapes_that_take_the_lane_form():
    """nx 192 takes the lane form in f32 (50,696 bytes in substep 2), not in
    f64; nx 64 in both; nx 1024 and wider the warp form, with the parent's
    blocks an SM."""
    assert sk.grid_lanes(192, 4, 2) == 50_696 and sk.grid_lanes(192, 4, 1) == 49_924
    assert sk.grid_lanes(192, 8, 2) == sk.grid_lanes(192, 8, 1) == 0
    assert sk.grid_lanes(64, 8, 2) > 0 and sk.grid_lanes(64, 4, 2) > 0
    for nx in (1024, 4096, 32768):
        for itemsize in (4, 8):
            assert sk.grid_lanes(nx, itemsize, 2) == sk.grid_lanes(nx, itemsize, 1) == 0
    assert sk.grid_blocks_per_sm(1024, 4, 2) == 3 and sk.grid_blocks_per_sm(1024, 8, 2) == 1
    assert sk.grid_blocks_per_sm(192, 4, 2) == sk.grid_blocks_per_sm(192, 8, 2) == 4


def _modes(nmode, **kw):
    return dataclasses.replace(bot(verbosity=0, **kw), modes=tuple(range(1, nmode + 1)),
                               init_modes=(1,), init_amp_cos=(0.0,),
                               init_amp_sin=(bot().init_amp_sin[0],)).validate()


@pytest.mark.parametrize("nx,dtype,nmode,lanes", [
    (192, "float32", 32, True), (64, "float64", 16, True), (192, "float64", 16, False),
    (192, "float32", 4, False), (1024, "float32", 32, False), (4096, "float64", 16, False)])
def test_uses_grid_lanes_and_the_grid(nx, dtype, nmode, lanes):
    """uses_grid_lanes follows the shape in both substeps and both nonlinear
    layouts, only in the grid bin; a lane-form launch is GRID_LANE_BLOCKS
    blocks an SM (528 at 6.4M markers), the same grid in both layouts."""
    cfg = _modes(nmode, nx=nx, dtype=dtype, nparticle_max=1024)
    itemsize = getattr(torch, dtype).itemsize
    grids = set()
    for stream_v1 in (True, False):
        subs = sk.FusedSubsteps(cfg, dist.SpeciesParams.from_config(
            cfg, getattr(torch, dtype), "cpu"), stream_v1=stream_v1)
        for substep in (1, 2):
            assert subs.uses_grid_lanes(substep) == lanes
            grid = subs.grid_size(6_400_000, SMS, itemsize, substep)
            grids.add((substep, grid))
            if lanes:
                assert grid == sk.GRID_LANE_BLOCKS * SMS
    assert len(grids) == 2


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


def _inputs(cfg, device):
    """The loader's markers for cfg and mode components of a saturated
    amplitude (step-start and midpoint)."""
    dtype = getattr(torch, cfg.dtype)
    st = load_particles(cfg, device)
    rng = np.random.default_rng(20261019)
    modes = [torch.from_numpy(rng.uniform(-0.05, 0.05, cfg.nmode)).to(device, dtype)
             for _ in range(4)]
    return st, modes, dist.SpeciesParams.from_config(cfg, dtype, device)


def _step(subs, st, modes, kernel: bool):
    """One step of both substeps of subs on copies of st's x, v, w, each
    solving its modes: (substep 1's projections and modes, x2, v2, w2,
    substep 2's projections and modes)."""
    mre0, mim0, mre1, mim1 = modes
    x, v, w = (t.clone() for t in (st.x, st.v, st.w))
    one = subs.substep1 if kernel else subs.substep1_plain
    two = subs.substep2 if kernel else subs.substep2_plain
    w1, v1, proj1, modes1 = one(x, v, st.p, w, mre0, mim0, solve=True)
    x2, v2, w2, proj2, modes2 = two(x, v, st.p, w, w1, v1, mre1, mim1, mre0, mim0,
                                    solve=True)
    return (torch.stack(proj1), torch.stack(modes1), x2, v2, w2, torch.stack(proj2),
            torch.stack(modes2))


def _max_err(got, want, periodic=None):
    d = got.double() - want.double()
    if periodic is not None:
        d = torch.remainder(d + 0.5 * periodic, periodic) - 0.5 * periodic
    return float(d.abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("nmode", [16, 32])
def test_the_lane_form_against_the_plain_version(cuda, nmode):
    """At nx 192 in f32 with 6.4M markers, in both nonlinear layouts: the
    kernels after one step are the plain versions' within chip_smoke.py's
    f32 bounds, a second launch gives the same bits, and the streamed and
    the recompute layout give the same x2, v2, w2, projections and modes."""
    cfg = _modes(nmode, nparticle_max=FULL_N)
    st, modes, sp = _inputs(cfg, cuda)
    out = {}
    for stream_v1 in (True, False):
        subs = sk.FusedSubsteps(cfg, sp, stream_v1=stream_v1)
        assert subs.uses_grid_lanes(1) and subs.uses_grid_lanes(2)
        kernel = _step(subs, st, modes, kernel=True)
        again = _step(subs, st, modes, kernel=True)
        plain = _step(subs, st, modes, kernel=False)
        torch.cuda.synchronize()
        for got, want in zip(kernel, again):
            assert torch.equal(got, want)
        proj1, _, x2, v2, w2, proj2, _ = kernel
        pproj1, _, px2, pv2, pw2, pproj2, _ = plain
        assert _max_err(x2, px2, cfg.lx) <= F32_TOL["x"]
        assert _max_err(v2, pv2) <= F32_TOL["v"]
        for label, got, want in (("w2", w2, pw2), ("proj1", proj1, pproj1),
                                 ("proj2", proj2, pproj2)):
            scale = float(want.double().abs().max())
            tol = F32_TOL["proj" if label.startswith("proj") else "w"]
            assert _max_err(got, want) <= tol * scale, label
        out[subs.layout] = kernel
    for got, want in zip(out[sk.NONLINEAR], out[sk.RECOMPUTE]):
        assert torch.equal(got, want)


def _lane_flags(names) -> list[bool]:
    """For each grid-bin substep kernel among the device kernels' names,
    whether it is the lane form (a last template argument kLanes):
    demangled ("substep1_kernel<float, float, float, 0, 3, true, true,
    true>") or mangled ("substep1_kernelIfffLi0ELi3ELb1ELb1ELb1E")."""
    flags = []
    for name in names:
        m = re.search(r"substep[12]_kernel<([^<>]*)>", name)
        if m:
            args = [a.strip() for a in m.group(1).split(",")]
            if args[6] == "true":
                flags.append(len(args) == 8 and args[7] == "true")
            continue
        m = re.search(r"substep[12]_kernelI\w*?Li\d+ELi\d+ELb[01]ELb1E(Lb1E)?", name)
        if m:
            flags.append(m.group(1) is not None)
    return flags


@pytest.mark.chip
@pytest.mark.parametrize("nx", [192, 1024])
def test_graph_replays_count_the_lane_deposits(cuda, nx, tmp_path):
    """At 32 kept modes, eager steps and a CUDA graph's replayed steps
    count two "grid-bin lane deposits" a step at nx 192 and none at nx 1024
    (the warp form), as many as the profiled lane-form kernels; the
    replays are the eager steps bit for bit."""
    cfg = _modes(32, nx=nx, nparticle_max=1 << 21)
    lanes = nx == 192
    graphed, eager = Stepper(cfg, cuda), Stepper(cfg, cuda)
    assert graphed.substeps.uses_grid_bin()
    assert graphed.substeps.uses_grid_lanes(1) == graphed.substeps.uses_grid_lanes(2) == lanes
    s0 = graphed.initial_field(load_particles(cfg, cuda))
    a, b = s0.clone(), s0.clone()
    a = graphed.multi_step(a, 3)              # eager: loads the kernels
    a = graphed.multi_step(a, 7)              # one graph of 7 steps, replayed
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        a = graphed.multi_step(a, 7)
        torch.cuda.synchronize()
    for _ in range(17):
        b = eager.step(b)
    torch.cuda.synchronize()
    t = graphed.timers
    assert t.counter("graph replays") == 2
    assert t.counter("grid-bin substeps") == 2 * 17
    counted = t.counter("grid-bin lane deposits")
    assert counted == eager.timers.counter("grid-bin lane deposits") == (2 * 17 if lanes else 0)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    flags = _lane_flags(ev.get("name", "") for ev in events if ev.get("cat") == "kernel")
    assert len(flags) == 2 * 7, flags
    assert sum(flags) == (2 * 7 if lanes else 0)
    for f in ("x", "v", "w", "mode_re", "mode_im"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
