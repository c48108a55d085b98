"""The 32-mode bump-on-tail (benchmark/configs/bot_modes32.json: the
reference's default run with modes 1..32 kept) against the benchmark's plain
reference, benchmark/reference/deltaf_spectral.py, which forms E and the
projections per marker and per mode, in float64, and imports nothing of
the port.

At the configuration's widths (nx 192, modes 1..32, its lx, dt and
equilibrium) with 16,384 markers made as the benchmark makes them, in
float64:

  * the configuration's route: the grid bin (mode_bin 0) in the recompute
    layout at its 6.4M markers;
  * Simulation on the CPU over one snapshot interval (10 steps): the state
    at its end and its record of pic1dp.out;
  * one step of tests/test_torch_substep.py::_kernel_model in its grid form
    (the arithmetic of the CUDA grid bin: E on the grid, the hat lerp, the
    charge grid projected with the angle table), in each nonlinear layout.

Each comparison is run again by a program that keeps modes 1..16 only: it
has to fail.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import host
from test_torch_substep import _kernel_model

from benchmark import check
from benchmark import markers as markers_mod
from benchmark.outfile import OutFile
from benchmark.reference import deltaf_spectral
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.ops import substep_kernels as sk

# several test workers share the machine (as tests/_torch_port.py)
torch.set_num_threads(2)

CONFIG = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / "bot_modes32.json"
N = 16_384
SEED = 2_500_000_025
F64 = torch.float64
# float64 program against the float64 reference: the two form the same sums
# in other orders (a mode's hat fold or the grid's lerp against per-mode
# trig, the angle table against cos and sin of each angle), so they differ
# by rounding: the largest readings at this seed are 1.8e-15 (state) and
# 2.6e-14 (record, projections) of each quantity's scale.  1e-10 leaves
# over a thousandfold room above that and lies six decades under what
# leaving modes 17..32 out gives (5.3e-4 and more); float32 arithmetic
# (about 1e-7) would fail it
STATE_TOL = 1e-10
RECORD_TOL = 1e-10


def _program(**change) -> dict:
    with open(CONFIG) as fh:
        return dict(json.load(fh)["program"], **change)


def _setup(kept: int):
    """(physics of the whole configuration, the program's Config keeping
    modes 1..kept, the benchmark's markers) at N markers in float64."""
    prog = _program(nparticle_max=N, dtype="float64", time_max=0.5, verbosity=0)
    physics = deltaf_spectral.Physics(prog, "cpu")
    cfg = Config.from_dict(dict(prog, modes=list(range(1, kept + 1))))
    mk = markers_mod.make(physics, F64, N, N, SEED, 0, "cpu")
    return physics, cfg, mk


def _ident(*tensors):
    return tensors


def _state_rel(physics, x, v, w, ref) -> float:
    dx = (x - ref["x"]).abs()
    dx = torch.minimum(dx, physics.lx - dx)
    return max(float(dx.max()) / physics.lx,
               float((v - ref["v"]).abs().max() / ref["v"].abs().max()),
               float((w - ref["w"]).abs().max() / ref["w"].abs().max()))


def _reference_steps(physics, mk, steps: int):
    st = {"x": mk.x.clone(), "v": mk.v.clone(), "w": mk.w.clone(), "p": mk.p}
    modes = physics.solve(physics.projections(mk.x, mk.w, _ident))
    for _ in range(steps):
        modes, proj = physics.step(st, modes, _ident)
    return st, modes, proj


def _padded(rec: dict, nmode: int) -> dict:
    """The record with the modes a program does not keep as zeros."""
    out = dict(rec)
    for k in ("mode_re", "mode_im"):
        out[k] = np.concatenate([rec[k], np.zeros(nmode - len(rec[k]))])
    return out


def test_the_configuration_takes_the_grid_bin_in_the_recompute_layout():
    cfg = Config.from_dict(_program())
    assert cfg.nmode == 32 and cfg.nparticle_max == 6_400_000 and cfg.nx == 192
    assert sk.mode_bin(cfg.nmode) == sk.GRID_BIN
    assert sk.rebuilds_v1_faster(cfg) and sk.layout(cfg) == sk.RECOMPUTE
    subs = sk.FusedSubsteps(cfg, dist.SpeciesParams.from_config(cfg, torch.float32, "cpu"))
    assert subs.uses_grid_bin() and subs.rebuilds_w1
    assert subs.counters == (sk.SUBSTEP1_RECOMPUTE, sk.SUBSTEP2_RECOMPUTE)


@pytest.mark.parametrize("kept", [32, 16], ids=["modes_1_32", "modes_1_16_fails"])
def test_a_simulation_interval_against_the_reference(kept, tmp_path):
    """Simulation.run over one snapshot interval from the benchmark's
    markers: x, v, w at its end against the reference's 10 steps, and
    records 0 and 1 of pic1dp.out against the reference's diagnostics (of
    the program's own state and of the reference's modes, E and rho)."""
    physics, cfg, mk = _setup(kept)
    sim = Simulation(cfg, out_path=str(tmp_path), device="cpu")
    zx = torch.zeros(cfg.nx, dtype=F64)
    zm = torch.zeros(cfg.nmode, dtype=F64)
    sim.state = sim.stepper.initial_field(SimState(
        x=mk.x.clone(), v=mk.v.clone(), p=mk.p.clone(), w=mk.w.clone(), live=mk.live,
        rho=zx.clone(), electric=zx.clone(), mode_re=zm.clone(), mode_im=zm.clone()))
    assert sim.stepper.substeps.uses_grid_bin()
    sim.run()
    assert sim.itime == 10
    st = sim.state
    ref, modes, proj = _reference_steps(physics, mk, 10)
    state_rel = _state_rel(physics, st.x, st.v, st.w, ref)

    out = OutFile(str(tmp_path / "pic1dp.out"))
    assert out.count() == 2 and out.modes == list(range(1, kept + 1))
    numbers = check.Numbers()
    proj0 = physics.projections(mk.x, mk.w, _ident)
    check.compare_record(numbers, _padded(out.read(0), 32),
                         physics.record(0.0, physics.solve(proj0), proj0, mk.x, mk.v, mk.p,
                                        mk.w, mk.live, _ident), "cpu")
    rec = _padded(out.read(1), 32)
    proj1 = physics.projections(st.x, st.w, _ident)
    check.compare_record(numbers, rec, physics.record(0.5, physics.solve(proj1), proj1, st.x,
                                                      st.v, mk.p, st.w, mk.live, _ident),
                         "cpu")
    e_ref, rho_ref = physics.grids(modes, proj)
    check.compare_record(numbers, rec, {"mode_re": modes[0], "mode_im": modes[1],
                                        "electric": e_ref, "rho": rho_ref}, "cpu")
    record_rel = numbers.values["record_rel"]
    if kept == 32:
        assert state_rel <= STATE_TOL and record_rel <= RECORD_TOL, (state_rel, record_rel)
    else:
        assert state_rel > STATE_TOL and record_rel > RECORD_TOL, (state_rel, record_rel)


@pytest.mark.parametrize("kept", [32, 16], ids=["modes_1_32", "modes_1_16_fails"])
@pytest.mark.parametrize("stream_v1", [True, False], ids=["streamed", "recompute"])
def test_one_grid_bin_step_of_the_kernel_model_against_the_reference(stream_v1, kept):
    """Both substeps of _kernel_model's grid form, the modes solved between
    them as the kernels' last block solves them (-p_s g, -p_c g), against
    one step of the reference: x2, v2, w2 and the step's projections."""
    physics, cfg, mk = _setup(kept)
    subs = sk.FusedSubsteps(cfg, dist.SpeciesParams.from_config(cfg, F64, "cpu"),
                            stream_v1=stream_v1)
    assert subs.uses_grid_bin()
    assert subs.layout == (sk.NONLINEAR if stream_v1 else sk.RECOMPUTE)
    g = host(subs.g)
    x, v, p, w = (host(t) for t in (mk.x, mk.v, mk.p, mk.w))
    re0, im0 = (host(t)[:kept] for t in physics.solve(physics.projections(mk.x, mk.w,
                                                                          _ident)))
    w1, v1, (pc1, ps1) = _kernel_model(subs, x, v, p, w, (re0, im0), substep=1)
    x2, v2, w2, (pc2, ps2) = _kernel_model(subs, x, v, p, w, (-ps1 * g, -pc1 * g, re0, im0),
                                           substep=2, w1=w1, v1=v1)
    ref, _, (rpc, rps) = _reference_steps(physics, mk, 1)
    t = torch.from_numpy
    state_rel = _state_rel(physics, t(x2), t(v2), t(w2), ref)
    pad = np.zeros(32 - kept)
    proj_rel = max(float((t(np.concatenate([a, pad])) - b).abs().max() / b.abs().max())
                   for a, b in ((pc2, rpc), (ps2, rps)))
    if kept == 32:
        assert state_rel <= STATE_TOL and proj_rel <= RECORD_TOL, (state_rel, proj_rel)
    else:
        assert state_rel > STATE_TOL and proj_rel > RECORD_TOL, (state_rel, proj_rel)
