"""The slice as a whole: one loaded state runs through both packages'
Simulation with output on, in float64.  Snapshots, pic1dp.out and the
progress lines must agree; the port's command line must run on the CPU."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_port import CASES, assert_rel, to_port

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.analysis.output_data import OutputData
from pic1dp_tpu.config import bump_on_tail_default as jax_bot
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.simulation import Simulation as JaxSimulation
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.config import OptimizationConfig
from pic1dp_tpu_torch.config import bump_on_tail_default as bot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(nx=192, nparticle_max=8192, time_max=1.0, dtype="float64", verbosity=1)


def _progress(err: str) -> tuple[list[str], list[str]]:
    """(progress lines without the version line, the timer table's rows
    above its total)."""
    lines = err.splitlines()
    cut = lines.index("Info: timers:")
    end = next(i for i in range(cut + 2, len(lines)) if lines[i].split()[0] == "total")
    return lines[1:cut], lines[cut + 2:end]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both simulations from the JAX loader's state, with their snapshots,
    output directories and stderr."""
    out = tmp_path_factory.mktemp("sim")
    jcfg = jax_bot(**KW)
    raw = jax_load(jcfg, jax.random.PRNGKey(0))
    result = {}
    for name in ("jax", "torch"):
        if name == "jax":
            sim = JaxSimulation(jcfg, out_path=str(out / name))
            sim.state = sim.stepper.initial_field(raw)
        else:
            sim = Simulation(bot(**KW), out_path=str(out / name), device="cpu")
            sim.state = sim.stepper.initial_field(to_port(raw))
        snaps = []
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            sim.run(snapshot_callback=snaps.append)
        err = err.getvalue()
        result[name] = dict(snaps=snaps, dir=str(out / name), err=err)
    return result


def test_snapshots_agree(runs):
    js, ts = runs["jax"]["snaps"], runs["torch"]["snaps"]
    assert [s["time"] for s in ts] == [s["time"] for s in js]
    assert len(ts) == 3   # t = 0, 0.5, 1.0
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a["field_energy"], b["field_energy"], rtol=1e-10)
        for key in ("marker", "total", "pertb", "mode_re", "mode_im"):
            assert_rel(a[key], b[key], 1e-12, f"t={a['time']}:{key}")


def test_output_files_agree(runs):
    a, b = OutputData(runs["torch"]["dir"]), OutputData(runs["jax"]["dir"])
    assert (a.nspecies, a.nmode, a.nx, a.nv, a.nx_pd, a.nv_pd, a.ntime) == \
        (b.nspecies, b.nmode, b.nx, b.nv, b.nx_pd, b.nv_pd, b.ntime)
    assert (a.lx, a.v_max) == (b.lx, b.v_max)
    assert_rel(a.get_scalar_t(), b.get_scalar_t(), 1e-12, "scalars")
    assert_rel(a.get_mode_t(), b.get_mode_t(), 1e-12, "modes")
    for it in range(a.ntime):
        assert_rel(a.get_field_x(it), b.get_field_x(it), 1e-12, f"fields {it}")
        for k in range(3):
            assert_rel(a.get_ptcldist_xv(it, 0, k), b.get_ptcldist_xv(it, 0, k),
                       1e-12, f"xv {it} {k}")
            assert_rel(a.get_ptcldist_v(it, 0, k), b.get_ptcldist_v(it, 0, k),
                       1e-12, f"v {it} {k}")


def test_progress_lines_agree(runs):
    tlines, trows = _progress(runs["torch"]["err"])
    jlines, jrows = _progress(runs["jax"]["err"])
    assert runs["torch"]["err"].splitlines()[0] == "pic1dp_tpu_torch version 0.1.0"
    assert tlines == jlines
    # the port's table indents a phase's parts below it, times "step" only
    # with tracing on (on a card the device's seconds), and writes a
    # snapshot's record outside the snapshot, once the next chunk is queued
    tphases = [row.split()[0] for row in trows if not row[0].isspace()]
    assert [p for p in tphases if p != "output:"] == \
        [row.split()[0] for row in jrows if row.split()[0] != "step"]
    assert [row.split()[:2] for row in trows if row.startswith("output:")] == \
        [["output:", "write"]]


@pytest.mark.parametrize("name", ["landau_fullf", "two_species_maxwellian"])
def test_layout_runs_agree_with_jax(name, tmp_path):
    """A full-f run and a two-species run through both packages' Simulation
    from one loaded state, in float64: every snapshot and pic1dp.out agree."""
    def cfg(mod):
        return dataclasses.replace(CASES[name](mod, "float64"), time_max=1.0,
                                   output_interval=0.25)

    jcfg, tcfg = cfg(jcfg_mod), cfg(tcfg_mod)
    raw = jax_load(jcfg, jax.random.PRNGKey(8))
    snaps = {"jax": [], "torch": []}
    jsim = JaxSimulation(jcfg, out_path=str(tmp_path / "jax"))
    jsim.state = jsim.stepper.initial_field(raw)
    jsim.run(snapshot_callback=snaps["jax"].append)
    sim = Simulation(tcfg, out_path=str(tmp_path / "torch"), device="cpu")
    sim.state = sim.stepper.initial_field(to_port(raw))
    sim.run(snapshot_callback=snaps["torch"].append)
    assert [s["time"] for s in snaps["torch"]] == [s["time"] for s in snaps["jax"]]
    assert len(snaps["torch"]) == 5
    for a, b in zip(snaps["torch"], snaps["jax"]):
        np.testing.assert_allclose(a["field_energy"], b["field_energy"], rtol=1e-10)
        for key in ("marker", "total", "pertb", "mode_re", "mode_im"):
            assert_rel(a[key], b[key], 1e-12, f"{name} t={a['time']}:{key}")
    a, b = OutputData(str(tmp_path / "torch")), OutputData(str(tmp_path / "jax"))
    assert a.nspecies == b.nspecies == tcfg.nspecies
    assert_rel(a.get_scalar_t(), b.get_scalar_t(), 1e-12, "scalars")
    for s in range(tcfg.nspecies):
        assert_rel(a.get_ptcldist_xv(4, s, 2), b.get_ptcldist_xv(4, s, 2), 1e-12,
                   f"species {s} xv")


def test_nonfinite_field_energy_raises():
    sim = Simulation(bot(nx=64, nparticle_max=1024, time_max=0.2, dtype="float64",
                         verbosity=0), device="cpu")
    sim.load()
    sim.state.electric[0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite field energy"):
        sim.output_snapshot()


def test_optimization_schedule_splits_at_its_time():
    """A schedule is accepted, the split takes place at its time and fills
    dead slots."""
    cfg = bot(nx=64, nparticle_max=2048, time_max=0.5, output_interval=0.25, dtype="float64",
              verbosity=0,
              species=(dataclasses.replace(tcfg_mod.SpeciesConfig(), nparticle_init=1024),),
              optimization=OptimizationConfig(tsplit=(0.25,), thshsplit=(0.5,)))
    sim = Simulation(cfg, device="cpu")
    sim.run()
    assert sim._isplit == 1 and sim.itime == 10
    assert 1024 < int(sim.state.live.sum()) <= 2048
    assert bool(torch.isfinite(sim.state.w).all())


@pytest.mark.parametrize("flag", [False, True], ids=["kept_modes", "diag_full_rho"])
def test_diag_full_rho_matches_jax(flag, tmp_path):
    """tests/test_tools.py:177-194 through both packages from one JAX-loaded
    state: rho in the port's pic1dp.out equals the JAX package's within
    1e-12 of max|rho| at every snapshot, with diag_full_rho on and off; with
    it on, rho holds every spatial mode and its mode-1 projection is the
    kept-mode rho."""
    kw = dict(nx=32, nparticle=8192, time_max=0.5, output_interval=0.25, dtype="float64",
              verbosity=0, nx_opd=16, nv_opd=16, diag_full_rho=flag)
    jcfg, tcfg = jcfg_mod.landau_damping(**kw), tcfg_mod.landau_damping(**kw)
    raw = jax_load(jcfg, jax.random.PRNGKey(0))
    jsim = JaxSimulation(jcfg, out_path=str(tmp_path / "jax"))
    jsim.state = jsim.stepper.initial_field(raw)
    jsim.run()
    sim = Simulation(tcfg, out_path=str(tmp_path / "torch"), device="cpu")
    sim.state = sim.stepper.initial_field(to_port(raw))
    sim.run()
    a, b = OutputData(str(tmp_path / "torch")), OutputData(str(tmp_path / "jax"))
    assert a.ntime == b.ntime == 3
    k1 = np.exp(2j * np.pi * np.arange(32) / 32)
    for it in range(3):
        rho_t, rho_j = a.get_field_x(it)[1], b.get_field_x(it)[1]
        assert_rel(rho_t, rho_j, 1e-12, f"rho at snapshot {it}")
        kept = sim.state.rho.numpy() if it == 2 else None
        proj = 2.0 * np.real(np.mean(rho_t[:32] * np.conj(k1)) * k1)
        if flag:
            assert not np.allclose(rho_t[:32], proj)
        else:
            np.testing.assert_allclose(rho_t[:32], proj, atol=1e-10)
        if kept is not None:
            np.testing.assert_allclose(kept, proj, atol=1e-10)


def test_diag_full_rho_needs_a_writer():
    """Without a writer nothing reads the full rho: no deposit is made."""
    cfg = tcfg_mod.landau_damping(nx=32, nparticle=1024, time_max=0.2, output_interval=0.1,
                                  dtype="float64", verbosity=0, diag_full_rho=True)
    sim = Simulation(cfg, device="cpu")
    sim.load()
    sim.stepper.full_rho = None   # would raise if called
    sim.output_snapshot()


def test_run_cli_on_cpu(tmp_path):
    """`python -m pic1dp_tpu_torch.run --device cpu` writes a readable
    pic1dp.out whose field energies the same run in process reproduces."""
    sets = ["nx=64", "nparticle_max=2048", "time_max=0.2", "output_interval=0.1",
            "dtype='float64'", "verbosity=0"]
    cmd = [sys.executable, "-m", "pic1dp_tpu_torch.run", "--device", "cpu",
           "-o", str(tmp_path)] + [a for s in sets for a in ("-s", s)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    od = OutputData(str(tmp_path))
    assert od.ntime == 3 and od.nx == 64
    snaps = []
    Simulation(bot(nx=64, nparticle_max=2048, time_max=0.2, output_interval=0.1,
                   dtype="float64", verbosity=0), device="cpu").run(snaps.append)
    np.testing.assert_allclose(od.get_scalar_t()[1], [s["field_energy"] for s in snaps],
                               rtol=1e-12)


def test_run_cli_without_cuda_refuses():
    proc = subprocess.run([sys.executable, "-m", "pic1dp_tpu_torch.run", "--no-output",
                           "-s", "nparticle_max=1024"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_run_cli_write_config(tmp_path):
    path = tmp_path / "cfg.json"
    proc = subprocess.run([sys.executable, "-m", "pic1dp_tpu_torch.run", "-s", "nx=256",
                           "--write-config", str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert bot(nx=256).to_json() == path.read_text()
