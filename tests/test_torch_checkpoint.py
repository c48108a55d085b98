"""The port's checkpoints (Simulation.save_checkpoint / restore_checkpoint):
a resumed run is the uninterrupted run bit for bit, and the .npz files cross
between the port and the JAX package in both directions with bit-equal
state; the next 5 steps then agree within 1e-12 of each field's max
(float64, CPU)."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port import assert_rel, host

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu.core.simulation import Simulation as JaxSimulation
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.state import FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(nx=32, nparticle=4096, time_max=2.0, output_interval=0.5, dtype="float64",
          verbosity=0, nv=32, nx_opd=16, nv_opd=16)
CK_KEYS = {"itime", "time", "imerge", "iremove", "isplit", "key", "config_json", *FIELDS}


def _steps_to(sim, t):
    while sim.time < t - 1e-9:
        sim.step_once()


def test_checkpoint_resume(tmp_path):
    """tests/test_tools.py:98-123 on the port."""
    cfg = tcfg_mod.landau_damping(**KW)
    sim_a = Simulation(cfg, device="cpu")
    sim_a.load()
    _steps_to(sim_a, 2.0)

    sim_b = Simulation(cfg, device="cpu")
    sim_b.load()
    _steps_to(sim_b, 1.0)
    ck = sim_b.save_checkpoint(str(tmp_path / "ck.npz"))
    sim_c = Simulation(cfg, device="cpu")
    sim_c.restore_checkpoint(ck)
    assert sim_c.itime == sim_b.itime and sim_c.time == sim_b.time
    _steps_to(sim_c, 2.0)
    for f in ("x", "v", "w", "electric"):
        np.testing.assert_array_equal(host(getattr(sim_a.state, f)),
                                      host(getattr(sim_c.state, f)), err_msg=f)


def test_checkpoint_config_mismatch(tmp_path):
    """tests/test_tools.py:126-138 on the port, with the JAX package's
    message."""
    cfg = tcfg_mod.landau_damping(nx=32, nparticle=4096, dtype="float64", verbosity=0)
    sim = Simulation(cfg, device="cpu")
    sim.load()
    ck = sim.save_checkpoint(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="different config") as exc:
        Simulation(dataclasses.replace(cfg, nx=64, dt=0.1), device="cpu").restore_checkpoint(ck)
    assert "(state-affecting fields differ: ['dt', 'nx'])" in str(exc.value)
    jcfg = jcfg_mod.landau_damping(nx=32, nparticle=4096, dtype="float64", verbosity=0)
    with pytest.raises(ValueError) as jexc:
        JaxSimulation(dataclasses.replace(jcfg, nx=64, dt=0.1)).restore_checkpoint(ck)
    assert str(jexc.value) == str(exc.value)
    extended = Simulation(dataclasses.replace(cfg, time_max=50.0, output_interval=1.0,
                                              diag_full_rho=True, verbosity=2), device="cpu")
    extended.restore_checkpoint(ck)
    assert extended.itime == sim.itime


def test_checkpoint_file_layout_and_atomic_write(tmp_path):
    """The JAX package's keys, the port's generator beside them, and no
    temporary file left behind; a second save replaces the first."""
    cfg = tcfg_mod.landau_damping(**KW)
    sim = Simulation(dataclasses.replace(cfg, rng=tcfg_mod.RngConfig(seed=5)),
                     checkpoint_path=str(tmp_path), device="cpu")
    sim.load()
    path = sim.save_checkpoint()
    assert path == str(tmp_path / "checkpoint.npz")
    with np.load(path) as ck:
        assert set(ck.files) == CK_KEYS | {"torch_generator_state", "torch_generator_device"}
        np.testing.assert_array_equal(ck["key"], np.array([0, 5], np.uint32))
        assert ck["key"].dtype == np.uint32
        assert bytes(ck["config_json"]).decode() == sim.cfg.to_json()
        assert bytes(ck["torch_generator_device"]).decode() == "cpu"
    sim.step_once()
    assert sim.save_checkpoint() == path
    with np.load(path) as ck:
        assert int(ck["itime"]) == 1
    assert os.listdir(tmp_path) == ["checkpoint.npz"]


def _jax_and_port(tmp_path, **over):
    kw = dict(KW, **over)
    return (JaxSimulation(jcfg_mod.landau_damping(**kw)),
            Simulation(tcfg_mod.landau_damping(**kw), device="cpu"))


def _assert_state_bit_equal(port_state, jax_state):
    for f in FIELDS:
        np.testing.assert_array_equal(host(getattr(port_state, f)),
                                      np.asarray(getattr(jax_state, f)), err_msg=f)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jsim, sim = _jax_and_port(tmp_path)
    jsim.load()
    for _ in range(7):
        jsim.step_once()
    ck = jsim.save_checkpoint(str(tmp_path / "jax.npz"))
    sim.restore_checkpoint(ck)
    assert (sim.itime, sim.time) == (jsim.itime, jsim.time)
    _assert_state_bit_equal(sim.state, jsim.state)
    np.testing.assert_array_equal(sim.key, np.asarray(jsim.key))
    for _ in range(5):
        jsim.step_once()
        sim.step_once()
    for f in ("x", "v", "w", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(sim.state, f), getattr(jsim.state, f), 1e-12, f)
    # the key read from the file goes back into the next file unchanged
    with np.load(sim.save_checkpoint(str(tmp_path / "again.npz"))) as again, \
            np.load(ck) as first:
        np.testing.assert_array_equal(again["key"], first["key"])


def test_port_checkpoint_restores_in_jax(tmp_path):
    jsim, sim = _jax_and_port(tmp_path)
    sim.load()
    for _ in range(7):
        sim.step_once()
    ck = sim.save_checkpoint(str(tmp_path / "port.npz"))
    jsim.restore_checkpoint(ck)
    assert (jsim.itime, jsim.time) == (sim.itime, sim.time)
    _assert_state_bit_equal(sim.state, jsim.state)
    assert np.asarray(jsim.key).tolist() == [0, 0]
    for _ in range(5):
        jsim.step_once()
        sim.step_once()
    for f in ("x", "v", "w", "electric", "mode_re", "mode_im"):
        assert_rel(getattr(sim.state, f), getattr(jsim.state, f), 1e-12, f)


def test_bf16_p_round_trip_is_bitwise(tmp_path):
    """p is stored widened to float32 and narrowed again on restore, in the
    port and across the packages."""
    kw = dict(nx=32, nparticle=4096, verbosity=0, nx_opd=16, nv_opd=16, bf16_weights=True)
    cfg = tcfg_mod.landau_damping(**kw)
    sim = Simulation(cfg, device="cpu")
    sim.load()
    sim.step_once()
    ck = sim.save_checkpoint(str(tmp_path / "bf16.npz"))
    with np.load(ck) as f:
        assert f["p"].dtype == np.float32
    back = Simulation(cfg, device="cpu")
    back.restore_checkpoint(ck)
    assert back.state.p.dtype == torch.bfloat16
    for f in FIELDS:
        assert torch.equal(getattr(back.state, f), getattr(sim.state, f)), f
    jsim = JaxSimulation(jcfg_mod.landau_damping(**kw))
    jsim.restore_checkpoint(ck)
    assert str(jsim.state.p.dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jsim.state.p).view(np.int16),
                                  sim.state.p.view(torch.int16).numpy())
    again = Simulation(cfg, device="cpu")
    again.restore_checkpoint(jsim.save_checkpoint(str(tmp_path / "bf16_jax.npz")))
    assert torch.equal(again.state.p, sim.state.p)


def _scheduled_cfg():
    return dataclasses.replace(
        tcfg_mod.landau_damping(nx=32, nparticle=4096, amp=1e-2, time_max=2.0,
                                output_interval=0.5, dtype="float64", verbosity=0),
        optimization=tcfg_mod.OptimizationConfig(
            tmerge=(0.5,), thshmerge=(0.4,), tremove=(1.0, 1.5), thshremove=(),
            tsplit=(1.75,), thshsplit=(0.6,)))


def test_resume_keeps_cursors_and_generator(tmp_path):
    """A run with optimization events checkpointed between them: the resumed
    run draws the same dice and ends in the same state bit for bit."""
    cfg = _scheduled_cfg()
    whole = Simulation(cfg, device="cpu")
    whole.run()
    first = Simulation(dataclasses.replace(cfg, time_max=1.25), device="cpu")
    first.run()
    assert (first._imerge, first._iremove, first._isplit) == (1, 1, 0)
    ck = first.save_checkpoint(str(tmp_path / "mid.npz"))
    rest = Simulation(cfg, device="cpu")
    rest.restore_checkpoint(ck)
    assert (rest._imerge, rest._iremove, rest._isplit) == (1, 1, 0)
    assert torch.equal(rest.generator.get_state(), first.generator.get_state())
    rest.run()
    assert (rest._imerge, rest._iremove, rest._isplit) == (1, 2, 1)
    assert rest.itime == whole.itime
    for f in FIELDS:
        assert torch.equal(getattr(rest.state, f), getattr(whole.state, f)), f


def test_file_without_generator_state_reseeds(tmp_path):
    """A file of the JAX package carries no generator: the port then seeds
    one from the config's seed and the step count, away from the loader's."""
    jsim, sim = _jax_and_port(tmp_path)
    jsim.load()
    jsim.step_once()
    sim.restore_checkpoint(jsim.save_checkpoint(str(tmp_path / "jax.npz")))
    fresh = torch.Generator().manual_seed(sim.cfg.rng.seed)
    assert not torch.equal(sim.generator.get_state(), fresh.get_state())
    other = Simulation(sim.cfg, device="cpu")
    other.restore_checkpoint(str(tmp_path / "jax.npz"))
    assert torch.equal(other.generator.get_state(), sim.generator.get_state())


def test_sharded_checkpoint_is_refused(tmp_path):
    cfg = tcfg_mod.landau_damping(**KW)
    sim = Simulation(cfg, device="cpu")
    sim.load()
    with np.load(sim.save_checkpoint(str(tmp_path / "ck.npz"))) as ck:
        arrays = {k: ck[k] for k in ck.files}
    half = arrays["x"].shape[1] // 2
    for f in ("x", "v", "p", "w", "live"):
        whole = arrays.pop(f)
        arrays[f"{f}@0"], arrays[f"{f}@{half}"] = whole[:, :half], whole[:, half:]
    np.savez(tmp_path / "sharded.npz", **arrays)
    with pytest.raises(NotImplementedError, match="per-process shards"):
        Simulation(cfg, device="cpu").restore_checkpoint(str(tmp_path / "sharded.npz"))


def test_run_writes_checkpoints_at_the_interval(tmp_path):
    cfg = dataclasses.replace(tcfg_mod.landau_damping(**KW), verbosity=2)
    sim = Simulation(cfg, checkpoint_interval=1.0, checkpoint_path=str(tmp_path), device="cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        sim.run()
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("checkpoint written")]
    assert lines == [f"checkpoint written: {tmp_path / 'checkpoint.npz'}"] * 2
    with np.load(tmp_path / "checkpoint.npz") as ck:
        assert float(ck["time"]) == pytest.approx(2.0) and int(ck["itime"]) == 40


def test_nonfinite_error_names_the_checkpoint_path(tmp_path):
    sim = Simulation(tcfg_mod.landau_damping(**KW), checkpoint_path=str(tmp_path),
                     device="cpu")
    sim.load()
    sim.state.electric[0] = float("inf")
    with pytest.raises(FloatingPointError) as exc:
        sim.output_snapshot()
    assert f"Last checkpoint (if enabled) is in {str(tmp_path)!r}." in str(exc.value)


def test_run_cli_checkpoint_and_resume(tmp_path):
    """--checkpoint-interval writes <out>/checkpoint.npz; --resume with a
    longer time_max carries on from it and ends where one run would."""
    sets = ["nx=32", "nparticle_max=2048", "output_interval=0.25", "dtype='float64'",
            "verbosity=0"]

    def run(out, *extra):
        cmd = [sys.executable, "-m", "pic1dp_tpu_torch.run", "--device", "cpu", "-p", "landau",
               "-o", str(out), *extra] + [a for s in sets for a in ("-s", s)]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr

    run(tmp_path / "a", "-s", "time_max=0.5", "--checkpoint-interval", "0.5")
    ck = tmp_path / "a" / "checkpoint.npz"
    assert ck.exists()
    run(tmp_path / "b", "-s", "time_max=1.0", "--resume", str(ck),
        "--checkpoint-interval", "0.5")
    whole = Simulation(tcfg_mod.landau_damping(
        nx=32, nparticle=2048, output_interval=0.25, dtype="float64", verbosity=0,
        time_max=1.0), device="cpu")
    whole.run()
    with np.load(tmp_path / "b" / "checkpoint.npz") as b:
        assert int(b["itime"]) == whole.itime == 20
        for f in ("x", "v", "w", "electric"):
            np.testing.assert_array_equal(b[f], host(getattr(whole.state, f)), err_msg=f)
