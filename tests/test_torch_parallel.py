"""The port's particle-sharded runs (pic1dp_tpu_torch/parallel/) against
the JAX package's (pic1dp_tpu/parallel/, as tests/test_parallel.py holds
them): N gloo CPU processes (tests/_torch_mesh_worker.py) against the JAX
ShardedStepper on N of conftest's virtual devices, from the same loaded
state in float64, at 1e-12 of each field's max; the Simulation's output,
per-process checkpoints and run.py --mesh; the one-rank mesh bit for bit."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import pic1dp_tpu.config as jcfg_mod
import pic1dp_tpu_torch.config as tcfg_mod
from _torch_port import assert_rel, to_port
from pic1dp_tpu import Simulation as JaxSimulation
from pic1dp_tpu.analysis.output_data import OutputData
from pic1dp_tpu.core.loading import load_particles
from pic1dp_tpu.parallel import mesh as jpmesh
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.core.state import FIELDS
from pic1dp_tpu_torch.parallel import launch
from pic1dp_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
TOL = 1e-12
STEPS, MERGE_THRESHOLD = 3, 0.3     # as the worker takes them
PROCESS_TIMEOUT = 240


def _configs(m):
    return {
        "landau": m.landau_damping(nx=64, nparticle=8192, k=0.5, amp=1e-3, time_max=5.0,
                                   dtype="float64", verbosity=0),
        "fullf": dataclasses.replace(
            m.landau_damping(nx=32, nparticle=8192, amp=1e-1, dtype="float64", verbosity=0,
                             nx_opd=16, nv_opd=16), deltaf=False),
        "simulation": m.landau_damping(nx=32, nparticle=8192, time_max=1.0,
                                       output_interval=0.25, dtype="float64", verbosity=0,
                                       nx_opd=16, nv_opd=16),
        "checkpoint": m.landau_damping(nx=32, nparticle=8192, time_max=1.0,
                                       dtype="float64", verbosity=0),
    }


def _run_job(workdir, world, argv_of, env_of=lambda rank: {}):
    procs = [subprocess.Popen(argv_of(rank), cwd=REPO, env={**os.environ, **env_of(rank)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(world)]
    try:
        outs = [p.communicate(timeout=PROCESS_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}_ranks")
def job(request, tmp_path_factory, devices):
    """The worker's results on `world` gloo ranks, and the JAX ShardedStepper's
    on as many virtual devices, from the same loaded states."""
    world = request.param
    workdir = tmp_path_factory.mktemp(f"mesh{world}")
    jcfgs, tcfgs = _configs(jcfg_mod), _configs(tcfg_mod)
    jstates = {"landau": load_particles(jcfgs["landau"], jax.random.PRNGKey(7)),
               "fullf": load_particles(jcfgs["fullf"], jax.random.PRNGKey(0))}
    np.savez(workdir / "states.npz", **{f"{c}.{f}": np.asarray(getattr(s, f))
                                        for c, s in jstates.items() for f in FIELDS})
    with open(workdir / "configs.json", "w") as fh:
        json.dump({k: c.to_json() for k, c in tcfgs.items()}, fh)
    _run_job(workdir, world,
             lambda rank: [sys.executable, WORKER, str(rank), str(world), str(workdir)])
    with np.load(workdir / "results.npz") as npz:
        got = {k: npz[k] for k in npz.files}
    infos = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world)]

    mesh = jpmesh.make_mesh(world)
    st = jpmesh.ShardedStepper(jcfgs["landau"], mesh)
    s0 = st.initial_field(jpmesh.shard_state(jstates["landau"], mesh))
    pushed = st.push_pair(s0)
    s = s0
    for _ in range(STEPS):
        s = st.step(s)
    fullf = jpmesh.ShardedStepper(jcfgs["fullf"], mesh)
    want = {"initial": s0, "energies": st.energies(s0), "ptcldist": st.ptcldist(s0),
            "full_rho": {"rho": st.full_rho(s0)}, "push_pair": pushed,
            "collect": st.collect_and_solve(pushed),
            "merge": st.collect_and_solve(st.apply_optimizations(
                pushed, jax.random.PRNGKey(1), merge=MERGE_THRESHOLD)),
            "steps": s, "multi_step": st.make_multi_step(STEPS)(s0),
            "fullf_ptcldist": fullf.ptcldist(fullf.initial_field(
                jpmesh.shard_state(jstates["fullf"], mesh)))}
    return world, workdir, got, infos, want


def _fields(tree):
    if isinstance(tree, dict):
        return tree
    if hasattr(tree, "_asdict"):
        return tree._asdict()
    return {f: getattr(tree, f) for f in FIELDS}


def _compare(job, name, exact=()):
    _, _, got, _, want = job
    for f, w in _fields(want[name]).items():
        w = np.asarray(w)
        g = got[f"{name}.{f}"]
        if w.dtype == bool or f in exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{name}.{f}")
        else:
            assert_rel(g, w.astype(np.float64), TOL, f"{name}.{f}")


@pytest.mark.parametrize("name", ["initial", "steps", "multi_step"])
def test_sharded_steps_match_the_jax_mesh(job, name):
    _compare(job, name)


def test_sharded_energies_match_the_jax_mesh(job):
    _compare(job, "energies")


@pytest.mark.parametrize("name", ["ptcldist", "fullf_ptcldist"])
def test_sharded_ptcldist_matches_the_jax_mesh(job, name):
    """fullf_ptcldist is test_sharded_fullf_ptcldist_subtracts_equilibrium_once's
    case: the raw histograms are summed before f0 comes off."""
    _compare(job, name)


def test_sharded_full_rho_matches_the_jax_mesh(job):
    _compare(job, "full_rho")


@pytest.mark.parametrize("name", ["push_pair", "collect"])
def test_sharded_push_pair_and_collect_match_the_jax_mesh(job, name):
    _compare(job, name)


def test_sharded_merge_matches_the_jax_mesh(job):
    """Merge pairs within each rank's block, on the profile summed over the
    ranks: the same live set as the JAX mesh's merge."""
    _compare(job, "merge")
    _, _, got, _, want = job
    assert int(np.sum(~got["merge.live"])) > 0


def test_only_rank_0_writes_pic1dp_out(job):
    """The mesh run's pic1dp.out against a single-process run's (made by the
    worker's rank 0, a process like the ranks): the same size and header
    bytes, each record within 1e-12 of its max."""
    world, workdir, got, infos, _ = job
    assert [i["writer"] for i in infos] == [True] + [False] * (world - 1)
    assert len({i["snapshots"] for i in infos}) == 1
    cfg = _configs(tcfg_mod)["simulation"]
    a, b = workdir / "run" / "pic1dp.out", workdir / "single" / "pic1dp.out"
    assert sorted(os.listdir(workdir / "run")) == ["pic1dp.out"]
    assert a.stat().st_size == b.stat().st_size
    header = 4 * (6 + cfg.nmode) + 8 * 2
    assert a.read_bytes()[:header] == b.read_bytes()[:header]
    da, db = OutputData(str(a)), OutputData(str(b))
    assert da.ntime == db.ntime == infos[0]["snapshots"]
    assert_rel(da.get_scalar_t(), db.get_scalar_t(), TOL, "scalars")
    assert_rel(da.get_mode_t(), db.get_mode_t(), TOL, "modes")
    for it in range(da.ntime):
        assert_rel(da.get_field_x(it), db.get_field_x(it), TOL, f"fields {it}")
        for d in range(3):
            assert_rel(da.get_ptcldist_xv(it, 0, d), db.get_ptcldist_xv(it, 0, d), TOL,
                       f"xv {it} {d}")
            assert_rel(da.get_ptcldist_v(it, 0, d), db.get_ptcldist_v(it, 0, d), TOL,
                       f"v {it} {d}")
    assert_rel(got["sim_energy.field"], da.get_scalar_t()[1], TOL, "snapshot energies")


def test_per_process_checkpoint_resumes_bit_for_bit(job):
    world, workdir, _, infos, _ = job
    assert all(i["resume_bitwise"] for i in infos), infos
    assert all(i["resume_itime"] == [8, 8] for i in infos)
    assert sorted(f for f in os.listdir(workdir / "ck")) == [
        f"checkpoint.npz.proc{r}.npz" for r in range(world)]
    with np.load(workdir / "ck" / "checkpoint.npz.proc1.npz") as ck:
        n_local = 8192 // world
        assert f"x@{n_local}" in ck.files and "electric" in ck.files and "x" not in ck.files
        assert ck[f"x@{n_local}"].shape == (1, n_local)


def test_indivisible_particle_count_rejected():
    cfg = tcfg_mod.landau_damping(nx=64, nparticle=8191, dtype="float64")
    mesh = pmesh.Mesh(group=None, rank=0, size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        pmesh.ShardedStepper(cfg, mesh)


def test_mesh_larger_than_the_job_is_refused():
    with pytest.raises(ValueError, match="processes"):
        pmesh.make_mesh(2, device="cpu")


def test_one_rank_mesh_is_the_single_device_step_bit_for_bit(tmp_path):
    """A one-rank gloo job: every all_reduce runs and returns its input, so
    the sharded steps, energies and snapshots are the unsharded ones."""
    cfg = tcfg_mod.bump_on_tail_default(nx=64, nparticle_max=4096, dtype="float64",
                                        verbosity=0, time_max=0.5)
    launch.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu")
    try:
        mesh = launch.global_mesh("cpu")
        assert mesh.group is not None and mesh.size == 1
        single = Simulation(cfg, device="cpu")
        sharded = Simulation(cfg, device="cpu", mesh=mesh)
        a, b = [], []
        single.run(snapshot_callback=a.append)
        sharded.run(snapshot_callback=b.append)
        for f in FIELDS:
            assert torch.equal(getattr(single.state, f), getattr(sharded.state, f)), f
        assert [q["field_energy"] for q in a] == [q["field_energy"] for q in b]
    finally:
        dist.destroy_process_group()
    assert not launch.is_io_process() or not dist.is_initialized()


def test_force_sharded_checkpoint_crosses_between_the_packages(tmp_path):
    """The JAX package's per-process file of an 8-device mesh resumes on the
    port's one-rank mesh, and the port's on the JAX package's one-device
    mesh, each state bit for bit."""
    jcfg = jcfg_mod.landau_damping(nx=32, nparticle=8192, time_max=1.0, dtype="float64",
                                   verbosity=0)
    tcfg = tcfg_mod.landau_damping(nx=32, nparticle=8192, time_max=1.0, dtype="float64",
                                   verbosity=0)
    jsim = JaxSimulation(jcfg, mesh=8)
    jsim.load()
    jsim.step_once()
    path = jsim.save_checkpoint(str(tmp_path / "jax.npz"), force_sharded=True)
    assert path.endswith(".proc0.npz")
    tsim = Simulation(tcfg, device="cpu", mesh=1)
    tsim.restore_checkpoint(str(tmp_path / "jax.npz"))
    for f in FIELDS:
        np.testing.assert_array_equal(tsim.state.to_numpy()[f], np.asarray(getattr(jsim.state, f)))
    assert (tsim.itime, tsim.time) == (jsim.itime, jsim.time)

    tsim.step_once()
    path = tsim.save_checkpoint(str(tmp_path / "port.npz"), force_sharded=True)
    assert path.endswith("port.npz.proc0.npz")
    back = JaxSimulation(jcfg, mesh=1)
    back.restore_checkpoint(str(tmp_path / "port.npz"))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back.state, f)), tsim.state.to_numpy()[f])
    moved = to_port(back.state)
    assert moved.nparticle_max == tcfg.nparticle_max


def test_run_py_mesh_under_torchrun_environment(tmp_path):
    """python -m pic1dp_tpu_torch.run --distributed --mesh 2, each process
    given torchrun's environment: one pic1dp.out, the single-process run's
    size and header, the records within 1e-12 of their max."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["-p", "landau", "-s", "nparticle_max=4096", "-s", "time_max=0.5",
            "-s", "dtype='float64'", "-s", "nx_opd=16", "-s", "nv_opd=16", "--device", "cpu"]
    out = tmp_path / "mesh"
    _run_job(tmp_path, 2,
             lambda rank: [sys.executable, "-m", "pic1dp_tpu_torch.run", *args,
                           "--distributed", "--mesh", "2", "-o", str(out)],
             lambda rank: {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                           "OMP_NUM_THREADS": "1"})
    _run_job(tmp_path, 1, lambda rank: [sys.executable, "-m", "pic1dp_tpu_torch.run", *args,
                                        "-o", str(tmp_path / "single")],
             lambda rank: {"OMP_NUM_THREADS": "1"})
    a, b = out / "pic1dp.out", tmp_path / "single" / "pic1dp.out"
    assert sorted(os.listdir(out)) == ["pic1dp.out"]
    assert a.stat().st_size == b.stat().st_size
    da, db = OutputData(str(a)), OutputData(str(b))
    assert_rel(da.get_scalar_t(), db.get_scalar_t(), TOL, "scalars")
    assert_rel(da.get_mode_t(), db.get_mode_t(), TOL, "modes")
