"""The check's control and faults, at a size a test run holds, on the CPU
(the program's plain versions stand where the card runs its kernels).

Each cell runs the harness's whole run (set-up, the window of whole runs,
the check against the plain reference) past the look for a card.  A sound
run comes out correct; the control (the program's bfloat16 weights) and
each fault the cell can have come out not correct:

  unchanged  a step that returns its state unchanged
  half       half of the markers left out of the projections, the sum over
             the rest doubled
  exchange   the all_reduces between the processes left out (mesh cell)
  answer     an answer altered where it is produced: a record's field
             energy as it is written, one marker's x as a step writes it
"""

import copy
import dataclasses
import json
import multiprocessing
import os

import pytest

from benchmark import run as brun, spec

SEED = 2_718_281_828_459      # more than 32 bits, as the driver's are
SMALL = dict(nparticle_max=8192, time_max=2.0)


def _job(cell, tmp_path, control=False):
    bench = spec.load()
    cfg = copy.deepcopy(spec.config(bench, spec.workload(bench, cell)["config"]))
    cfg["program"].update(SMALL)
    return bench, brun.make_job(bench, cell, SEED, 0.5, False, control, "cpu", str(tmp_path),
                                config=cfg)


def _line(cell, tmp_path, control=False):
    bench, job = _job(cell, tmp_path, control)
    return brun.result_line(bench, job, brun.run_ranks(job))


def _fault(name, monkeypatch):
    from pic1dp_tpu_torch.core.step import Stepper
    from pic1dp_tpu_torch.io.writer import SnapshotWriter
    from pic1dp_tpu_torch.ops import spectral, substep_kernels

    if name == "unchanged":
        monkeypatch.setattr(Stepper, "advance", lambda self, state, k: state)
    elif name == "half":
        whole = spectral.project_modes

        def half(trig, val):
            n = val.shape[-1] // 2
            w0, w1, per_mode = trig
            pc, ps = whole((w0[..., :n], w1[..., :n], [tuple(t[..., :n] for t in m)
                                                       for m in per_mode]), val[..., :n])
            return 2.0 * pc, 2.0 * ps
        monkeypatch.setattr(spectral, "project_modes", half)
        monkeypatch.setattr(substep_kernels, "project_modes", half)
    elif name == "answer_record":
        write = SnapshotWriter.write_snapshot

        def altered(self, time, energies, *rest):
            write(self, time, energies._replace(field=energies.field * 1.001), *rest)
        monkeypatch.setattr(SnapshotWriter, "write_snapshot", altered)
    elif name == "answer_marker":
        step2 = substep_kernels.FusedSubsteps.substep2_plain

        def altered(self, x, *args, **kwargs):
            out = step2(self, x, *args, **kwargs)
            x[0, 0] = (x[0, 0] + 0.01) % self.cfg.lx
            return out
        monkeypatch.setattr(substep_kernels.FusedSubsteps, "substep2_plain", altered)
    elif name == "exchange":
        monkeypatch.setattr(Stepper, "reduce_sum", lambda self, *tensors: tensors)
    else:
        raise ValueError(name)


ONE_CARD = ["bot_pre83.out05", "bot_1e9_share.out05"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_sound_run_is_correct(cell, tmp_path):
    line = _line(cell, tmp_path)
    assert line["correct"], line["compared"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(line["metrics"]) == {"pushes_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ONE_CARD)
def test_each_run_reads_and_removes_its_record_file(cell, tmp_path):
    """Every run writes the one pic1dp.out of the process; what the check
    needs is read as the run ends and the file is removed, so no run's
    records wait on disk for the window's end."""
    bench, job = _job(cell, tmp_path)
    job.traced = True       # the window then runs past its profiled run, run 1
    results = brun.run_ranks(job)
    assert results[0]["runs"] >= 3
    assert not (tmp_path / "out" / "pic1dp.out").exists()
    assert brun.result_line(bench, job, results)["correct"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_the_control_is_not_correct(cell, tmp_path):
    line = _line(cell, tmp_path, control=True)
    assert not line["correct"]
    number, limit = line["compared"]["state_rel"]
    assert number > 3 * limit


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer_record", "answer_marker"])
@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    _fault(fault, monkeypatch)
    assert not _line(cell, tmp_path)["correct"]


def test_a_traced_run_gives_the_per_layer_line(tmp_path):
    bench, job = _job("bot_pre83.out05", tmp_path)
    job.traced = True
    line = brun.result_line(bench, job, brun.run_ranks(job))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "compared"]
    assert line["correct"] and "snapshot_ms" in line["metrics"]
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _rank_main(job_dict, rank, fault):
    import torch

    torch.set_num_threads(1)
    from benchmark.session import Job, run_rank

    if fault:
        _fault(fault, pytest.MonkeyPatch())     # this process ends with the run
    result = run_rank(Job(**job_dict), rank)
    with open(os.path.join(job_dict["out_dir"], f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


# the mesh cell as BENCHMARK.json would hold it: cell 2's configuration on
# four processes through the mesh traffic, judged by cell 2's limits
MESH = {"name": "bot_1e9_share.out05.x4", "config": "bot_1e9_share", "traffic": "out05.x4",
        "chips": 4, "why": "the mesh path"}


def _mesh_line(tmp_path, fault):
    bench = spec.load()
    if not any(w["name"] == MESH["name"] for w in bench["workloads"]):
        bench["workloads"].append(MESH)
    cfg = copy.deepcopy(spec.config(bench, MESH["config"]))
    cfg["program"].update(SMALL)
    job = brun.make_job(bench, MESH["name"], SEED, 0.5, False, False, "cpu", str(tmp_path),
                        config=cfg)
    job.init_method = f"tcp://localhost:{brun._free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(dataclasses.asdict(job), r, fault))
             for r in range(job.ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    results = []
    for r in range(job.ranks):
        with open(os.path.join(job.out_dir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return brun.result_line(bench, job, results,
                            limits=spec.cell("bot_1e9_share.out05")["limits"])


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_the_mesh_cell_without_its_exchange_is_not_correct(fault, tmp_path):
    line = _mesh_line(tmp_path, fault)
    assert line["correct"] == (fault is None), line["compared"]
    assert line["device"]["count"] == 4


@pytest.mark.chip
def test_the_control_on_the_card_is_not_correct():
    """The control at the cell's own size on the card (a few minutes)."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "bot_pre83.out05", "--seed", str(SEED), "--seconds", "10",
                           "--trace", "0", "--control"], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False


def test_a_run_is_freed_when_it_ends(tmp_path):
    """The spans around a run's calls hold the run weakly, so a finished
    run (with its CUDA graphs, on the card) is freed at once and never by
    the cyclic collector, which could destroy graphs while a later run
    captures one and so invalidate that capture."""
    import gc
    import weakref

    import torch

    from benchmark import markers as markers_mod, reference, session
    from pic1dp_tpu_torch.config import Config
    from pic1dp_tpu_torch.core.simulation import Simulation
    from pic1dp_tpu_torch.core.state import SimState

    bench, job = _job("bot_pre83.out05", tmp_path)
    prog = session.program_config(job)
    cfg = Config.from_dict(prog)
    physics = reference.module(job.config["reference"]).Physics(prog, "cpu")
    mk = markers_mod.make(physics, torch.float32, cfg.nparticle_max, cfg.nparticle_max, SEED,
                          0, "cpu")
    sim = Simulation(cfg, out_path=str(tmp_path / "run"), device="cpu")
    zx, zm = torch.zeros(cfg.nx), torch.zeros(cfg.nmode)
    sim.state = sim.stepper.initial_field(SimState(
        x=mk.x.clone(), v=mk.v.clone(), p=mk.p.clone(), w=mk.w.clone(), live=mk.live,
        rho=zx.clone(), electric=zx.clone(), mode_re=zm.clone(), mode_im=zm.clone()))
    session._span_method(sim, "output_snapshot", "bench.output_snapshot")
    session._span_method(sim.stepper, "multi_step", "bench.multi_step")
    sim.run()
    alive = [weakref.ref(sim), weakref.ref(sim.stepper)]
    gc.disable()
    try:
        del sim
        assert [ref() for ref in alive] == [None, None]
    finally:
        gc.enable()
