"""The cells bot_pre83.modes32 (32 kept modes: the substep kernels' grid
bin) and bot_pre83.out10 (a snapshot every 200 steps), at a size a test run
holds, on the CPU (the program's plain versions stand where the card runs
its kernels).

Both cells' files load through benchmark.spec; a sound run of each comes
out correct; a program whose projections of modes 17-32 are zeroed fails
the modes32 check, and a step that returns its state unchanged fails the
out10 check (its intervals are 200 steps long).
"""

import copy

import pytest
import torch

from benchmark import check, run as brun, spec
from benchmark.tests.test_bench_faults import SEED, _fault

CELLS = ["bot_pre83.modes32", "bot_pre83.out10"]
# out10's runs need at least two of its 200-step intervals (the warm-up run
# takes three)
SMALL = {"bot_pre83.modes32": dict(nparticle_max=8192, time_max=2.0),
         "bot_pre83.out10": dict(nparticle_max=8192, time_max=30.0)}


def _line(cell, tmp_path):
    bench = spec.load()
    cfg = copy.deepcopy(spec.config(bench, spec.workload(bench, cell)["config"]))
    cfg["program"].update(SMALL[cell])
    job = brun.make_job(bench, cell, SEED, 0.5, False, False, "cpu", str(tmp_path),
                        config=cfg)
    return brun.result_line(bench, job, brun.run_ranks(job))


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_files_load(cell):
    bench = spec.load()
    wl = spec.workload(bench, cell)
    assert wl["chips"] == 1
    cfg, traffic = spec.config(bench, wl["config"]), spec.traffic(wl["traffic"])
    assert set(spec.cell(cell)["limits"]) == set(check.NUMBERS)
    assert traffic["mesh"] is False
    prog = cfg["program"]
    if cell == "bot_pre83.modes32":
        assert prog["modes"] == list(range(1, 33)) and prog["init_modes"] == [1]
        assert traffic["output_interval"] == 0.5
        # field for field bot_pre83's program but for the kept modes
        base = spec.config(bench, "bot_pre83")["program"]
        assert {k: v for k, v in prog.items() if k != "modes"} == \
            {k: v for k, v in base.items() if k != "modes"}
    else:
        assert wl["config"] == "bot_pre83" and traffic["output_interval"] == 10.0


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_small_run_is_correct(cell, tmp_path):
    line = _line(cell, tmp_path)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and set(line["metrics"]) == {"pushes_per_s", "setup_s"}


def test_modes_17_to_32_left_out_fail_the_modes32_check(tmp_path, monkeypatch):
    from pic1dp_tpu_torch.ops import substep_kernels

    whole = substep_kernels.project_modes

    def first16(trig, val):
        pc, ps = whole(trig, val)
        keep = torch.arange(pc.shape[-1], device=pc.device) < 16
        return torch.where(keep, pc, 0.0), torch.where(keep, ps, 0.0)

    monkeypatch.setattr(substep_kernels, "project_modes", first16)
    line = _line("bot_pre83.modes32", tmp_path)
    assert not line["correct"]
    number, limit = line["compared"]["record_rel"]
    assert number > 10 * limit


def test_an_unchanged_step_fails_the_out10_check(tmp_path, monkeypatch):
    _fault("unchanged", monkeypatch)
    line = _line("bot_pre83.out10", tmp_path)
    assert not line["correct"]
    number, limit = line["compared"]["state_rel"]
    assert number > 10 * limit
