"""The two-species ion-acoustic cell (benchmark/configs/ion_acoustic.json,
cell ion_acoustic.out1) against the benchmark's plain reference,
benchmark/reference/deltaf_spectral.py (torch, float64, no kernel of the
port), on the CPU at a small size.

  * the configuration's program is examples/ion_acoustic.config(2**22, 320)
    field for field, but for verbosity;
  * the harness finds the cell's configuration, traffic and cell files;
  * the configuration's route: the species loop in the 1-mode register bin,
    in the recompute layout;
  * through benchmark.run.make_job on the cell, at 8192 markers a species
    and t = 2, the port's run is judged correct, and judged not correct
    with bf16 weights, or with one ion's v kicked at each substep 2.

This file imports no jax, so the card's machine runs it too:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ion_acoustic.py"""

import copy

import pytest
import torch

from benchmark import run as brun
from benchmark import spec
from pic1dp_tpu_torch import distributions as dist
from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.examples import ion_acoustic
from pic1dp_tpu_torch.ops import substep_kernels as sk

# several test workers share the machine (as tests/_torch_port.py)
torch.set_num_threads(2)

CELL = "ion_acoustic.out1"
SEED = 2_828_000_028_001       # more than 32 bits, as a benchmark run's seed may be
SMALL = dict(nparticle_max=8192, time_max=2.0)
# added to one ion's v at every substep 2: an out1 interval of 20 steps
# carries it to about 1.6e-4, some 1e-3 of the ions' largest |v| (near 0.17)
# and 4e-5 of the electrons' (near 3.9)
ION_KICK = 8e-6


def _bench_config() -> dict:
    bench = spec.load()
    return spec.config(bench, spec.workload(bench, CELL)["config"])


def test_the_program_is_the_examples_run():
    prog = _bench_config()["program"]
    example = ion_acoustic.config(2**22, 320.0).to_dict()
    assert example["verbosity"] == 1 and prog["verbosity"] == 0
    assert dict(prog, verbosity=1) == example


def test_the_harness_finds_the_cells_files():
    bench = spec.load()
    assert spec.problems(bench) == []
    wl = spec.workload(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("ion_acoustic", "out1", 1)
    assert spec.config(bench, "ion_acoustic")["reference"] == "deltaf_spectral"
    traffic = spec.traffic("out1")
    assert (traffic["output_interval"], traffic["mesh"]) == (1.0, False)
    limits = spec.cell(CELL)["limits"]
    assert set(limits) == {"state_rel", "record_rel", "bad_records"}
    assert limits["bad_records"] == 0


def test_the_route_is_the_species_loop_in_the_one_mode_bin():
    cfg = Config.from_dict(_bench_config()["program"])
    assert cfg.nspecies == 2 and cfg.nmode == 1 and cfg.nparticle_max == 2**22
    assert sk.mode_bin(cfg.nmode) == 1
    assert sk.rebuilds_v1_faster(cfg) and sk.layout(cfg) == sk.RECOMPUTE
    subs = sk.FusedSubsteps(cfg, dist.SpeciesParams.from_config(cfg, torch.float32, "cpu"))
    assert subs.uses_species_loop() and not subs.uses_grid_bin() and subs.rebuilds_w1
    assert subs.counters == (sk.SUBSTEP1_RECOMPUTE, sk.SUBSTEP2_RECOMPUTE)


def _kick_one_ion(monkeypatch):
    """One ion's v altered as substep 2 writes it."""
    step2 = sk.FusedSubsteps.substep2_plain

    def kicked(self, x, v, *args, **kwargs):
        out = step2(self, x, v, *args, **kwargs)
        v[1, 0] += ION_KICK
        return out
    monkeypatch.setattr(sk.FusedSubsteps, "substep2_plain", kicked)


def _line(tmp_path, control: bool = False) -> dict:
    bench = spec.load()
    cfg = copy.deepcopy(_bench_config())
    cfg["program"].update(SMALL)
    job = brun.make_job(bench, CELL, SEED, 0.5, False, control, "cpu", str(tmp_path),
                        config=cfg)
    return brun.result_line(bench, job, brun.run_ranks(job))


@pytest.mark.parametrize("case", ["sound", "bf16_weights", "ion_kick"])
def test_the_cell_judges_the_run(case, tmp_path, monkeypatch):
    """The sound run is correct; the bf16-weight control fails its records,
    and an ion kicked at each substep 2 fails state_rel, which takes each
    species on its own scale."""
    if case == "ion_kick":
        _kick_one_ion(monkeypatch)
    line = _line(tmp_path, control=case == "bf16_weights")
    print(f"{case}: {line['compared']}")
    compared = line["compared"]
    assert line["correct"] == (case == "sound"), compared
    if case == "ion_kick":
        number, limit = compared["state_rel"]
        assert number > limit
    if case == "bf16_weights":
        number, limit = compared["record_rel"]
        assert number > limit
