"""The harness on a two-species, physically loaded program, on the CPU.

The ion-acoustic program (`pic1dp_tpu_torch/examples/ion_acoustic.py`:
electrons and ions of mass 25 at T_i/T_e = 0.05, each species' markers drawn
from its own Maxwellian) is no cell yet.  These tests hold the three parts of
the harness it needs: the physical draws of `benchmark/markers.py`, the
physical loader of the reference, and `state_rel` taken species by species
(`benchmark/check.py`), whose ions are judged on their own scale, some
twenty times below the electrons'.  The uniform markers of every cell, and
`state_rel` of one species, stay bit for bit what they were.
"""

import copy
import hashlib
import math

import pytest
import torch

from benchmark import check, markers as markers_mod, run as brun, spec
from benchmark.reference import deltaf_spectral
from benchmark.tests.test_bench_faults import SEED, _fault

F64 = torch.float64
CELL = "bot_pre83.out05"       # its traffic and limits judge the program here
STATE_LIMIT = spec.cell(CELL)["limits"]["state_rel"]
# sha256 of x, v, p, w, live of markers.make(bot_pre83's physics, float32,
# 8192, 8192, seed, 0, "cpu"), as the uniform draws have always made them
UNIFORM_DIGESTS = {
    SEED: "b301c6c26db5c9bbd3b6692c8d8dd8a77cab9a01cb5cc099bf3e19ade40490f2",
    0: "48bfc1f07fa208502aa4d6a71fc5020345f7d7aaade3a0f2716661b76beb09eb",
}
# added to one ion's v at every substep 2: ten steps an interval carry it to
# about 8e-5, which reads about 2e-5 on the electrons' |v| (near 3.9 at 8192
# markers) and about 5e-4 on the ions' (near 0.17)
ION_KICK = 8e-6


def ion_acoustic_program(n: int, time_max: float) -> dict:
    """The ion-acoustic program as the examples run it, n markers a species,
    float32, as a configuration file's "program" section."""
    from pic1dp_tpu_torch.examples import ion_acoustic

    return ion_acoustic.config(n, time_max, device="cuda").to_dict()


def _bot_program() -> dict:
    bench = spec.load()
    return copy.deepcopy(spec.config(bench, spec.workload(bench, CELL)["config"])["program"])


def joint_state_rel(physics, state: dict, ref: dict) -> float:
    """`state_rel` as one scale for all species took it: the largest error
    of v (and of w) over every species over the largest |v_ref| (|w_ref|)
    over every species."""
    dx = (state["x"].to(F64) - ref["x"]).abs()
    dx = torch.minimum(dx, physics.lx - dx)
    x_rel, dv, vmax, dw, wmax = torch.stack([
        dx.max() / physics.lx,
        (state["v"].to(F64) - ref["v"]).abs().max(), ref["v"].abs().max(),
        (state["w"].to(F64) - ref["w"]).abs().max(), ref["w"].abs().max()]).tolist()
    return max(x_rel, dv / vmax if vmax > 0 else math.inf,
               dw / wmax if wmax > 0 else math.inf)


def species_state_rel(physics, state: dict, ref: dict) -> float:
    numbers = check.Numbers()
    check._state_errors(numbers, physics, state, ref, lambda t: t)
    return numbers.values["state_rel"]


def _digest(mk) -> str:
    h = hashlib.sha256()
    for t in (mk.x, mk.v, mk.p, mk.w, mk.live):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(UNIFORM_DIGESTS))
def test_uniform_markers_are_bit_for_bit_as_before(seed):
    physics = deltaf_spectral.Physics(_bot_program(), "cpu")
    mk = markers_mod.make(physics, torch.float32, 8192, 8192, seed, 0, "cpu")
    assert _digest(mk) == UNIFORM_DIGESTS[seed]


def test_physical_draws_follow_each_species_maxwellian():
    n = 1 << 20
    prog = ion_acoustic_program(n, 2.0)
    physics = deltaf_spectral.Physics(prog, "cpu")
    mk = markers_mod.make(physics, torch.float32, n, n, SEED, 0, "cpu")
    v = mk.v.to(F64)
    assert mk.x.min() >= 0 and mk.x.max() < physics.lx
    for s, sp in enumerate(prog["species"]):
        vth2 = sp["temperature"] / sp["mass"]
        mean, var = float(v[s].mean()), float(v[s].var())
        assert abs(mean - sp["v0"]) < 5 * math.sqrt(vth2 / n), (s, mean)
        assert abs(var - vth2) < 5 * vth2 * math.sqrt(2.0 / (n - 1)), (s, var, vth2)


def test_the_physical_loader_is_the_programs_formula():
    from pic1dp_tpu_torch import distributions as dist
    from pic1dp_tpu_torch.config import Config
    from pic1dp_tpu_torch.core.loading import _finish_load, _initial_w, _weights

    n = 4096
    prog = dict(ion_acoustic_program(n, 2.0), dtype="float64")
    cfg = Config.from_dict(prog)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((2, n), generator=gen, dtype=F64) * cfg.lx
    normal = torch.randn((2, n), generator=gen, dtype=F64)
    v, p = _weights(cfg, dist.SpeciesParams.from_config(cfg, F64, "cpu"), normal)
    loaded = _finish_load(cfg, x, v, p, _initial_w(cfg, x, p, v))
    p_ref, w_ref = deltaf_spectral.Physics(prog, "cpu").load_weights(x, v, n)
    torch.testing.assert_close(p_ref, loaded.p, rtol=1e-15, atol=0.0)
    torch.testing.assert_close(w_ref, loaded.w, rtol=1e-15, atol=0.0)


def test_physical_loading_needs_the_maxwellian():
    with pytest.raises(ValueError, match="Maxwellian"):
        deltaf_spectral.Physics(dict(_bot_program(), marker="physical"), "cpu")


def _states(ns: int, n: int, scales, seed: int):
    """A random reference state (float64) and the program's (it rounded to
    float32), (ns, n) each, v of species s at scales[s]."""
    gen = torch.Generator().manual_seed(seed)
    scale = torch.tensor(scales, dtype=F64)[:, None]
    ref = {"x": torch.rand((ns, n), generator=gen, dtype=F64) * 12.0,
           "v": torch.randn((ns, n), generator=gen, dtype=F64) * scale,
           "w": torch.randn((ns, n), generator=gen, dtype=F64) * 1e-7}
    return ref, {k: t.to(torch.float32) for k, t in ref.items()}


@pytest.mark.parametrize("seed", range(4))
def test_one_species_state_rel_is_the_joint_formula(seed):
    physics = deltaf_spectral.Physics(_bot_program(), "cpu")
    ref, state = _states(1, 8192, [1.0], seed)
    state["v"][0, seed] += 1e-3 * seed
    state["x"][0, 7] = (state["x"][0, 7] + 1e-4 * seed) % physics.lx
    assert species_state_rel(physics, state, ref) == joint_state_rel(physics, state, ref)


def test_an_ion_error_reads_on_the_ions_scale():
    physics = deltaf_spectral.Physics(ion_acoustic_program(8192, 2.0), "cpu")
    ref, state = _states(2, 8192, [1.0, math.sqrt(0.05 / 25.0)], SEED % 2**31)
    vmax = ref["v"].abs().amax(dim=1)
    # between the two scales, so that one reads under the limit and one over
    state["v"][1, 0] += STATE_LIMIT * float(torch.sqrt(vmax[0] * vmax[1]))
    joint, per_species = (joint_state_rel(physics, state, ref),
                          species_state_rel(physics, state, ref))
    print(f"ion error: joint state_rel {joint!r}, per species {per_species!r}, "
          f"limit {STATE_LIMIT!r}")
    assert joint < STATE_LIMIT < per_species


def _answer_ion(monkeypatch):
    """One ion's v altered as substep 2 writes it."""
    from pic1dp_tpu_torch.ops import substep_kernels

    step2 = substep_kernels.FusedSubsteps.substep2_plain

    def altered(self, x, v, *args, **kwargs):
        out = step2(self, x, v, *args, **kwargs)
        v[1, 0] += ION_KICK
        return out
    monkeypatch.setattr(substep_kernels.FusedSubsteps, "substep2_plain", altered)


def _line(tmp_path, control=False):
    bench = spec.load()
    cfg = {"reference": "deltaf_spectral", "program": ion_acoustic_program(8192, 2.0)}
    job = brun.make_job(bench, CELL, SEED, 0.5, False, control, "cpu", str(tmp_path),
                        config=cfg)
    return brun.result_line(bench, job, brun.run_ranks(job))


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "answer_marker", "answer_ion"])
def test_the_two_species_program_and_its_faults(fault, tmp_path, monkeypatch):
    joint = []
    if fault == "answer_ion":
        _answer_ion(monkeypatch)
        judge = check._state_errors

        def both(numbers, physics, state, ref, reduce_max):
            joint.append(joint_state_rel(physics, state, ref))
            judge(numbers, physics, state, ref, reduce_max)
        monkeypatch.setattr(check, "_state_errors", both)
    elif fault:
        _fault(fault, monkeypatch)
    line = _line(tmp_path)
    print(f"{fault}: {line['compared']}")
    assert line["correct"] == (fault is None), line["compared"]
    if fault == "answer_ion":
        number = line["compared"]["state_rel"][0]
        print(f"answer_ion: joint state_rel {max(joint)!r}, per species {number!r}, "
              f"limit {STATE_LIMIT!r}")
        assert max(joint) < STATE_LIMIT < number
        assert line["compared"]["record_rel"][0] <= line["compared"]["record_rel"][1]


def test_the_two_species_control_is_not_correct(tmp_path):
    """The bf16 weights fail the records: record_rel reads about 15 times
    its limit, here and at 2 x 2^22 markers on an H100.  state_rel may read
    under its limit, by how many intervals the window checks."""
    line = _line(tmp_path, control=True)
    print(f"control: {line['compared']}")
    assert not line["correct"]
    number, limit = line["compared"]["record_rel"]
    assert number > 3 * limit
