"""A snapshot's device half as one packed buffer (diagnostics.SnapshotLayout,
Stepper.snapshot, Stepper.snapshot_graph): unpacked, it holds the separate
energies, ptcldist and field arrays bit for bit; a run writes the same
pic1dp.out as from those arrays; what a snapshot callback keeps stays valid;
one copy a snapshot.  The tests marked `chip` run on a CUDA device only:
the marker pass (diagnostics.marker_pass) gives the plain chain's six
histograms bit for bit and its energies within 1e-6 of their terms' size,
dead and fast markers included; a graph replay is the eager chain bit for
bit; two runs write the same pic1dp.out and count one marker pass a
species and snapshot; and an optimization event that moves the state's
buffers leads to a new capture.  This file imports
no jax, so the card's machine runs it:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_snapshot.py -m chip"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.config import OptimizationConfig, SpeciesConfig
from pic1dp_tpu_torch.config import bump_on_tail_default as bot
from pic1dp_tpu_torch.config import landau_damping
from pic1dp_tpu_torch.core import diagnostics
from pic1dp_tpu_torch.core import step as step_mod
from pic1dp_tpu_torch.core.diagnostics import Energies, PtclDist, Snapshot, SnapshotLayout
from pic1dp_tpu_torch.io.writer import SnapshotWriter

SMALL = dict(nx=32, nparticle_max=4096, time_max=1.0, verbosity=0)
THREE = (SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0, v0=0.0),
         SpeciesConfig(charge=1.0, mass=100.0, temperature=0.5, density=0.5, v0=0.0),
         SpeciesConfig(charge=1.0, mass=400.0, temperature=0.25, density=0.5, v0=0.0))


def _landau(**kw):
    cfg = landau_damping(nx=SMALL["nx"], nparticle=SMALL["nparticle_max"],
                         time_max=SMALL["time_max"])
    return dataclasses.replace(cfg, **{"verbosity": 0, **kw}).validate()


CASES = {
    "one_species": lambda: bot(**SMALL),
    "three_species": lambda: _landau(species=THREE, dtype="float64"),
    "linear": lambda: _landau(linear=True),
    "fullf": lambda: _landau(deltaf=False, dtype="float64"),
    "fullf_three": lambda: _landau(deltaf=False, species=THREE),
    "diag_full_rho": lambda: bot(**dict(SMALL, diag_full_rho=True, dtype="float64")),
    "bf16_weights": lambda: bot(**dict(SMALL, bf16_weights=True)),
    "verbosity3": lambda: bot(**dict(SMALL, verbosity=3)),
    "verbosity3_f64": lambda: _landau(species=THREE, dtype="float64", verbosity=3),
}


def _same(a, b) -> bool:
    """Bit for bit: dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _separate(sim: Simulation) -> list[np.ndarray]:
    """The snapshot's arrays as the Simulation formed them before they were
    packed: energies and ptcldist (on a CUDA device from the marker pass),
    the field arrays and the live counts, each formed and copied on its own."""
    st, stepper = sim.state, sim.stepper
    rho = stepper.full_rho(st) if sim.cfg.diag_full_rho else st.rho
    if st.x.is_cuda:
        eng, ptcl = diagnostics.marker_pass(sim.cfg, stepper.sp, st, stepper.reduce_sum)
    else:
        eng, ptcl = stepper.energies(st), stepper.ptcldist(st)
    arrays = [*eng, st.mode_re, st.mode_im, st.electric, rho, *ptcl]
    if sim.cfg.verbosity >= 3:
        arrays.append(stepper.reduce_sum(st.nparticles())[0])
    return [t.detach().cpu().numpy() for t in arrays]


def _unpacked(snap: Snapshot) -> list[np.ndarray]:
    return [*snap.energies, snap.mode_re, snap.mode_im, snap.electric, snap.rho,
            *snap.ptcl] + ([snap.nlive] if snap.nlive is not None else [])


def _stepped(cfg, out_path=None, device="cpu") -> Simulation:
    sim = Simulation(cfg, out_path=out_path, device=device)
    sim.load()
    sim.state = sim.stepper.multi_step(sim.state, 3)
    return sim


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_packed_snapshot_holds_the_separate_arrays(case):
    sim = _stepped(CASES[case]())
    layout = sim.snapshot_layout
    assert layout.live_count == (sim.cfg.verbosity >= 3)
    packed = sim.stepper.snapshot(sim.state, layout, sim.cfg.diag_full_rho)
    assert packed.dtype == sim.stepper.dtype and packed.shape == (layout.numel,)
    got = _unpacked(layout.unpack(packed.numpy()))
    want = _separate(sim)
    assert len(got) == len(want) == len(layout.shapes)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), (case, k)
    if layout.live_count:
        assert got[-1].tolist() == [int(sim.state.live[s].sum())
                                    for s in range(sim.cfg.nspecies)]


def test_the_layout_refuses_an_array_of_another_dtype():
    cfg = bot(**SMALL)
    layout = SnapshotLayout(cfg, torch.float32)
    sim = _stepped(cfg)
    snap = layout.unpack(sim.stepper.snapshot(sim.state, layout).numpy())
    tensors = [torch.from_numpy(np.array(a)) for a in _unpacked(snap)]
    eng = Energies(tensors[0].double(), *tensors[1:4])
    with pytest.raises(ValueError, match="float64"):
        layout.pack(Snapshot(eng, *tensors[4:8], PtclDist(*tensors[8:14]), None))


class _SeparateWriter:
    """A snapshot callback that writes the separate arrays of the
    Simulation's state to a second pic1dp.out, as the writer was handed them
    before they were packed."""

    def __init__(self, sim: Simulation, path):
        self.sim, self.writer = sim, SnapshotWriter(sim.cfg, str(path))

    def __call__(self, snap) -> None:
        a = _separate(self.sim)
        self.writer.write_snapshot(snap["time"], Energies(*a[:4]), *a[4:8], PtclDist(*a[8:14]))


@pytest.mark.parametrize("case", ["one_species", "three_species", "diag_full_rho",
                                  "verbosity3"])
def test_a_run_writes_the_records_of_the_separate_arrays(tmp_path, case, capsys):
    sim = Simulation(CASES[case](), out_path=str(tmp_path / "packed"), device="cpu")
    sep = _SeparateWriter(sim, tmp_path / "separate")
    sim.run(snapshot_callback=sep)
    sep.writer.close()
    packed = (tmp_path / "packed" / "pic1dp.out").read_bytes()
    assert sim.timers.calls("output") == 3
    assert packed == (tmp_path / "separate" / "pic1dp.out").read_bytes()


def test_what_a_callback_keeps_stays_valid(tmp_path):
    sim = Simulation(bot(**SMALL), out_path=str(tmp_path), device="cpu")
    kept, copies = [], []

    def keep(snap):
        kept.append(snap)
        copies.append(copy.deepcopy(snap))

    sim.run(snapshot_callback=keep)
    assert len(kept) == 3
    for snap, was in zip(kept, copies):
        for key in was:
            assert _same(snap[key], was[key]), key
    assert not np.shares_memory(kept[0]["mode_re"], kept[1]["mode_re"])
    assert not _same(kept[1]["mode_re"], kept[2]["mode_re"])


@pytest.mark.parametrize("verbosity", [0, 3])
def test_one_copy_a_snapshot(tmp_path, verbosity, capsys):
    sim = Simulation(bot(**dict(SMALL, verbosity=verbosity)), out_path=str(tmp_path),
                     device="cpu")
    sim.run()
    t, layout = sim.timers, sim.snapshot_layout
    snaps = t.calls("output")
    assert snaps == 3 and t.calls("output: device") == 3
    assert t.counter("snapshot d2h copies") == snaps
    assert t.counter("snapshot d2h bytes") == snaps * layout.numel * 4
    # the CPU runs the chain eagerly, never from a graph
    assert t.counter("snapshot eager") == snaps
    assert t.counter("snapshot graph replays") == 0 == t.counter("snapshot graph captures")
    assert t.calls("output: capture") == 0


# ---- on a CUDA device ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the snapshot graph runs on the card only")
    return torch.device("cuda")


CHIP_CASES = {
    "one_species": lambda: bot(**dict(SMALL, nparticle_max=1 << 16, nx=192)),
    "bf16_weights": lambda: bot(**dict(SMALL, nparticle_max=1 << 16, bf16_weights=True)),
    "diag_full_rho_verbosity3_f64": lambda: bot(**dict(
        SMALL, nparticle_max=1 << 16, diag_full_rho=True, verbosity=3, dtype="float64")),
    "three_species_fullf": lambda: _landau(deltaf=False, species=THREE),
    "linear": lambda: _landau(linear=True),
}


def _dead_and_fast(sim: Simulation) -> None:
    """Every 13th marker dead (p = w = 0, as the loader leaves them) and
    every 17th from the first past +-v_max, in place."""
    st, vm = sim.state, sim.cfg.v_max
    st.live[:, ::13] = False
    st.p[:, ::13] = 0.0
    st.w[:, ::13] = 0.0
    fast = st.v[:, 1::17]
    fast.copy_(torch.where(fast < 0, -1.2 * vm, 1.2 * vm) + 0.01 * fast)


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CHIP_CASES))
def test_the_marker_pass_is_the_plain_chain(cuda, case):
    """The pass's six histograms equal ptcldist's (the three-channel stack
    through hist_xv) bit for bit; each energy is within 1e-6 of its terms'
    size of energies' (torch's sums of v^2 times live, p and w), with dead
    markers and markers past v_max in the state."""
    sim = _stepped(CHIP_CASES[case](), device=cuda)
    _dead_and_fast(sim)
    cfg, st, sp = sim.cfg, sim.state, sim.stepper.sp
    assert bool((st.v.abs() >= cfg.v_max).any()) and not bool(st.live.all())
    eng, ptcl = diagnostics.marker_pass(cfg, sp, st)
    for name, a, b in zip(PtclDist._fields, ptcl, diagnostics.ptcldist(cfg, sp, st)):
        assert _same(a.cpu().numpy(), b.cpu().numpy()), name
    v2 = torch.where(st.live, st.v * st.v, 0.0).double()
    sums = {k: (v2 * t.double().abs()).sum(dim=1)
            for k, t in (("1", torch.ones_like(v2)), ("p", st.p), ("w", st.w))}
    scale = {"field": None, "marker": sums["1"],
             "total": sums["p"] + (sums["w"] if cfg.linear else 0.0),
             "pertb": sums["w"] if cfg.deltaf else sums["p"]}
    for name, a, b in zip(Energies._fields, eng, diagnostics.energies(cfg, sp, st)):
        if scale[name] is None:
            assert _same(a.cpu().numpy(), b.cpu().numpy()), name
            continue
        err = (a.double() - b.double()).abs()
        assert bool((err <= 1e-6 * scale[name]).all()), (name, err, scale[name])


@pytest.mark.chip
@pytest.mark.parametrize("case", ["one_species", "three_species_fullf"])
def test_runs_repeat_and_count_their_marker_passes(cuda, tmp_path, case):
    """Two runs write pic1dp.out byte for byte alike, and each counts one
    marker pass a species and snapshot, the graph's replays included."""
    cfg = CHIP_CASES[case]()
    outs = []
    for k in range(2):
        keys, t = _run(cfg, tmp_path / str(k), cuda)
        assert t.counter("snapshot graph replays") == len(keys) - 1
        assert t.counter("snapshot marker passes") == cfg.nspecies * len(keys)
        outs.append((tmp_path / str(k) / "pic1dp.out").read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CHIP_CASES))
def test_a_replay_is_the_eager_chain_bit_for_bit(cuda, case):
    sim = _stepped(CHIP_CASES[case](), device=cuda)
    stepper, layout = sim.stepper, sim.snapshot_layout
    full = sim.cfg.diag_full_rho
    assert stepper.snapshot_graph(sim.state, layout, full) is None   # not warm yet
    for _ in range(2):
        eager = stepper.snapshot(sim.state, layout, full).cpu().numpy()
        graph = stepper.snapshot_graph(sim.state, layout, full)
        assert graph is not None
        graph.replay()
        assert _same(graph.out.cpu().numpy(), eager)
        assert _same(eager, np.concatenate([a.reshape(-1).view(eager.dtype)
                                            for a in _separate(sim)]))
        sim.state = stepper.multi_step(sim.state, 5)
    assert stepper.timers.counter("snapshot graph captures") == 1


def _run(cfg, path, device, graphs=True):
    """A run's snapshots, the state's addresses at each and the timers; with
    graphs=False every snapshot runs the chain eagerly."""
    sim = Simulation(cfg, out_path=str(path), device=device)
    if not graphs:
        sim.stepper.snapshot_graph = lambda *args: None
    keys = []
    sim.run(snapshot_callback=lambda snap: keys.append(step_mod._addresses(
        sim.state, ("x", "v", "p", "w", "live", "mode_re", "mode_im", "electric", "rho"))))
    return keys, sim.timers


@pytest.mark.chip
def test_an_event_that_moves_the_buffers_captures_again(cuda, tmp_path):
    cfg = bot(**dict(SMALL, nparticle_max=1 << 16, time_max=2.0,
                     optimization=OptimizationConfig(tmerge=(0.5, 1.2),
                                                     thshmerge=(0.3, 0.3))))
    keys, t = _run(cfg, tmp_path / "graph", cuda)
    _, eager = _run(cfg, tmp_path / "eager", cuda, graphs=False)
    # snapshot 0 eager, a capture at 1 and wherever the buffers moved since
    moves = sum(a != b for a, b in zip(keys[1:], keys[2:]))
    assert keys[0] != keys[1] and moves >= 1
    assert t.counter("snapshot eager") == 1
    assert t.counter("snapshot graph captures") == 1 + moves == t.calls("output: capture")
    assert t.counter("snapshot graph replays") == len(keys) - 1
    assert eager.counter("snapshot eager") == len(keys)
    assert (tmp_path / "graph" / "pic1dp.out").read_bytes() == \
        (tmp_path / "eager" / "pic1dp.out").read_bytes()
