"""The species loop's grid: one species per block (ops/substep_kernels.py's
species_grid; the (bps, ns) launch grid, block_row, walk and grid_walk in
csrc/substep_kernels.cu).

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there).  Here: species_grid as a pure function of its arguments,
equal to launch_grid at one species, its values at the runs' shapes, a
numpy mirror of the kernels' index math (block (rank, species) of the
(bps, ns) grid and its partials row species * bps + rank, single-marker
head, V-marker groups, single-marker tail, in the register bins' form and
the grid bin's) that walks each of the ns n markers exactly once, and the
grid FusedSubsteps.grid_size hands the kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.ops import substep_kernels as sk

SMS = 132                    # an H100's SMs
# tests/test_torch_substep_design.py's marker counts for launch_grid
MARKERS = (1, 255, 102_400, 1_000_448, 2 * 2**20, 6_400_000, 2**26)
# blocks per SM: the register bins' BLOCKS_PER_SM and the grid bin's cap at
# nx 1024 in f64 (one block of grids an SM)
CAPS = (sk.BLOCKS_PER_SM, sk.grid_blocks_per_sm(1024, 8, 2))


@pytest.mark.parametrize("markers", MARKERS)
@pytest.mark.parametrize("vec", [1, 2, 4])
def test_species_grid_at_one_species_is_launch_grid(markers, vec):
    for b in (1, 2, 3, 4, 8):
        assert sk.species_grid(1, markers, vec, SMS, b) == sk.launch_grid(markers, vec, SMS, b)
    assert sk.species_grid(1, markers, vec, SMS) == sk.launch_grid(markers, vec, SMS)


@pytest.mark.parametrize("ns", [1, 2, 9, 17, 600])
@pytest.mark.parametrize("n", [1, 3, 102_400, 102_401])
@pytest.mark.parametrize("vec", [1, 2, 4])
def test_species_grid_is_a_pure_function_covering_each_species(ns, n, vec):
    for b in (1, 3, 4):
        grid = sk.species_grid(ns, n, vec, SMS, b)
        assert grid == sk.species_grid(ns, n, vec, SMS, b)      # fixed for a shape
        assert grid % ns == 0 and ns <= grid <= max(ns, b * SMS)
        bps = grid // ns
        # one pass per thread covers a species' markers, unless the cap binds
        assert bps * sk.THREADS * vec >= n or bps == max(1, b * SMS // ns)
        # and no block of a species is left without a group of its markers
        assert (bps - 1) * sk.THREADS * vec < n


def test_species_grid_values():
    # nine species of 102,400 in f32: 9 x 58 blocks, where the parent's
    # launch_grid gave 528 of which 100 had markers
    assert sk.species_grid(9, 102_400, 4, SMS) == 522
    assert sk.launch_grid(9 * 102_400, 4, SMS) == 528
    assert sk.species_grid(2, 102_400, 4, SMS) == 200           # 2 x 100
    assert sk.species_grid(2, 2**20, 4, SMS) == 528             # 2 x 264: the cap
    assert sk.species_grid(17, 2**14, 2, SMS) == 17 * 31
    # more species than B SMs: one block each
    assert sk.species_grid(600, 1000, 4, SMS) == 600
    assert sk.species_grid(17, 10, 4, 4, 4) == 17


def _walk(ns: int, n: int, vec: int, grid: int, aligned: bool, form: str,
          per_block: bool = True):
    """The kernels' index math for a launch of `grid` blocks over ns species
    of n markers: (marker, thread) for every marker a thread takes, thread
    = block * THREADS + lane, block the partials row (block_row: species *
    bps + rank in the (bps, ns) grid).  form "walk" is the register bins' walk (each
    thread steps on alone), "grid_walk" the grid bin's (every lane of a
    block runs each loop as often).  per_block False is the parent's
    species loop: every block walks every species from block 0.  The
    streams start 16-byte aligned; `aligned` False is a stream that is not
    (every marker a single)."""
    t_ = sk.THREADS
    lane = np.arange(t_)
    markers, threads = [], []
    for block in range(grid):
        if per_block:                                   # blockIdx (rank, s)
            bps = grid // ns
            s = block // bps
            jobs = [(s, block - s * bps, bps)]
        else:
            jobs = [(s, block, grid) for s in range(ns)]
        for s, rank, blocks in jobs:
            base = s * n
            head = min(n, (vec - base % vec) % vec) if aligned else n
            groups = (n - head) // vec
            stride = blocks * t_
            for lo, end, width, at in ((0, head, 1, base), (head + groups * vec, n, 1, base),
                                       (0, groups, vec, base + head)):
                if form == "walk":      # t = lo + first, + stride, ... while t < end
                    trips = max(0, -(-(end - lo - rank * t_) // stride))
                    k = lo + rank * t_ + lane[:, None] + stride * np.arange(trips)[None, :]
                    tid = np.broadcast_to(block * t_ + lane[:, None], k.shape)
                else:                   # k0 = lo + start, ...; lane k0 + lane
                    k = np.arange(lo + rank * t_, end, stride)[:, None] + lane[None, :]
                    tid = np.broadcast_to(block * t_ + lane[None, :], k.shape)
                on = k < end
                for j in range(width):
                    markers.append(at + k[on] * width + j)
                    threads.append(tid[on])
    return np.concatenate(markers), np.concatenate(threads)


@pytest.mark.parametrize("cap", CAPS, ids=["register", "grid_cap"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 102_400, 102_401])
@pytest.mark.parametrize("ns", [1, 2, 9, 17])
def test_each_marker_walked_once(ns, n, vec, aligned, cap):
    grid = sk.species_grid(ns, n, vec, SMS, cap)
    for form in ("walk", "grid_walk"):
        markers, threads = _walk(ns, n, vec, grid, aligned, form)
        assert markers.size == ns * n, form
        assert np.array_equal(np.bincount(markers, minlength=ns * n), np.ones(ns * n)), form
        # each block walks markers of its own species only
        species = markers // n
        assert np.array_equal(species, (threads // sk.THREADS) // (grid // ns)), form


@pytest.mark.parametrize("cap", CAPS, ids=["register", "grid_cap"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 102_400, 102_401])
def test_one_species_walks_the_parents_markers_in_its_blocks(n, vec, aligned, cap):
    """At one species each thread takes exactly the markers the parent's
    species loop gave it, in both forms, so the partials rows and the
    projections keep their bits."""
    grid = sk.species_grid(1, n, vec, SMS, cap)
    assert grid == sk.launch_grid(n, vec, SMS, cap)
    for form in ("walk", "grid_walk"):
        new = _walk(1, n, vec, grid, aligned, form)
        old = _walk(1, n, vec, grid, aligned, form, per_block=False)
        order_new, order_old = np.argsort(new[0], kind="stable"), np.argsort(old[0], kind="stable")
        assert np.array_equal(new[0][order_new], old[0][order_old]), form
        assert np.array_equal(new[1][order_new], old[1][order_old]), form


def test_nine_species_every_block_has_markers():
    """9 x 102,400 in f32: the parent's grid of 528 blocks walked every
    species from block 0, so only blocks 0-99 had markers; one species per
    block gives each of the 522 blocks its own."""
    ns, n, vec = 9, 102_400, 4
    old_grid, new_grid = sk.launch_grid(ns * n, vec, SMS), sk.species_grid(ns, n, vec, SMS)
    _, old = _walk(ns, n, vec, old_grid, True, "walk", per_block=False)
    _, new = _walk(ns, n, vec, new_grid, True, "walk")
    assert (old_grid, np.unique(old // sk.THREADS).size) == (528, 100)
    assert (new_grid, np.unique(new // sk.THREADS).size) == (522, 522)


def _nine_species(dtype="float32", n=102_400):
    sp = tcfg_mod.SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=1.0 / 9.0,
                                v0=0.0)
    base = tcfg_mod.landau_damping(nx=64, nparticle=n, k=0.5, amp=1e-4, time_max=20.0,
                                   output_interval=0.1, verbosity=0)
    return dataclasses.replace(base, species=(sp,) * 9, dtype=dtype).validate()


def _two_species_16_modes(dtype="float32", nx=1024):
    sp = dict(charge=-1.0, mass=1.0, temperature=1.0, density=0.5)
    return tcfg_mod.Config(
        lx=2.0 * np.pi / 0.2, equilibrium=tcfg_mod.Equilibrium.MAXWELLIAN,
        species=(tcfg_mod.SpeciesConfig(v0=3.0, **sp), tcfg_mod.SpeciesConfig(v0=-3.0, **sp)),
        nx=nx, nparticle_max=102_400, modes=tuple(range(1, 17)), dtype=dtype,
        verbosity=0).validate()


@pytest.mark.parametrize("label,cfg,want", [
    ("nine species f32", lambda: _nine_species(), lambda i: 522),
    ("nine species f64", lambda: _nine_species("float64"), lambda i: 9 * 58),
    ("main f32", lambda: tcfg_mod.bump_on_tail_default(dtype="float32", verbosity=0),
     lambda i: sk.launch_grid(6_400_000, 4, SMS)),
    ("two species 16 modes f32",
     lambda: _two_species_16_modes(),
     lambda i: 2 * min(sk.grid_blocks_per_sm(1024, 4, sk.grid_egrids(i)) * SMS // 2, 100)),
    ("two species 16 modes f64",
     lambda: _two_species_16_modes("float64"),
     lambda i: 2 * min(sk.grid_blocks_per_sm(1024, 8, sk.grid_egrids(i)) * SMS // 2, 200)),
])
def test_grid_size_takes_the_species_grid(label, cfg, want):
    cfg = cfg()
    dtype = getattr(torch, cfg.dtype)
    subs = sk.FusedSubsteps(cfg, tdist.SpeciesParams.from_config(cfg, dtype, "cpu"))
    itemsize = dtype.itemsize
    markers = cfg.nspecies * cfg.nparticle_max
    for substep in (1, 2):
        grid = subs.grid_size(markers, SMS, itemsize, substep)
        assert grid == want(substep), label
        assert grid % cfg.nspecies == 0
    if cfg.nspecies == 1:          # the main path: the parent's grid
        assert grid == sk.launch_grid(markers, subs._vec, SMS)


@pytest.mark.parametrize("ns,refused", [(sk.MAX_GRID_SPECIES, False),
                                        (sk.MAX_GRID_SPECIES + 1, True)])
def test_species_past_the_grids_y_extent_are_refused(ns, refused):
    """The species loop's grid is (bps, ns): ns is its y extent, which a
    launch caps at 65535."""
    cfg = tcfg_mod.landau_damping(nx=64, nparticle=1024, verbosity=0)
    cfg = dataclasses.replace(cfg, species=cfg.species * ns)
    if refused:
        with pytest.raises(NotImplementedError, match=f"{ns} species"):
            sk.kernel_params(cfg)
    else:
        assert sk.kernel_params(cfg).nspecies == ns
