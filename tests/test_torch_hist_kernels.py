"""The hat deposits onto small grids (pic1dp_tpu_torch/ops/hist_kernels.py):
the x-v snapshot histogram, the |delta f|(v) profile and the grid charge.

On the CPU each wrapper runs its plain version, one serial index_add_; the
kernels of csrc/hist_kernels.cu run only on the card (chip_smoke.py phase
3).  Here: each plain version against its JAX function on the same
numpy-seeded inputs in float64 at 1e-12 of max, ptcldist in every branch
with one and three species, the edge cases of phase 3 (markers on the
grids' edges, a count that is not a multiple of a block's markers, dead
markers, no markers, a grid past the card's shared memory); a CPU tensor
launches nothing; the CUDA path refuses what its kernels do not take
before any launch; a numpy mirror of the kernels' deposit (halves at the
lower cell, the fold, the block rows) gives the plain sums; and the load
and the deposits give the same bits at any torch thread count."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_rel, to_port

from pic1dp_tpu import config as jcfg_mod
from pic1dp_tpu import distributions as jdist
from pic1dp_tpu.core import diagnostics as jdiag
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.ops import deposit as jdeposit
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.core import diagnostics as tdiag
from pic1dp_tpu_torch.core.loading import load_particles
from pic1dp_tpu_torch.ops import hist_kernels as hk
from pic1dp_tpu_torch.ops.deposit import deposit

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
LX, V_MAX, NX, NV = 2.0 * np.pi / 0.36, 6.0, 64, 64
N_ODD = 102_401          # chip_smoke.HIST_N_ODD: no block's range ends at the end


def _markers(n, ns=1, seed=0, edges=True):
    """chip_smoke.hist_markers in float64 on the CPU, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, LX, (ns, n))
    v = rng.uniform(-1.1 * V_MAX, 1.1 * V_MAX, (ns, n))
    if edges and n >= 6:
        v[:, :4] = [-V_MAX, V_MAX, np.nextafter(-V_MAX, 0.0), np.nextafter(V_MAX, 0.0)]
        x[:, 4], x[:, 5] = 0.0, np.nextafter(LX, 0.0)
    p = np.exp(-0.5 * v**2) * LX * 2.0 * V_MAX / n
    w = 1e-3 * rng.standard_normal((ns, n))
    live = np.ones((ns, n), dtype=bool)
    live[:, ::7] = False
    p[~live], w[~live] = 0.0, 0.0
    return x, v, p, w, live


def _vals(p, w, live):
    return np.stack([live.astype(np.float64), np.where(live, p, 0.0), np.where(live, w, 0.0)])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- each plain version against its JAX function ----

@pytest.mark.parametrize("n, nx, nv", [(N_ODD, NX, NV), (4096, 128, 128), (5, NX, NV),
                                       (0, NX, NV)],
                         ids=["odd", "wide", "tiny", "empty"])
def test_deposit_xv_matches_jax(n, nx, nv):
    x, v, p, w, live = _markers(n)
    vals = _vals(p[0], w[0], live[0])
    got_xv, got_v = tdiag.deposit_xv(*_t(x[0], v[0], vals), LX, V_MAX, nx, nv)
    assert got_xv.shape == (3, nv, nx) and got_v.shape == (3, nv)
    if n == 0:
        assert not bool(got_xv.any()) and not bool(got_v.any())
        return
    want_xv, want_v = jdiag.deposit_xv(jnp.asarray(x[0]), jnp.asarray(v[0]), jnp.asarray(vals),
                                       LX, V_MAX, nx, nv, chunk=min(n, 4096))
    for c in range(3):
        assert_rel(got_xv[c], want_xv[c], TOL, f"xv channel {c}")
        assert_rel(got_v[c], want_v[c], TOL, f"v channel {c}")


def test_markers_on_the_edges_deposit_as_jax():
    """Only the edge markers: v at -v_max and v_max (skipped), one ulp inside
    each, x at 0 and one ulp below lx (the periodic wrap)."""
    x, v, p, w, live = _markers(6)
    v[0, 4:] = [0.5, -0.5]
    live[:] = True
    p, w = np.full_like(p, 0.25), np.linspace(-1.0, 1.0, 6)[None, :]
    vals = _vals(p[0], w[0], live[0])
    want, _ = jdiag.deposit_xv(jnp.asarray(x[0]), jnp.asarray(v[0]), jnp.asarray(vals),
                               LX, V_MAX, NX, NV, chunk=6)
    got, _ = tdiag.deposit_xv(*_t(x[0], v[0], vals), LX, V_MAX, NX, NV)
    assert_rel(got, want, TOL, "edge markers")
    assert float(got[0].sum()) == pytest.approx(4.0, abs=1e-12)   # two skipped
    want = jdiag.dist_pertb_abs_v(*(jnp.asarray(a) for a in (v, w, live)), V_MAX, NV)
    assert_rel(tdiag.dist_pertb_abs_v(*_t(v, w, live), V_MAX, NV), want, TOL, "edge profile")
    want = jdeposit.deposit(jnp.asarray(x.ravel()), jnp.asarray(w.ravel()), LX, NX,
                            method="segment")
    assert_rel(deposit(*_t(x, w), LX, NX), want, TOL, "edge charge")


def _ptcl_case(variant, ns):
    change = dict(deltaf={}, linear=dict(linear=True), fullf=dict(deltaf=False))[variant]
    out = []
    for m in (jcfg_mod, tcfg_mod):
        cfg = dataclasses.replace(m.landau_damping(nx=32, nparticle=N_ODD, amp=1e-2,
                                                   dtype="float64", verbosity=0), **change)
        sp = [dict(charge=-1.0, mass=1.0 + 0.2 * s, temperature=1.0 - 0.1 * s,
                   density=1.0 / ns, v0=0.5 * s, nparticle_init=N_ODD - 1000 * s)
              for s in range(ns)]
        out.append(dataclasses.replace(cfg, species=tuple(m.SpeciesConfig(**s) for s in sp)))
    return out


@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("variant", ["deltaf", "linear", "fullf"])
def test_ptcldist_matches_jax(variant, ns):
    """Every branch of ptcldist with one and three species, dead slots (the
    live counts below the capacity) and markers past v_max."""
    jcfg, tcfg = _ptcl_case(variant, ns)
    js = jax_load(jcfg, jax.random.PRNGKey(11))
    ts = to_port(js)
    ts.v[:, :50] = 1.2 * tcfg.v_max
    js = dataclasses.replace(js, v=jnp.asarray(ts.v.numpy()))
    jsp = jdist.SpeciesParams.from_config(jcfg, jnp.float64)
    tsp = tdist.SpeciesParams.from_config(tcfg, torch.float64, "cpu")
    for name, a, b in zip(tdiag.PtclDist._fields, tdiag.ptcldist(tcfg, tsp, ts),
                          jdiag.ptcldist(jcfg, jsp, js)):
        assert_rel(a, b, TOL, f"{variant} ns={ns}: {name}")


@pytest.mark.parametrize("ns, n", [(1, N_ODD), (9, 4097), (3, 0)])
def test_profile_matches_jax(ns, n):
    x, v, p, w, live = _markers(n, ns, seed=ns)
    got = tdiag.dist_pertb_abs_v(*_t(v, w, live), V_MAX, NV)
    assert got.shape == (ns, NV)
    if n == 0:
        assert not bool(got.any())
        return
    want = jdiag.dist_pertb_abs_v(*(jnp.asarray(a) for a in (v, w, live)), V_MAX, NV,
                                  chunk=min(n, 4096))
    assert_rel(got, want, TOL, "profile")


@pytest.mark.parametrize("method", ["segment", "onehot", "twolevel"])
@pytest.mark.parametrize("nx", [192, 32768])
def test_grid_charge_matches_every_jax_method(method, nx):
    x, v, p, w, live = _markers(N_ODD, 2, seed=3)
    val = -np.where(live, w, 0.0)
    want = jdeposit.deposit(jnp.asarray(x.ravel()), jnp.asarray(val.ravel()), LX, nx,
                            method=method)
    assert_rel(deposit(*_t(x, val), LX, nx), want, TOL, f"{method} nx={nx}")


def test_dead_markers_deposit_nothing():
    x, v, p, w, live = _markers(4097, 2, seed=5)
    live[:] = False
    w[:] = 0.0
    got = tdiag.dist_pertb_abs_v(*_t(v, np.ones_like(w), live), V_MAX, NV)
    assert not bool(got.any())
    assert not bool(deposit(*_t(x, w), LX, NX).any())
    hist, _ = tdiag.deposit_xv(*_t(x[0], v[0], _vals(p[0], w[0], live[0])), LX, V_MAX, NX, NV)
    assert not bool(hist.any())


# ---- the wrappers' dispatch ----

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, v, p, w, live = _markers(N_ODD, 2, seed=7)
    tx, tv, tw, tl = _t(x, v, w, live)
    vals = torch.from_numpy(_vals(p[0], w[0], live[0]))
    before = [k.launches for k in hk.KERNELS]
    assert torch.equal(hk.hist_xv(tx[0], tv[0], vals, LX, V_MAX, NX, NV),
                       hk.hist_xv_plain(tx[0], tv[0], vals, LX, V_MAX, NX, NV))
    assert torch.equal(hk.profile(tv, tw, tl, V_MAX, NV), hk.profile_plain(tv, tw, tl, V_MAX, NV))
    assert torch.equal(hk.grid_charge(tx, tw, LX, NX), hk.grid_charge_plain(tx, tw, LX, NX))
    assert [k.launches for k in hk.KERNELS] == before == [0] * len(hk.KERNELS)


def test_cuda_path_checks_its_inputs():
    """Off the CPU a hat deposit launches or raises: mixed devices, a dtype
    other than f32/f64 or mixed dtypes, a live mask that is not bool, more
    than three channels, a non-contiguous tensor and a device without the
    kernel raise before any launch."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    n = 4096
    x, v, vals = meta(n), meta(n), meta((3, n))
    live = meta((2, n), torch.bool)
    before = [k.launches for k in hk.KERNELS]
    with pytest.raises(ValueError, match="one device"):
        hk.hist_xv(x, torch.zeros(n), vals, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="one device and of one dtype"):
        hk.hist_xv(x, meta(n, torch.float64), vals, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="float32 or float64"):
        hk.grid_charge(meta(n, torch.float16), meta(n, torch.float16), LX, NX)
    with pytest.raises(ValueError, match="float32 or float64"):
        hk.profile(meta((2, n), torch.bfloat16), meta((2, n), torch.bfloat16), live, V_MAX, NV)
    with pytest.raises(ValueError, match="bool live mask"):
        hk.profile(meta((2, n)), meta((2, n)), meta((2, n)), V_MAX, NV)
    with pytest.raises(ValueError, match="bool live mask"):
        hk.profile(meta((2, n)), meta((2, n)), torch.zeros((2, n), dtype=torch.bool), V_MAX, NV)
    with pytest.raises(NotImplementedError, match="1 to 3 value channels"):
        hk.hist_xv(x, v, meta((4, n)), LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="contiguous"):
        hk.grid_charge(meta((2, n)).t(), meta((n, 2)), LX, NX)
    with pytest.raises(ValueError, match="one dtype"):
        hk.grid_charge(meta(n), meta(n, torch.float64), LX, NX)
    with pytest.raises(ValueError, match="no hist_xv kernel for device meta"):
        hk.hist_xv(x, v, vals, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="no profile kernel for device meta"):
        hk.profile(meta((2, n)), meta((2, n)), live, V_MAX, NV)
    with pytest.raises(ValueError, match="no grid_charge kernel for device meta"):
        hk.grid_charge(meta((2, n)), meta((2, n)), LX, NX)
    assert [k.launches for k in hk.KERNELS] == before


# ---- the kernels' design, mirrored on the CPU ----

@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, N_ODD, 6_400_000])
@pytest.mark.parametrize("per_sm", [1, 4])
def test_blocks_cover_every_marker_once(n, per_sm):
    g, per_block = hk.blocks(n, per_sm, 132)
    if n == 0:
        assert (g, per_block) == (0, 0)
        return
    assert per_block % hk.THREADS == 0 and 1 <= g <= per_sm * 132
    assert (g - 1) * per_block < n <= g * per_block


@pytest.mark.parametrize("itemsize, k, nbins, copies", [
    (4, 3, 64 * 64, 2), (8, 3, 64 * 64, 1), (4, 1, 192, 8), (4, 1, 128, 8),
    (4, 1, 16384, 1), (4, 1, 32768, 0), (8, 1, 32768, 0), (4, 2, 128 * 128, 0)])
def test_grid_copies_fit_one_block(itemsize, k, nbins, copies):
    """The grids of a block: the most copies of 8, 4, 2, 1 whose 2 k nbins
    values and the warps' stages fit one block's 232,448 bytes; none (the
    device buffer) past that."""
    smem, got = hk.plan_smem(itemsize, k, nbins)
    assert got == copies
    assert smem <= hk.SMEM_MAX
    assert smem == copies * 2 * k * nbins * itemsize + 8 * 64 * k * itemsize


def _mirror(kind, cells, left, right, nbins, nx, nv, blocks, per_block):
    """The kernels' order in numpy: each block sums its markers' halves at
    the lower cell (left half at [0, nbins), right at [nbins, 2 nbins)),
    folds each right half onto the next cell (periodic in x; none before a
    species' first v point), and the block rows are summed in block order."""
    out = np.zeros(nbins)
    for b in range(blocks):
        sl = slice(b * per_block, (b + 1) * per_block)
        grid = np.zeros(2 * nbins)
        ok = cells[sl] >= 0
        np.add.at(grid, cells[sl][ok], left[sl][ok])
        np.add.at(grid, nbins + cells[sl][ok], right[sl][ok])
        row = grid[:nbins].copy()
        o = np.arange(nbins)
        if kind == hk.V:
            prev = np.where(o % nv == 0, -1, o - 1)
        else:
            prev = np.where(o % nx == 0, o + nx - 1, o - 1)
        row[prev >= 0] += grid[nbins + prev[prev >= 0]]
        out += row
    return out


def test_mirror_of_the_kernels_order_gives_the_plain_sums():
    """The halves-and-fold design of csrc/hist_kernels.cu, mirrored with the
    kernels' own cells and weights, against the plain versions at 1e-12."""
    x, v, p, w, live = _markers(N_ODD, 3, seed=9)
    s = (v + V_MAX) * ((NV - 1) / (2.0 * V_MAX))
    fv = s - np.floor(s)
    iv0 = np.clip(np.floor(s), 0, NV - 2).astype(np.int64)
    inside = np.abs(v) < V_MAX
    sx = x * (NX / LX)
    fx = sx - np.floor(sx)
    ix0 = np.clip(np.floor(sx), 0, NX - 1).astype(np.int64)
    g, per_block = hk.blocks(x.size, 4, 132)
    # the grid charge (kX): every species in one flat run
    val = -np.where(live, w, 0.0)
    got = _mirror(hk.X, ix0.ravel(), ((1 - fx) * val).ravel(), (fx * val).ravel(), NX, NX, 2,
                  g, per_block)
    assert_rel(got, hk.grid_charge_plain(*_t(x, val), LX, NX), TOL, "grid charge")
    # the profile (kV): cell species * nv + iv0
    a = np.where(live & inside, np.abs(w), 0.0)
    cells = np.where(live & inside, np.arange(3)[:, None] * NV + iv0, -1)
    got = _mirror(hk.V, cells.ravel(), ((1 - fv) * a).ravel(), (fv * a).ravel(), 3 * NV, 1, NV,
                  g, per_block)
    assert_rel(got.reshape(3, NV), hk.profile_plain(*_t(v, w, live), V_MAX, NV), TOL, "profile")
    # the x-v histogram (kXV): two v rows a marker, each at cell iv nx + ix0
    vals = _vals(p[0], w[0], live[0])
    g, per_block = hk.blocks(x.shape[1], 1, 132)
    want = hk.hist_xv_plain(*_t(x[0], v[0], vals), LX, V_MAX, NX, NV)
    for c in range(3):
        row0 = np.where(inside[0], iv0[0] * NX + ix0[0], -1)
        rows = []
        for cell, wv in ((row0, 1 - fv[0]), (np.where(row0 >= 0, row0 + NX, -1), fv[0])):
            rows.append((cell, wv * (1 - fx[0]) * vals[c], wv * fx[0] * vals[c]))
        cells = np.concatenate([r[0].reshape(-1, 1) for r in rows], axis=1).ravel()
        left = np.concatenate([r[1].reshape(-1, 1) for r in rows], axis=1).ravel()
        right = np.concatenate([r[2].reshape(-1, 1) for r in rows], axis=1).ravel()
        got = _mirror(hk.XV, cells, left, right, NV * NX, NX, NV, g, 2 * per_block)
        assert_rel(got.reshape(NV, NX), want[c], TOL, f"x-v channel {c}")


def test_source_has_no_float_atomic_and_no_torch_header():
    csrc = REPO / "pic1dp_tpu_torch" / "csrc"
    src = (csrc / f"{hk.SOURCE}.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    # the warp's sum is the substep kernels' deposit_lanes, from their header
    assert re.findall(r'#include "([^"]+)"', code) == ["substep_math.cuh"]
    header = re.sub(r"//[^\n]*", "", (csrc / "substep_math.cuh").read_text())
    assert "deposit_lanes" in header and "deposit_lanes_k" not in code
    for text in (code, header):
        assert "atomic" not in text
        assert "#include <torch" not in text and "ATen" not in text
    assert re.search(r"extern \"C\"", code)


# ---- the same bits at any thread count ----

def test_load_and_deposits_repeat_at_any_torch_thread_count():
    """The loader, the snapshot histograms, the profile and the grid charge
    of a CPU run give the same bits at 1, 2 and 4 torch threads (past
    ATen's 32,768-element grain, so the elementwise loops split).  Torch's
    CPU reductions (the energies, the mode projections) are not held to
    this: their chunks move with the thread count."""
    cfg = tcfg_mod.landau_damping(nx=32, nparticle=2**16 + 3, time_max=1.0, dtype="float64",
                                  verbosity=0, nx_opd=16, nv_opd=16)
    sp = tdist.SpeciesParams.from_config(cfg, torch.float64, "cpu")
    threads = torch.get_num_threads()
    outs = []
    try:
        for nt in (1, 2, 4):
            torch.set_num_threads(nt)
            st = load_particles(cfg, "cpu")
            val = torch.where(st.live, st.w, 0.0)
            outs.append([st.x, st.v, st.p, st.w, *tdiag.ptcldist(cfg, sp, st),
                         tdiag.dist_pertb_abs_v(st.v, st.w, st.live, cfg.v_max, cfg.nv),
                         deposit(st.x, val, cfg.lx, cfg.nx)])
    finally:
        torch.set_num_threads(threads)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))
