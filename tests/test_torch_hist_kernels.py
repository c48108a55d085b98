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
before any launch; the plan of a block's grids and the blocks' marker
ranges; a numpy mirror of the kernels' order (lane copies for the profile
and the grid charge; for the x-v histogram one channel a block, copies
shared by two warps, halves at the lower cell and the fold; the row sum's
fixed order) gives the plain sums; a mirror of the marker pass's moment
order (lanes, warp tree, warps, row groups) gives the energies' raw sums,
counting markers past v_max and no dead one; the marker pass
(diagnostics.marker_pass) gives ptcldist's histograms bit for bit and the
energies within rounding; and the load and the deposits give the same bits
at any torch thread count."""

import dataclasses
import math
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
from pic1dp_tpu_torch.core.state import SimState
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
    other than f32/f64 or mixed dtypes (for the marker pass's p, other than
    x's or bfloat16), a live mask that is not bool, more than three
    channels, a non-contiguous tensor and a device without the kernel raise
    before any launch."""
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
    flag = meta(n, torch.bool)
    with pytest.raises(ValueError, match="bool live mask"):
        hk.xv_pass(x, v, meta(n), x, v, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="or bfloat16"):
        hk.xv_pass(x, v, flag, meta(n, torch.float16), v, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="contiguous p"):
        hk.xv_pass(x, v, flag, meta(2 * n, torch.bfloat16)[::2], v, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="one shape"):
        hk.xv_pass(x, v, flag, meta(n + 1, torch.bfloat16), v, LX, V_MAX, NX, NV)
    with pytest.raises(ValueError, match="no xv_pass kernel for device meta"):
        hk.xv_pass(x, v, flag, meta(n, torch.bfloat16), v, LX, V_MAX, NX, NV)
    assert [k.launches for k in hk.KERNELS] == before


# ---- the kernels' design, mirrored on the CPU ----

# (kind, warps, channels): D3's, D1's at 64 x 64, the buffer
PLANS = [(hk.X, 8, 1), (hk.XV, 12, 3), (hk.X, 1, 1)]


@pytest.mark.parametrize("kind, warps, k", PLANS, ids=["d3", "d1", "buffer"])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, N_ODD, 6_400_000])
@pytest.mark.parametrize("per_sm", [1, 4])
def test_blocks_cover_every_marker_once(n, per_sm, kind, warps, k):
    """Block b's warp w takes per_warp markers from (b warps + w)
    per_warp: whole rounds of 32 markers(kind), every marker in one range,
    no block without markers, at most per_sm * 132 blocks over the k
    channels."""
    g, per_warp = hk.blocks(n, hk.markers(kind), warps, per_sm, 132, k)
    if n == 0:
        assert (g, per_warp) == (0, 0)
        return
    assert per_warp % (32 * hk.markers(kind)) == 0
    assert 1 <= g and g * k <= max(per_sm * 132, k)
    assert (g - 1) * warps * per_warp < n <= g * warps * per_warp


@pytest.mark.parametrize("itemsize, kind, nbins, form, copies, warps", [
    (4, hk.XV, 64 * 64, hk.WARPS, 6, 12), (8, hk.XV, 64 * 64, hk.WARPS, 3, 6),
    (4, hk.X, 192, hk.LANES, 8, 8), (4, hk.V, 128, hk.LANES, 8, 8),
    (4, hk.XV, 128 * 128, hk.WARPS, 1, 2), (4, hk.X, 32768, hk.BUFFER, 1, 1),
    (8, hk.X, 32768, hk.BUFFER, 1, 1), (8, hk.XV, 128 * 128, hk.BUFFER, 1, 1),
    (8, hk.X, 192, hk.LANES, 4, 4), (4, hk.V, 9 * 128, hk.WARPS, 8, 8),
    (4, hk.X, 1024, hk.WARPS, 8, 8), (8, hk.V, 128, hk.LANES, 7, 7)],
    ids=["d1", "d1-f64", "d3", "d2", "xv128", "x32768", "x32768-f64", "xv128-f64",
         "d3-f64", "d2-9species", "x1024", "d2-f64"])
def test_grid_copies_fit_one_block(itemsize, kind, nbins, form, copies, warps):
    """A block's grids (plan): 32 lane copies of nbins values a warp for the
    profile and the grid charge where at least LANE_WARPS_MIN warps' fit
    (D3 at nx 192, D2 at nv 128); else copies of 2 nbins values, for the
    x-v histogram each shared by SHARE warps with a claim table each (a
    byte a slot, the power of two from 16 that holds nbins, at most
    CLAIM_MAX), the most of 8 that fit one block's 232,448 bytes; else the
    device buffer, one warp a block, its claim table alone in shared
    memory."""
    p = hk.plan(itemsize, kind, nbins)
    claim = min(max(16, 1 << (nbins - 1).bit_length()), hk.CLAIM_MAX) if kind == hk.XV else 0
    share = hk.SHARE if kind == hk.XV else 1
    assert (p.form, p.copies, p.warps) == (form, copies, warps)
    assert p.smem <= hk.SMEM_MAX
    assert p.smem == {hk.LANES: copies * 32 * nbins * itemsize,
                      hk.WARPS: copies * (2 * nbins * itemsize + share * claim),
                      hk.BUFFER: claim}[form]


def _row_sum(rows):
    """hist_sum_kernel's order: row group g of SUM_GROUPS sums rows g,
    g + SUM_GROUPS, ... in order; the groups' sums are added in group
    order."""
    groups = []
    for g in range(hk.SUM_GROUPS):
        acc = np.zeros(rows.shape[1:], dtype=rows.dtype)
        for r in range(g, rows.shape[0], hk.SUM_GROUPS):
            acc = acc + rows[r]
        groups.append(acc)
    out = groups[0]
    for acc in groups[1:]:
        out = out + acc
    return out


@pytest.mark.parametrize("rows, values", [(528, 192), (37, 101), (0, 64)],
                         ids=["d3", "odd", "empty"])
def test_row_sum_order_sums_every_row_once(rows, values):
    """The row sum alone, at D3's 528 rows of nx 192 and at an odd count:
    integers sum exactly, so every row is taken once; random rows in f64
    within a few ulps of the exact sum."""
    rng = np.random.default_rng(rows)
    ints = rng.integers(-1000, 1000, (rows, values)).astype(np.float64)
    assert np.array_equal(_row_sum(ints), ints.sum(axis=0))
    real = rng.standard_normal((rows, values))
    exact = np.array([math.fsum(real[:, j]) for j in range(values)])
    scale = max(np.abs(real).sum(axis=0).max(), 1.0)
    assert np.abs(_row_sum(real) - exact).max() <= 8 * np.finfo(np.float64).eps * scale


def _order(n, m, warps, per_warp):
    """For markers 0..n-1 of one channel: (block, warp, lane, round, j) as
    the kernels walk them (block b's warp w takes per_warp markers from
    (b warps + w) per_warp; lane l takes m in a row each round of 32 m)."""
    i = np.arange(n)
    gw, rem = np.divmod(i, per_warp)
    rnd, rem = np.divmod(rem, 32 * m)
    lane, j = np.divmod(rem, m)
    return gw // warps, gw % warps, lane, rnd, j


def _mirror_lanes(kind, cells, left, right, nbins, nx, warps, blocks, per_warp):
    """The LANES form (profile, grid charge) in numpy: each lane adds its
    markers' left half at the cell and right half at the next one
    (periodic in x; the same species' next v point) in marker order; each
    cell of a warp sums its 32 lanes from lane q % 32 on, wrapping (q = w
    nbins + cell); the warps in order; then the row sum."""
    b, w, lane, _, _ = _order(cells.size, hk.markers(kind), warps, per_warp)
    ok = cells >= 0
    right_cells = (cells + 1) % nx if kind == hk.X else cells + 1
    grid = np.zeros((blocks, warps, nbins, 32))
    # left then right half of each marker, markers in order: the lanes' order
    idx = [np.stack([a[ok], a[ok]], axis=1).ravel() for a in (b, w)]
    cell = np.stack([cells[ok], right_cells[ok]], axis=1).ravel()
    ln = np.stack([lane[ok], lane[ok]], axis=1).ravel()
    np.add.at(grid, (idx[0], idx[1], cell, ln),
              np.stack([left[ok], right[ok]], axis=1).ravel())
    rows = np.zeros((blocks, nbins))
    for wi in range(warps):
        q = wi * nbins + np.arange(nbins)
        acc = grid[:, wi, np.arange(nbins), q % 32]
        for step in range(1, 32):
            acc = acc + grid[:, wi, np.arange(nbins), (q + step) % 32]
        rows = rows + acc
    return _row_sum(rows)


def _mirror_warps(cells, left, right, nbins, nx, warps, blocks, per_warp, share):
    """The WARPS form of the x-v histogram in numpy, for one channel: the
    `share` warps of a copy take a round's grid steps in member order; a
    step adds every lane's v row iv0, then every lane's row iv0 + 1, as a
    (left, right) pair at the cell; the block's tail adds, copy by copy,
    each left half and its left neighbour's right half (periodic in x);
    then the row sum.  (Lanes on one cell are summed by the lowest first;
    here they are added one by one: the same terms.)"""
    b, w, lane, rnd, j = _order(cells.shape[0], hk.markers(hk.XV), warps, per_warp)
    copy, member = np.divmod(w, share)
    ok = cells[:, 0] >= 0
    grid = np.zeros((blocks, warps // share, nbins, 2))
    order = np.lexsort((np.tile(lane, 2), np.repeat([0, 1], lane.size), np.tile(j, 2),
                        np.tile(member, 2), np.tile(rnd, 2), np.tile(copy, 2), np.tile(b, 2)))
    row_of = np.repeat([0, 1], lane.size)[order]
    m = np.tile(np.arange(lane.size), 2)[order]
    keep = ok[m]
    m, row_of = m[keep], row_of[keep]
    np.add.at(grid, (b[m], copy[m], cells[m, row_of], np.zeros_like(m)), left[m, row_of])
    np.add.at(grid, (b[m], copy[m], cells[m, row_of], np.ones_like(m)), right[m, row_of])
    o = np.arange(nbins)
    prev = np.where(o % nx == 0, o + nx - 1, o - 1)
    rows = np.zeros((blocks, nbins))
    for c in range(warps // share):
        rows = rows + grid[:, c, :, 0]
        rows = rows + grid[:, c, prev, 1]
    return _row_sum(rows)


def test_mirror_of_the_kernels_order_gives_the_plain_sums():
    """The design of csrc/hist_kernels.cu, mirrored with the kernels' own
    cells, weights and marker ranges against the plain versions at 1e-12:
    the grid charge and the profile in lane copies, the x-v histogram one
    channel a block in copies shared by SHARE warps."""
    x, v, p, w, live = _markers(N_ODD, 3, seed=9)
    s = (v + V_MAX) * ((NV - 1) / (2.0 * V_MAX))
    fv = s - np.floor(s)
    iv0 = np.clip(np.floor(s), 0, NV - 2).astype(np.int64)
    inside = np.abs(v) < V_MAX
    sx = x * (NX / LX)
    fx = sx - np.floor(sx)
    ix0 = np.clip(np.floor(sx), 0, NX - 1).astype(np.int64)
    # the grid charge (kX): every species in one flat run
    val = -np.where(live, w, 0.0)
    pl = hk.plan(8, hk.X, NX)
    g, per_warp = hk.blocks(x.size, hk.markers(hk.X), pl.warps, 1, 132)
    got = _mirror_lanes(hk.X, ix0.ravel(), ((1 - fx) * val).ravel(), (fx * val).ravel(), NX, NX,
                        pl.warps, g, per_warp)
    assert_rel(got, hk.grid_charge_plain(*_t(x, val), LX, NX), TOL, "grid charge")
    # the profile (kV): cell species * nv + iv0
    a = np.where(live & inside, np.abs(w), 0.0)
    cells = np.where(live & inside, np.arange(3)[:, None] * NV + iv0, -1)
    pl = hk.plan(8, hk.V, 3 * NV)
    g, per_warp = hk.blocks(x.size, hk.markers(hk.X), pl.warps, 1, 132)
    got = _mirror_lanes(hk.V, cells.ravel(), ((1 - fv) * a).ravel(), (fv * a).ravel(), 3 * NV,
                        NX, pl.warps, g, per_warp)
    assert_rel(got.reshape(3, NV), hk.profile_plain(*_t(v, w, live), V_MAX, NV), TOL, "profile")
    # the x-v histogram (kXV): two v rows a marker, cells iv0 nx + ix0 and one row up
    vals = _vals(p[0], w[0], live[0])
    pl = hk.plan(8, hk.XV, NV * NX)
    g, per_warp = hk.blocks(x.shape[1], hk.markers(hk.XV), pl.warps, 1, 132, 3)
    want = hk.hist_xv_plain(*_t(x[0], v[0], vals), LX, V_MAX, NX, NV)
    row0 = np.where(inside[0], iv0[0] * NX + ix0[0], -1)
    cells = np.stack([row0, np.where(row0 >= 0, row0 + NX, -1)], axis=1)
    wv = np.stack([1 - fv[0], fv[0]], axis=1)
    for c in range(3):
        left, right = wv * ((1 - fx[0]) * vals[c])[:, None], wv * (fx[0] * vals[c])[:, None]
        got = _mirror_warps(cells, left, right, NV * NX, NX, pl.warps, g, per_warp,
                            pl.warps // pl.copies)
        assert_rel(got.reshape(NV, NX), want[c], TOL, f"x-v channel {c}")


def _mirror_moments(v, val, counts, warps, blocks, per_warp, dtype):
    """The x-v histogram's moment of one channel in numpy at dtype, in the
    kernel's order: each lane sums v^2 val of its counted markers a round
    at a time, the round's M over a fixed tree (j adds j + d for d = 1, 2,
    4, ...), the rounds in order; the warp's 32 lane sums over a fixed tree
    (lane l adds lane l + d for d = 16, 8, 4, 2, 1); the block's warps in
    warp order from warp 0's; then the row sum of the blocks'."""
    m = hk.markers(hk.XV)
    v, val = v.astype(dtype), val.astype(dtype)
    term = np.where(counts, (v * v) * val, dtype(0))
    b, w, lane, rnd, j = _order(v.size, m, warps, per_warp)
    # each lane's terms by round and position in the round (0 past the end)
    slots = np.zeros((blocks, warps, 32, per_warp // (32 * m), m), dtype=dtype)
    slots[b, w, lane, rnd, j] = term
    d = 1
    while d < m:
        slots[..., 0:m:2 * d] = slots[..., 0:m:2 * d] + slots[..., d:m:2 * d]
        d *= 2
    acc = np.zeros((blocks, warps, 32), dtype=dtype)
    for r in range(slots.shape[3]):
        acc = acc + slots[:, :, :, r, 0]
    d = 16
    while d:
        acc[..., :d] = acc[..., :d] + acc[..., d:2 * d]
        d //= 2
    block = acc[:, 0, 0]
    for wi in range(1, warps):
        block = block + acc[:, wi, 0]
    return _row_sum(block[:, None])[0], term


def _state(x, v, p, w, live, dtype, p_dtype=None):
    t = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    z = torch.zeros(NX, dtype=dtype)
    return SimState(x=t(x), v=t(v), p=t(p, p_dtype or dtype), w=t(w), live=t(live, torch.bool),
                    rho=z, electric=z.clone(), mode_re=torch.zeros(1, dtype=dtype),
                    mode_im=torch.zeros(1, dtype=dtype))


@pytest.mark.parametrize("dtype, n, nv, nx", [
    (np.float32, N_ODD, NV, NX), (np.float64, N_ODD, NV, NX),
    (np.float32, 4099, 128, 128), (np.float64, 4099, 128, 128)],
    ids=["f32", "f64", "f32-xv128", "f64-buffer"])
def test_mirror_of_the_moment_order_gives_the_energies(dtype, n, nv, nx):
    """The moments of csrc/hist_kernels.cu's x-v pass, mirrored in the
    kernel's order (lane, warp tree, warps, row groups) at the card's
    plan, against diagnostics.energies' three raw sums (nonlinear delta-f:
    sum_live v^2, v^2 p, v^2 w) within the rounding of the longest chain of
    adds, on a state with dead markers and markers at and past +-v_max:
    those count in the energies and not in the histograms, and dead
    markers in neither."""
    x, v, p, w, live = _markers(n, 1, seed=21)
    v[0, 6:40] = np.linspace(1.0, 1.3, 34) * V_MAX * np.where(np.arange(34) % 2, 1.0, -1.0)
    fast = np.abs(v[0]) >= V_MAX
    assert (fast & live[0]).sum() > 10 and (~live[0]).sum() > 100
    cfg = tcfg_mod.bump_on_tail_default(nx=NX, nx_opd=nx, nv_opd=nv, v_max=V_MAX, lx=LX,
                                        nparticle_max=n, verbosity=0,
                                        dtype=np.dtype(dtype).name)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    sp = tdist.SpeciesParams.from_config(cfg, tdt, "cpu")
    st = _state(x, v, p, w, live, tdt)
    eng = tdiag.energies(cfg, sp, st)
    pl = hk.plan(np.dtype(dtype).itemsize, hk.XV, nv * nx)
    g, per_warp = hk.blocks(n, hk.markers(hk.XV), pl.warps, 1, 132, 3)
    vals = hk.xv_channels(st.live[0], st.p[0], st.w[0], tdt).numpy()
    eps = np.finfo(dtype).eps
    chain = per_warp // (32 * hk.markers(hk.XV)) + 3 + 5 + pl.warps + g // hk.SUM_GROUPS \
        + hk.SUM_GROUPS
    for c, want in enumerate((eng.marker, eng.total, eng.pertb)):
        got, term = _mirror_moments(st.v[0].numpy(), vals[c], live[0], pl.warps, g, per_warp,
                                    dtype)
        scale = np.abs(term).astype(np.float64).sum()
        assert abs(float(got) - float(want[0])) <= 2 * chain * eps * scale, c
        # the fast markers count: the sum without them is smaller by their terms
        without, _ = _mirror_moments(st.v[0].numpy(), vals[c], live[0] & ~fast, pl.warps, g,
                                     per_warp, dtype)
        extra = math.fsum(term[fast].astype(np.float64))
        assert abs(extra) > 100 * chain * eps * scale
        assert abs(float(got) - float(without) - extra) <= 4 * chain * eps * scale, c
    # not in the histograms: they equal the histograms without the fast markers
    hist, moments = hk.xv_pass_plain(st.x[0], st.v[0], st.live[0], st.p[0], st.w[0], LX, V_MAX,
                                     nx, nv)
    keep = torch.from_numpy(~fast)
    slow, _ = hk.xv_pass_plain(*(t[0][keep] for t in (st.x, st.v, st.live, st.p, st.w)), LX,
                               V_MAX, nx, nv)
    assert torch.equal(hist, slow)
    # dead markers in neither: their v, p and w moved, nothing changes
    dead = ~st.live[0]
    moved = [t[0].clone() for t in (st.v, st.p, st.w)]
    for t in moved:
        t[dead] = 3.0
    hist2, moments2 = hk.xv_pass_plain(st.x[0], moved[0], st.live[0], moved[1], moved[2], LX,
                                       V_MAX, nx, nv)
    assert torch.equal(hist, hist2) and torch.equal(moments, moments2)


MARKER_PASS_CASES = {
    "deltaf": dict(),
    "linear": dict(linear=True),
    "fullf_three": dict(deltaf=False, species=3),
    "bf16_weights": dict(bf16_weights=True),
}


@pytest.mark.parametrize("case", sorted(MARKER_PASS_CASES))
def test_marker_pass_is_energies_and_ptcldist(case):
    """diagnostics.marker_pass (the CUDA snapshot's path, here on
    xv_pass_plain) against energies and ptcldist (the plain path): the six
    histograms bit for bit, the energies within rounding of their terms,
    in every branch of the derived quantities."""
    kw = dict(MARKER_PASS_CASES[case])
    ns = kw.pop("species", 1)
    dtype = "float32" if kw.get("bf16_weights") else "float64"
    cfg = tcfg_mod.bump_on_tail_default(nx=32, nx_opd=16, nv_opd=16, nparticle_max=8192,
                                        verbosity=0, dtype=dtype, **kw)
    if ns > 1:
        sp = [tcfg_mod.SpeciesConfig(charge=-1.0, mass=1.0 + s, temperature=1.0, density=1.0 / ns,
                                     v0=0.0, nparticle_init=8192 - 500 * s) for s in range(ns)]
        cfg = dataclasses.replace(cfg, species=tuple(sp)).validate()
    st = load_particles(cfg, "cpu")
    st.v[:, :20] = 1.1 * cfg.v_max
    tsp = tdist.SpeciesParams.from_config(cfg, st.x.dtype, "cpu")
    eng, ptcl = tdiag.marker_pass(cfg, tsp, st)
    for name, a, b in zip(tdiag.PtclDist._fields, ptcl, tdiag.ptcldist(cfg, tsp, st)):
        assert torch.equal(a, b), name
    v2 = torch.where(st.live, st.v * st.v, 0.0).double()
    scale = (v2 * (1.0 + st.p.double().abs() + st.w.double().abs())).sum(dim=1)
    eps = torch.finfo(st.x.dtype).eps
    for name, a, b in zip(tdiag.Energies._fields, eng, tdiag.energies(cfg, tsp, st)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert float((a.double() - b.double()).abs().max()) <= 64 * eps * float(scale.max()), name


def test_source_has_no_float_atomic_and_no_torch_header():
    csrc = REPO / "pic1dp_tpu_torch" / "csrc"
    src = (csrc / f"{hk.SOURCE}.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    # the hat's floor_t comes from the substep kernels' header; the warp step
    # is the deposit's own (deposit_cell), not the substep kernels' deposit_lanes
    assert re.findall(r'#include "([^"]+)"', code) == ["substep_math.cuh"]
    header = re.sub(r"//[^\n]*", "", (csrc / "substep_math.cuh").read_text())
    assert "deposit_lanes" in header and "deposit_lanes" not in code
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
