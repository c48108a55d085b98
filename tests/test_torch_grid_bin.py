"""The substep kernels' grid bin (more than 4 kept modes) against the TPU kernel.

Above 4 kept modes the CUDA kernels (csrc/substep_kernels.cu, the grid bin)
gather E as the hat lerp of E on the nx cells and deposit onto a charge grid
that each block projects onto the modes.  The TPU kernel folds the hat into
each mode per marker (pallas_kernels._trig_block); the fold is linear in
the table entries, so both compute one function.  The kernels run only on
the card (chip_smoke.py holds them to their plain versions there); here the
numpy model of their arithmetic (tests/test_torch_substep.py::_kernel_model,
its grid form) is held against JAX FusedStepper(cfg, interpret=True) on the
same arrays, in float64 at 1e-12 of each field's max: at 5, 16, 33 and 64
kept modes in both nonlinear delta-f layouts, on markers exactly on cell
edges and just below lx (the last cell, whose right neighbour is cell 0),
and at nx 4096.  Then the wrapper's shared-memory rule (grid_smem) and the
device buffer it hands the kernels where the grids do not fit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import GRID_CASES, WIDE_CASES, assert_rel, host, to_port
from test_torch_substep import _kernel_model

import pic1dp_tpu.config as jcfg_mod
from pic1dp_tpu.core.loading import load_particles as jax_load
from pic1dp_tpu.core.step import Stepper as JaxStepper
from pic1dp_tpu.ops.pallas_kernels import FusedStepper
from pic1dp_tpu.ops.spectral import solve_modes_from_projections
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.ops import substep_kernels as sk

CASES = {**GRID_CASES, "bot_33_modes": WIDE_CASES["bot_33_modes"]}
SMEM_PER_BLOCK = 232448            # a Hopper block's shared memory with an opt-in


def _configs(name, **change):
    return [dataclasses.replace(CASES[name](m, "float64"), **change)
            for m in (jcfg_mod, tcfg_mod)]


def _substeps(tcfg, stream_v1):
    return sk.FusedSubsteps(tcfg, tdist.SpeciesParams.from_config(tcfg, torch.float64, "cpu"),
                            stream_v1=stream_v1)


def _against_pallas(jcfg, tcfg, x, v, p, w, mode_re, mode_im, label, layouts=(True, False)):
    """Both substeps of the kernel model (grid form) against the interpret
    kernel, in the nonlinear delta-f layouts `layouts` (stream_v1 values),
    on numpy (1, n) arrays; substep 2 from the JAX midpoint streams and
    modes."""
    grad_inv = JaxStepper(jcfg).spectral.grad_inv
    for stream_v1 in layouts:
        fused = FusedStepper(jcfg, interpret=True, stream_v1=stream_v1)
        subs = _substeps(tcfg, stream_v1)
        assert subs.uses_grid_bin()
        j = [jnp.asarray(a) for a in (x, v, p, w, mode_re, mode_im)]
        jw1, jv1, jproj1 = fused.substep1(*j)
        mw1, mv1, mproj1 = _kernel_model(subs, x, v, p, w, (mode_re, mode_im), substep=1)
        tag = f"{label} {subs.layout}"
        assert (mv1 is None) == (jv1 is None) == (subs.layout != sk.NONLINEAR)
        assert (mw1 is None) == (subs.layout == sk.RECOMPUTE)
        if mw1 is not None:
            assert_rel(mw1, jw1, 1e-12, f"{tag} w1")
        if mv1 is not None:
            assert_rel(mv1, jv1, 1e-12, f"{tag} v1")
        for k, (got, want) in enumerate(zip(mproj1, jproj1)):
            assert_rel(got, want, 1e-12, f"{tag} proj1[{k}]")
        mre1, mim1 = solve_modes_from_projections(*jproj1, grad_inv, jcfg.lx)
        jx2, jv2, jw2, jproj2 = fused.substep2(*j[:4], jw1, *j[4:], mre1, mim1, v1=jv1)
        mx2, mv2, mw2, mproj2 = _kernel_model(
            subs, x, v, p, w, (np.asarray(mre1), np.asarray(mim1), mode_re, mode_im),
            substep=2, w1=np.asarray(jw1), v1=None if jv1 is None else np.asarray(jv1))
        for f, got, want in (("x2", mx2, jx2), ("v2", mv2, jv2), ("w2", mw2, jw2)):
            assert_rel(got, want, 1e-12, f"{tag} {f}")
        assert_rel(np.stack(mproj2), np.stack([np.asarray(a) for a in jproj2]), 1e-12,
                   f"{tag} proj2")


# the nonlinear delta-f layouts (stream_v1) each case runs: both at 5 and
# 16 modes; the interpret kernel's cost grows with the modes, so 33 modes
# rebuild v1 and 64 stream it (tests/test_torch_substep.py runs the model
# in both layouts at every count against the plain version)
LAYOUTS = {"bot_5_modes": (True, False), "bot_16_modes": (True, False),
           "bot_33_modes": (False,), "bot_64_modes": (True,)}


@pytest.mark.parametrize("name", list(CASES))
def test_grid_form_matches_pallas_interpret(name):
    """E as the lerp of E on the grid, and the deposit projected from the
    charge grid, equal the TPU kernel's per-mode hat fold."""
    jcfg, tcfg = _configs(name)
    js = JaxStepper(jcfg).initial_field(jax_load(jcfg, jax.random.PRNGKey(11)))
    ts = to_port(js)
    _against_pallas(jcfg, tcfg, *(host(getattr(ts, k)) for k in (
        "x", "v", "p", "w", "mode_re", "mode_im")), name, LAYOUTS[name])


def _edge_markers(cfg, n, rng):
    """x for n markers: the left edges of up to n / 2 cells spread over the
    grid exactly (x nx / lx an integer in float64, so f = 0), the largest
    floats below lx, markers in the last cell, and uniform draws; v 0 on
    the edges (so substep 1 deposits there too) and drawn elsewhere."""
    nx_over_lx = cfg.nx / cfg.lx
    edges = []
    for j in range(0, cfg.nx, max(1, 2 * cfg.nx // n)):
        xj = j / nx_over_lx
        while xj * nx_over_lx < j:
            xj = np.nextafter(xj, np.inf)
        while xj * nx_over_lx > j:
            xj = np.nextafter(xj, -np.inf)
        if xj * nx_over_lx == j:
            edges.append(xj)
    below = [cfg.lx]
    for _ in range(8):
        below.append(np.nextafter(below[-1], 0.0))
    last = cfg.lx * (1.0 - rng.uniform(0.0, 1.0, 32) / cfg.nx)
    x = np.concatenate([edges, below[1:], last])
    x = np.concatenate([x, rng.uniform(0.0, cfg.lx, n - x.size)])[None, :]
    v = rng.normal(0.0, 2.0, (1, n))
    v[0, :len(edges)] = 0.0
    return x, v, len(edges)


@pytest.mark.parametrize("nx", [64, 4096])
def test_grid_form_at_cell_edges_and_below_lx(nx):
    """Markers with f = 0 exactly, at the largest floats below lx and in the
    last cell (whose right neighbour is cell 0), 16 kept modes, v1 rebuilt
    (substep 2 gathers at x0 and x1); at nx 64 and at nx 4096 (most cells
    empty)."""
    jcfg, tcfg = _configs("bot_16_modes", nx=nx)
    rng = np.random.default_rng(3)
    n = 1024
    x, v, n_edges = _edge_markers(tcfg, n, rng)
    assert n_edges >= min(nx, n // 2) // 2
    s = x * (nx / tcfg.lx)
    assert np.any(s == np.floor(s)) and np.any(np.floor(s) == nx - 1)
    p = rng.uniform(0.5, 1.5, (1, n)) / n
    w = rng.normal(0.0, 1e-3, (1, n)) / n
    mode_re, mode_im = rng.uniform(-0.05, 0.05, (2, tcfg.nmode))
    _against_pallas(jcfg, tcfg, x, v, p, w, mode_re, mode_im, f"edges nx {nx}", (False,))


def test_grid_form_with_few_markers_on_a_wide_grid():
    """A few hundred markers on nx 4096 (most cells empty), 64 kept modes:
    the model against the plain version, which the other tests hold to the
    TPU kernel."""
    _, tcfg = _configs("bot_64_modes", nx=4096, nparticle_max=384)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, tcfg.lx, (1, 384))
    v, w = rng.normal(0.0, 2.0, (1, 384)), rng.normal(0.0, 1e-3, (1, 384))
    p = rng.uniform(0.5, 1.5, (1, 384))
    modes = rng.uniform(-0.05, 0.05, (4, tcfg.nmode))
    t = [torch.from_numpy(a) for a in (x, v, p, w)]
    for stream_v1 in (True, False):
        subs = _substeps(tcfg, stream_v1)
        w1, v1, proj1 = subs.substep1_plain(*t, *map(torch.from_numpy, modes[:2]))
        mw1, mv1, mproj1 = _kernel_model(subs, x, v, p, w, tuple(modes[:2]), substep=1)
        assert (mw1 is None) == (w1 is None) == (subs.layout == sk.RECOMPUTE)
        if w1 is not None:
            assert_rel(mw1, w1, 1e-12, "w1")
        assert_rel(np.stack(mproj1), torch.stack(proj1), 1e-12, "proj1")
        streams = [a.clone() for a in t]
        x2, v2, w2, proj2 = subs.substep2_plain(
            streams[0], streams[1], streams[2], streams[3], w1, v1,
            *map(torch.from_numpy, modes[2:]), *map(torch.from_numpy, modes[:2]))
        mx2, mv2, mw2, mproj2 = _kernel_model(
            subs, x, v, p, w, (modes[2], modes[3], modes[0], modes[1]), substep=2,
            w1=None if w1 is None else host(w1), v1=None if v1 is None else host(v1))
        for f, got, want in (("x2", mx2, x2), ("v2", mv2, v2), ("w2", mw2, w2)):
            assert_rel(got, want, 1e-12, f)
        assert_rel(np.stack(mproj2), torch.stack(proj2), 1e-12, "proj2")


def _boundaries(itemsize, egrids):
    """The nx at which a count of rho grids stops fitting, and its
    neighbours."""
    per = sk.GRID_SMEM_MAX // itemsize
    out = set()
    for c in (8, 4, 2, 1):
        top = (per - egrids) // (egrids + 2 * c)
        out.update((top - 1, top, top + 1))
    return sorted(out)


@pytest.mark.parametrize("egrids", [1, 2])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_grid_smem_keeps_a_grid_per_warp_where_eight_fit(itemsize, egrids):
    """grid_smem is a pure function of its arguments, never above a block's
    232,448 bytes, keeps one charge grid per warp (8) exactly where 8 fit and
    otherwise the most of 4, 2, 1 that fit, and gives 0 bytes (the device
    buffer) exactly where not even one fits."""
    assert sk.GRID_SMEM_MAX <= SMEM_PER_BLOCK and sk.GRID_COPIES == sk.THREADS // 32 == 8
    for nx in [*range(1, 200), 1024, 4096, 2**16, *_boundaries(itemsize, egrids)]:
        nbytes, copies = sk.grid_smem(nx, itemsize, egrids)
        assert (nbytes, copies) == sk.grid_smem(nx, itemsize, egrids)

        def need(c, nx=nx):
            return (egrids * (nx + 1) + c * 2 * nx) * itemsize

        assert nbytes <= sk.GRID_SMEM_MAX
        assert (copies == 8) == (need(8) <= sk.GRID_SMEM_MAX)
        if nbytes:
            assert nbytes == need(copies) and copies in (1, 2, 4, 8)
            assert copies == 8 or need(2 * copies) > sk.GRID_SMEM_MAX
        else:
            assert copies == 1 and need(1) > sk.GRID_SMEM_MAX


def test_mode_bins_and_the_grid_buffer():
    """1 and 2-4 kept modes take the register bins, more the grid bin (or
    any count with grid_bin set); the device buffer is made only for a
    grid bin whose grids do not fit in shared memory, with egrids (nx + 1)
    + 2 nx values per block; and the grid bin's grid."""
    assert [sk.mode_bin(m) for m in (1, 2, 4, 5, 16, 64)] == [1, 4, 4, 0, 0, 0]
    with pytest.raises(ValueError):
        sk.mode_bin(0)
    x = torch.zeros((1, 1024), dtype=torch.float32)
    for modes, nx, substep, stream_v1, want in (
            ((1,), 192, 1, True, None), (tuple(range(1, 17)), 192, 2, False, None),
            (tuple(range(1, 6)), 32768, 1, True, 32768 + 1 + 2 * 32768),
            (tuple(range(1, 6)), 32768, 2, False, 2 * (32768 + 1) + 2 * 32768),
            (tuple(range(1, 6)), 32768, 2, True, 2 * (32768 + 1) + 2 * 32768)):
        cfg = dataclasses.replace(
            tcfg_mod.bump_on_tail_default(nx=nx, nparticle_max=1024, verbosity=0),
            modes=modes)
        subs = sk.FusedSubsteps(cfg, tdist.SpeciesParams.from_config(cfg, torch.float32, "cpu"),
                                stream_v1=stream_v1)
        buf = subs._grids(x, 7, substep)
        assert (buf is None) == (want is None)
        if buf is not None:
            assert tuple(buf.shape) == (7, want) and buf.dtype == torch.float32
    one = dataclasses.replace(cfg, modes=(1,))
    forced = sk.FusedSubsteps(one, tdist.SpeciesParams.from_config(one, torch.float32, "cpu"))
    assert not forced.uses_grid_bin() and forced._grids(x, 7, 1) is None
    forced.grid_bin = True
    assert forced.uses_grid_bin() and tuple(forced._grids(x, 7, 1).shape) == (7, 3 * 32768 + 1)
    # one grid per shape and substep, the same in both nonlinear layouts
    # (the same bits): the grid bin holds as many blocks per SM as fit
    sms = 132
    for nx, itemsize, want in ((192, 4, 4), (1024, 4, 3), (1024, 8, 1), (32768, 4, 4)):
        c = dataclasses.replace(cfg, nx=nx, modes=tuple(range(1, 17)),
                                dtype="float32" if itemsize == 4 else "float64")
        grids = set()
        for stream_v1 in (True, False):
            s = sk.FusedSubsteps(c, tdist.SpeciesParams.from_config(
                c, getattr(torch, c.dtype), "cpu"), stream_v1=stream_v1)
            grids.add(s.grid_size(2**26, sms, itemsize, 2))
        assert grids == {want * sms}
        assert sk.grid_blocks_per_sm(nx, itemsize, 2) == want
