"""Marker optimization: merge, remove, split (port of
pic1dp_tpu/core/optimize.py).

Reference: src/pic1dp_particle.F90 — particle_merge (:411-522),
particle_remove (:530-627), particle_split (:635-746), orchestrated by
particle_optimize (:752-813).  All three are driven by the |delta f|(v)
profile from particle_compute_dist_pertb_abs_v (:356-403) and are delta-f
only (:762).

The reference's algorithms are sequential (streaming bins, backfilling holes,
decrementing live counts).  As in the JAX package each is a masked,
sort-based batch transform over the fixed-capacity particle arrays:

  * merge: eligible particles are keyed by (ix, iv, sign w) and sorted; equal
    keys are paired positionally, each pair collapses into its first member
    (|w|-weighted x, v; summed p, w — reference :485-507) and the second dies.
  * remove: a per-particle dice decides removal; survivors rescale p, w
    (reference :594-614).
  * split: eligible (resonant) particles spawn 2*ngroup children with
    velocities v +/- N(0,1)*(2 v_max / nv)*dv_sig_frac and weights divided by
    2*ngroup (reference :697-728); children fill dead slots assigned by rank,
    capacity-guarded like the reference (:655-675).

These are plain torch ops on the state's device (stable sort, cummax,
indexing), one species after another; they run at a handful of scheduled
steps of a run, not in the hot loop.  The random numbers are arguments: the
dice of remove, uniform in [0, 1) and shaped (ns, n), and the standard
normals of split, shaped (ns, n, split_ngroup).  `draw_randoms` takes them
from a torch.Generator on the state's device; the tests hand both packages
the same numbers instead.  Every function returns new tensors and leaves its
input state untouched.

When the particle axis is split over ranks (parallel/mesh.py), `reduce`
sums each rank's profile over the ranks (the reference's MPI_Allreduce,
src/pic1dp_particle.F90:392-395); merge pairs and split slots stay within a
rank's block, like the reference's per-rank bins.

Eligibility compares the profile at a marker with a fraction of the
profile's maximum.  On CUDA the profile is the HIST_V kernel of
ops/hist_kernels.py, whose sums run in an order the code fixes, so its bits,
and with them the fate of a marker that sits on the threshold to within
rounding, repeat from run to run; the CPU's index_add_ sums in another
order, so such a marker may fall on the other side there.
"""

from __future__ import annotations

import dataclasses

import torch

from pic1dp_tpu_torch.config import Config
from pic1dp_tpu_torch.core.diagnostics import Reduce, dist_pertb_abs_v, unreduced
from pic1dp_tpu_torch.core.state import SimState
from pic1dp_tpu_torch.ops.interp import hat_v_clipped


def _df_at_particles(profile_s: torch.Tensor, v: torch.Tensor, v_max: float, nv: int):
    """Interpolate one species' |delta f|(v) profile to particle velocities
    with boundary clamping (reference :452-466)."""
    iv0, iv1, w0, w1 = hat_v_clipped(v, v_max, nv)
    return w0 * profile_s[iv0] + w1 * profile_s[iv1]


def _profile(cfg: Config, state: SimState, reduce: Reduce = unreduced) -> torch.Tensor:
    """|delta f|(v) profile of every species, (ns, nv), summed over ranks."""
    return reduce(dist_pertb_abs_v(state.v, state.w, state.live, cfg.v_max, cfg.nv))[0]


def _per_species(fn, state: SimState, reads: str, writes: str, *per_species_args) -> SimState:
    """Apply fn to each species' row of the fields `reads` ("xvpwl" letters;
    l is live) and of the extra per-species arguments; fn returns the new
    rows of the fields `writes`.  The result is a state with those fields
    replaced."""
    names = dict(x="x", v="v", p="p", w="w", l="live")
    rows = [fn(*(getattr(state, names[f])[s] for f in reads),
               *(a[s] for a in per_species_args))
            for s in range(state.x.shape[0])]
    new = {names[f]: torch.stack([r[i] for r in rows]) for i, f in enumerate(writes)}
    return dataclasses.replace(state, **new)


def merge_particles(cfg: Config, state: SimState, thsh: float,
                    reduce: Reduce = unreduced) -> SimState:
    """Merge pairs of non-important particles (reference :411-522)."""
    n = state.x.shape[1]
    nbins = 2 * cfg.nv * cfg.nx
    idx = torch.arange(n, device=state.x.device)
    false = torch.zeros(1, dtype=torch.bool, device=state.x.device)

    def per_species(x, v, p, w, live, prof):
        df = _df_at_particles(prof, v, cfg.v_max, cfg.nv)
        elig = live & (df < torch.max(prof) * thsh)

        ix = torch.floor(x * (cfg.nx / cfg.lx)).long().clamp(0, cfg.nx - 1)
        sv = (v + cfg.v_max) * ((cfg.nv - 1) / (2.0 * cfg.v_max))
        iv = torch.floor(sv).long().clamp(0, cfg.nv - 1)
        iw = (w > 0.0).long()
        binid = (iw * cfg.nv + iv) * cfg.nx + ix
        key = torch.where(elig, binid, nbins)  # ineligible sorts to the end

        ksort, order = torch.sort(key, stable=True)
        same = ksort[1:] == ksort[:-1]
        same_prev, same_next = torch.cat([false, same]), torch.cat([same, false])
        # position within each equal-key run: the index less the index at
        # which the run began (a running maximum over the run starts)
        runpos = idx - torch.cummax(torch.where(same_prev, -1, idx), dim=0).values
        is_first = (runpos % 2 == 0) & same_next & (ksort < nbins)
        is_second = (runpos % 2 == 1) & (ksort < nbins)

        i1 = order                        # sorted -> original index
        i2 = torch.roll(order, -1)        # partner (valid where is_first)
        wa, wb = w[i1], w[i2]
        # same-sign bins make wa + wb == 0 only when both are exactly 0
        # (possible at t=0 with zero seed amplitude); keep those unmerged-safe
        denom = torch.where(wa + wb != 0.0, wa + wb, 1.0)
        x_m = (wa * x[i1] + wb * x[i2]) / denom
        v_m = (wa * v[i1] + wb * v[i2]) / denom

        # i1 is a permutation: each assignment below writes every slot once
        out = [torch.empty_like(t) for t in (x, v, p, w, live)]
        out[0][i1] = torch.where(is_first, x_m, x[i1])
        out[1][i1] = torch.where(is_first, v_m, v[i1])
        out[2][i1] = torch.where(is_first, p[i1] + p[i2], p[i1])
        out[3][i1] = torch.where(is_first, wa + wb, wa)
        out[4][i1] = live[i1] & ~is_second
        return out

    return _per_species(per_species, state, "xvpwl", "xvpwl", _profile(cfg, state, reduce))


def remove_particles(cfg: Config, state: SimState, dice: torch.Tensor,
                     thsh: float, reduce: Reduce = unreduced) -> SimState:
    """Remove unimportant particles, rescaling survivors (reference
    :530-627).  dice: uniform in [0, 1), (ns, n)."""
    opt = cfg.optimization

    def per_species(v, p, w, live, prof, dice_s):
        df = _df_at_particles(prof, v, cfg.v_max, cfg.nv)
        mx = torch.max(prof)
        # identically-zero |delta f| profile (e.g. zero seed amplitude):
        # importance sampling is undefined — make remove a no-op instead of
        # the 0/0 NaN cascade
        df_norm = df / torch.where(mx > 0.0, mx, 1.0)
        if opt.typeremove == 1:
            elig = live & (df < mx * thsh)
            removed = elig & (dice_s < opt.remove_frac)
            keep_scale = torch.where(elig & ~removed, 1.0 / (1.0 - opt.remove_frac), 1.0)
        else:
            elig = live & (mx > 0.0)
            removed = elig & (dice_s > df_norm)
            keep = elig & ~removed
            keep_scale = torch.where(
                keep, 1.0 / torch.where(keep & (df_norm > 0.0), df_norm, 1.0), 1.0)
        return p * keep_scale, w * keep_scale, live & ~removed

    return _per_species(per_species, state, "vpwl", "pwl", _profile(cfg, state, reduce),
                        dice)


def split_particles(cfg: Config, state: SimState, normals: torch.Tensor,
                    thsh: float, reduce: Reduce = unreduced) -> SimState:
    """Split resonant particles into 2*ngroup children (reference :635-746).
    normals: standard normal, (ns, n, split_ngroup)."""
    g = cfg.optimization.split_ngroup
    dv_sig = 2.0 * cfg.v_max / cfg.nv * cfg.optimization.split_dv_sig_frac
    n = state.x.shape[1]
    idx = torch.arange(n, device=state.x.device)
    per_parent = 2 * g - 1                         # new slots per parent

    def per_species(x, v, p, w, live, prof, gr):
        gr = gr * dv_sig                               # (n, g)
        df = _df_at_particles(prof, v, cfg.v_max, cfg.nv)
        elig = live & (df > torch.max(prof) * thsh)

        nfree = torch.sum(~live)
        rank = torch.cumsum(elig, dim=0) - 1           # split order by index
        do_split = elig & ((rank + 1) * per_parent <= nfree)
        # j-th dead slot index, in index order
        dead_order = torch.argsort(torch.where(live, n + idx, idx), stable=True)

        p_child = p / (2.0 * g)
        w_child = w / (2.0 * g) if cfg.deltaf else w
        x_new, v_new, p_new, w_new, live_new = (t.clone() for t in (x, v, p, w, live))
        # the 2g-1 sibling children go into dead slots; sibling j holds
        # v + gr[j//2] (j even) or v - gr[j//2] (j odd), matching the
        # reference's slot order +g1, -g1, ..., +g_{g-1}, -g_{g-1}, +g_g
        # (reference :706-728).  Parents that split have distinct ranks, so
        # no slot is written twice.
        base = rank[do_split] * per_parent
        for j in range(per_parent):
            slot = dead_order[base + j]
            dv = gr[:, j // 2][do_split]
            x_new[slot] = x[do_split]
            v_new[slot] = v[do_split] + dv if j % 2 == 0 else v[do_split] - dv
            p_new[slot] = p_child[do_split]
            w_new[slot] = w_child[do_split]
            live_new[slot] = True
        # parent slot becomes the last 'minus' child, -g_g (reference :716-724)
        v_new = torch.where(do_split, v - gr[:, g - 1], v_new)
        p_new = torch.where(do_split, p_child, p_new)
        if cfg.deltaf:
            w_new = torch.where(do_split, w_child, w_new)
        return x_new, v_new, p_new, w_new, live_new

    return _per_species(per_species, state, "xvpwl", "xvpwl", _profile(cfg, state, reduce),
                        normals)


def draw_randoms(cfg: Config, state: SimState, generator: torch.Generator,
                 remove: bool = True, split: bool = True):
    """(dice, normals) for one optimization step from `generator`, which
    lies on the state's device; None for the one an operation that is not
    due would have taken."""
    ns, n = state.x.shape
    kw = dict(generator=generator, dtype=state.x.dtype, device=state.x.device)
    dice = torch.rand((ns, n), **kw) if remove else None
    normals = torch.randn((ns, n, cfg.optimization.split_ngroup), **kw) if split else None
    return dice, normals


def apply_optimizations(cfg: Config, state: SimState, dice: torch.Tensor | None,
                        normals: torch.Tensor | None, merge: float | None = None,
                        remove: float | None = None,
                        split: float | None = None, reduce: Reduce = unreduced) -> SimState:
    """Run scheduled optimizations in the reference's order: merge, remove,
    split — recomputing the |delta f|(v) profile before each (reference
    particle_optimize, src/pic1dp_particle.F90:766-809).  The threshold
    arguments are fractions of max |delta f|(v); None disables the op.
    remove takes `dice` and split takes `normals` (see draw_randoms); `reduce`
    sums the profile over ranks (module docstring)."""
    # p may be stored reduced-precision (cfg.bf16_weights); the rare
    # optimization arithmetic (pair merges, survivor rescales) runs at full
    # precision and re-quantizes once at the end.  All particle dtypes are
    # restored on exit: random numbers of another dtype must not leak into
    # the state the step kernels take.
    in_dtypes = {f: getattr(state, f).dtype for f in ("x", "v", "p", "w")}
    if in_dtypes["p"] != in_dtypes["w"]:
        state = dataclasses.replace(state, p=state.p.to(in_dtypes["w"]))
    if merge is not None:
        state = merge_particles(cfg, state, merge, reduce)
    if remove is not None:
        state = remove_particles(cfg, state, dice, remove, reduce)
    if split is not None:
        state = split_particles(cfg, state, normals, split, reduce)
    # Re-establish the dead-slot invariant p = w = 0 (core/state.py): merge/
    # remove flip live bits without clearing the arrays.
    return dataclasses.replace(
        state, x=state.x.to(in_dtypes["x"]), v=state.v.to(in_dtypes["v"]),
        p=torch.where(state.live, state.p, 0.0).to(in_dtypes["p"]),
        w=torch.where(state.live, state.w, 0.0).to(in_dtypes["w"]))
