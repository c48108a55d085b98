"""The compute-unit and carry probe kernels' plain versions
(ops/stream_probes.py) against the JAX package and against numpy
transcriptions of the TPU probes, and the three probe entry points on the
CPU.  The CUDA kernels run only on the card (chip_smoke.py holds them to
these plain versions).

(a) Each plain unit against the JAX production code it stands for,
    imported from pic1dp_tpu.ops.pallas_kernels (_trig_block,
    _sincos_turns, _fast_wrap; the ratio drive transcribed from
    bench/probe_compute.py:81-86), on x in [0, lx) from a numpy seed.
    Bounds: stream_probes.units_tolerance (trig and poly: 3 f32 ulp at 1
    per copy, plus one ulp of the sum per addition over k copies; wrap one
    f32 ulp of lx; exp 1e-6 of the largest value), and 1e-12 for trig in
    float64.
(b) The kernel bodies and loop drivers in numpy over a sequential grid of
    128-row blocks (bench/probe_compute.py:95-112, bench/probe_overlap.py
    :60-81, bench/probe_pingpong.py:153-156, :202-204, :233-240): outputs
    within one f32 ulp (the JAX body scales extra by 1e-12 in float32 as
    the port does), bitwise at K = 0 and for every carry buffer, totals
    within 1e-6 (the TPU's float32 (8, 128) accumulator against float64).
(c) Dispatch; (d) the probes on the CPU; (e) the build hash.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pic1dp_tpu.ops.pallas_kernels import _fast_wrap, _sincos_turns, _trig_block
from pic1dp_tpu_torch.ops import stream_probes as sp
from pic1dp_tpu_torch.probes import compute_probe, overlap_probe, pingpong_probe
from pic1dp_tpu_torch.utils import nvcc

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

LX, NX = sp.LX, sp.NX
ULP1 = sp.ULP1                                      # 1.19e-7
UNITS = sorted(sp.UNITS)
N = 128 * 128 * 4                                   # four 128-row blocks


def _x(n=N, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).uniform(0.0, LX, n).astype(dtype)


def jax_unit(unit, x, c):
    """bench/probe_compute.py:71-89 on a numpy array, as numpy."""
    x = jnp.asarray(x)
    if unit == "trig":
        (c_m, s_m), = _trig_block(x + 1e-6 * c, LX, NX, (1,), x.dtype)
        out = c_m + s_m
    elif unit == "poly":
        t = x * np.float32(1.0 / LX) + 1e-6 * c
        cs, sn = _sincos_turns(t - jnp.floor(t))
        out = cs + sn
    elif unit == "exp":
        v = x + 1e-6 * c
        arg = jnp.clip(v * v * 0.5 - (v - 4.5) ** 2 * 2.0 - 1.0, -60.0, 60.0)
        r = jnp.exp(arg)
        out = (v + r * ((v - 4.5) * 4.0)) / (1.0 + r)
    else:
        out = _fast_wrap(x + c, LX)
    return np.asarray(out)


def jax_extra(unit, x, k):
    """extra of the TPU body: 0.0 plus k copies, added in order."""
    extra = np.zeros_like(x)
    for c in range(k):
        extra = extra + jax_unit(unit, x, c)
    return extra


# ---- (a) the plain units against the JAX production units ----

@pytest.mark.parametrize("k", [1, 4])
def test_trig_unit_matches_trig_block(k):
    x = _x()
    got = sp.units_plain("trig", torch.from_numpy(x), k)
    err = np.abs(got.numpy().astype(np.float64) - jax_extra("trig", x, k))
    assert got.dtype == torch.float32
    assert (err <= sp.units_tolerance("trig", k, got).numpy()).all(), err.max()
    x64 = _x(dtype=np.float64)
    got64 = sp.units_plain("trig", torch.from_numpy(x64), k).numpy()
    assert got64.dtype == np.float64
    np.testing.assert_allclose(got64, jax_extra("trig", x64, k), rtol=0, atol=1e-12)


@pytest.mark.parametrize("c", [0, 1, 2, 3])
def test_poly_wrap_exp_units_match_jax(c):
    x = _x(seed=c)
    tx = torch.from_numpy(x)
    for unit in ("poly", "wrap", "exp"):
        got = sp.unit_plain(unit, tx, c)
        err = np.abs(got.numpy().astype(np.float64) - jax_unit(unit, x, c))
        assert got.dtype == torch.float32
        assert (err <= sp.units_tolerance(unit, 1, got).numpy()).all(), (unit, err.max())
    assert sp.units_tolerance("poly", 1, got)[0] == 3 * ULP1
    assert sp.units_tolerance("wrap", 4, got)[0] == np.spacing(np.float32(LX))
    wrap = sp.unit_plain("wrap", tx, c).numpy()
    assert (wrap >= 0).all() and (wrap < np.float32(LX)).all()


def test_unit_params_are_the_tpu_probe_constants():
    prm = sp.unit_params(10)
    assert (prm.n, prm.nmode, prm.nx, prm.modes[0], prm.nspecies,
            prm.sp_kform[0]) == (10, 1, NX, 1, 1, 1)
    assert prm.lx == 2.0 * np.pi / 0.36 and prm.nx_over_lx == NX / prm.lx
    assert (prm.sp_k_v0[0], prm.sp_k_iv[0], prm.sp_k_ivb[0], prm.sp_k_half_iv[0],
            prm.sp_k_half_ivb[0], prm.sp_k_log_ratio[0]) == (4.5, 1.0, 4.0, 0.5, 2.0, -1.0)


# ---- (b) numpy transcriptions of the kernel bodies and loop drivers ----

def numpy_unit_body(ins, unit, k, rows=128):
    """bench/probe_compute.py:95-112 (= probe_overlap.py:60-81 for trig)
    over a sequential grid of `rows`-row blocks, aliased {0:0, 1:1, 3:2}.
    Returns the outputs and the (8, 128) accumulator's total."""
    arrs = [a.reshape(-1, 128).copy() for a in ins]
    outs = [arrs[0], arrs[1], arrs[3]]
    acc_ref = np.zeros((8, 128), np.float32)
    for b in range(arrs[0].shape[0] // rows):
        blk = slice(b * rows, (b + 1) * rows)
        x = arrs[0][blk].copy()
        acc = x.copy()
        for r in arrs[1:]:
            acc = acc + r[blk]
        extra = jax_extra(unit, x, k)
        for j, o in enumerate(outs):
            o[blk] = acc * np.float32(1.0 + 0.25 * j) + np.float32(1e-12) * extra
        acc_ref += np.sum(acc.reshape(rows // 8, 8, 128), axis=0)
    return [o.reshape(-1) for o in outs], float(acc_ref.sum(dtype=np.float64))


def _unit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [_x(seed=seed)] + [rng.standard_normal(N).astype(np.float32) for _ in range(3)]


# (kernel, keyword arguments): each kernel at its defaults (the ring 8 KB x
# 4) and the ring's other keywords, which the CPU ignores as it should
KERNEL_CASES = {
    "stream_units": (sp.stream_units, {}),
    "stream_bulk_units": (sp.stream_bulk_units, {}),
    "stream_bulk_units 4 KB x 4, 4 consumer warps":
        (sp.stream_bulk_units, dict(tile_bytes=4096, stages=4, consumer_warps=4)),
    "stream_bulk_units 16 KB x 3": (sp.stream_bulk_units, dict(tile_bytes=16384, stages=3)),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
@pytest.mark.parametrize("k", [0, 1, 4])
@pytest.mark.parametrize("unit", UNITS)
def test_unit_kernels_plain_match_numpy_transcription(case, unit, k):
    kernel, kw = KERNEL_CASES[case]
    ins = _unit_inputs(seed=k)
    want, want_total = numpy_unit_body(ins, unit, k)
    tins = [torch.from_numpy(a.copy()) for a in ins]
    outs, total = kernel(tins, sp.ALIAS, unit, k, **kw)
    assert [o is tins[i] for o, i in zip(outs, (0, 1, 3))] == [True] * 3
    for j, (o, w) in enumerate(zip(outs, want)):
        o = o.numpy()
        if k == 0:
            np.testing.assert_array_equal(o, w, err_msg=f"out {j}")
        else:
            assert (np.abs(o - w) <= np.spacing(np.abs(w))).all(), f"out {j}"
    np.testing.assert_array_equal(tins[2].numpy(), ins[2])
    assert total.dtype == torch.float64
    assert abs(float(total) - want_total) <= 1e-6 * abs(want_total)


def test_units_plain_at_eps_one_is_the_units_sum():
    """eps = 1 with acc = 0 (in_1 = -in_0, in_2 = in_3 = 0) writes extra
    itself to every output: how chip_smoke.py reads the units' sum off
    the card."""
    x = _x()
    ins = [torch.from_numpy(a.copy()) for a in (x, -x, np.zeros_like(x), np.zeros_like(x))]
    outs, total = sp.stream_units_plain(ins, sp.ALIAS, "trig", 2, eps=1.0)
    want = sp.units_plain("trig", torch.from_numpy(x), 2)
    assert all(torch.equal(o, want) for o in outs) and float(total) == 0.0


def numpy_body(ins):
    """bench/probe_pingpong.py:84-90 on whole streams: outputs and total."""
    acc = ins[0].copy()
    for r in ins[1:]:
        acc = acc + r
    return [acc * np.float32(1.0 + 0.25 * j) for j in range(3)], \
        float(acc.sum(dtype=np.float64))


def numpy_loop(layout, ins, steps):
    """The TPU scan bodies in numpy: flat (probe_pingpong.py:153-156, the
    same values in place or not), pingpong (:202-204) and pp2 (:233-240,
    one kernel call per step).  Returns the carry buffers, h or the spare
    set, and the last call's total."""
    if layout == "pingpong":
        bufs, h = [np.stack([a, a]) for a in ins], 0
        for _ in range(steps):
            outs, total = numpy_body([b[h] for b in bufs])
            for b, o in zip((bufs[0], bufs[1], bufs[3]), outs):
                b[1 - h] = o
            h = 1 - h
        return bufs, h, total
    cur = [a.copy() for a in ins]
    spare = [np.zeros_like(ins[0]) for _ in range(3)]
    for _ in range(steps):
        outs, total = numpy_body(cur)
        if layout == "pp2":
            for d, o in zip(spare, outs):
                d[...] = o
            outs, spare = spare, [cur[0], cur[1], cur[3]]
        cur = [outs[0], outs[1], cur[2], outs[2]]
    return cur, spare if layout == "pp2" else None, total


@pytest.mark.parametrize("layout", pingpong_probe.LAYOUTS)
def test_carry_loop_plain_matches_numpy_transcription(layout):
    rng = np.random.default_rng(7)
    ins = [rng.standard_normal(N).astype(np.float32) for _ in range(4)]
    want, other, want_total = numpy_loop(layout, ins, 3)
    tins = [torch.from_numpy(a.copy()) for a in ins]
    c = pingpong_probe.carry(layout, tins)
    totals = [pingpong_probe.step(c, sp.stream_carry) for _ in range(3)]
    for i, (b, w) in enumerate(zip(c.bufs, want)):
        np.testing.assert_array_equal(b.numpy(), w, err_msg=f"slot {i}")
    if layout == "pingpong":
        assert c.h.dtype == torch.int32 and int(c.h) == other == 1
    if layout == "pp2":
        for b, w in zip(c.spare, other):
            np.testing.assert_array_equal(b.numpy(), w)
    if layout == "inplace":                 # the same four buffers throughout
        assert all(b is t for b, t in zip(c.bufs, tins))
    assert abs(float(totals[-1]) - want_total) <= 1e-6 * abs(want_total)


# ---- (c) dispatch ----

def test_cpu_dispatch_takes_plain_and_launches_nothing():
    before = [k.launches for k in sp.KERNELS]
    ins = _unit_inputs()
    a = [torch.from_numpy(x.copy()) for x in ins]
    b = [torch.from_numpy(x.copy()) for x in ins]
    outs_a, total_a = sp.stream_bulk_units(a, sp.ALIAS, "exp", 2)
    outs_b, total_b = sp.stream_units_plain(b, sp.ALIAS, "exp", 2)
    assert all(torch.equal(x, y) for x, y in zip(outs_a + a, outs_b + b))
    assert torch.equal(total_a, total_b)
    h = torch.zeros(1, dtype=torch.int32)
    two = [torch.stack([t, t]) for t in a]
    outs, _ = sp.stream_carry(two, sp.ALIAS, h=h)
    assert [o is two[i] for o, i in zip(outs, (0, 1, 3))] == [True] * 3
    assert torch.equal(two[0][0], a[0]) and not torch.equal(two[0][1], a[0])
    assert [k.launches for k in sp.KERNELS] == before == [0] * len(sp.KERNELS)


def test_cuda_path_checks_its_inputs():
    """Off the CPU a unit or carry kernel launches or raises: an unbuilt
    (unit, K), a wrong pattern or a device without the kernel raise before
    any launch."""
    def meta(k, shape=(4096,)):
        return [torch.empty(shape, dtype=torch.float32, device="meta") for _ in range(k)]

    for kernel in (sp.stream_units, sp.stream_bulk_units):
        with pytest.raises(NotImplementedError, match="x 3"):
            kernel(meta(4), sp.ALIAS, "trig", 3)
        with pytest.raises(NotImplementedError, match="'sin'"):
            kernel(meta(4), sp.ALIAS, "sin", 1)
        with pytest.raises(NotImplementedError, match="4 reads"):
            kernel(meta(5), {}, "trig", 1)
        for k in (0, 4):
            with pytest.raises(ValueError, match="no stream kernel for device meta"):
                kernel(meta(4), sp.ALIAS, "wrap", k)
    with pytest.raises(ValueError, match="no stream kernel for device meta"):
        sp.stream_units(meta(4), sp.ALIAS, "exp", 2)
    with pytest.raises(NotImplementedError, match=r"x 2 .*K in \(0, 1, 4\)"):
        sp.stream_bulk_units(meta(4), sp.ALIAS, "exp", 2)
    with pytest.raises(NotImplementedError, match="carry kernels take 4 reads"):
        sp.stream_carry(meta(6), {})
    with pytest.raises(ValueError, match="no stream kernel for device meta"):
        sp.stream_carry(meta(4), {}, dest=meta(3))
    h = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no stream kernel for device meta"):
        sp.stream_carry(meta(4, (2, 4096)), sp.ALIAS, h=h)
    with pytest.raises(NotImplementedError, match="4 reads and 3 writes"):
        sp.stream_carry(meta(3), {})
    with pytest.raises(ValueError, match="unknown unit"):
        sp.stream_units_plain([torch.zeros(8)] * 4, {}, "sin", 1)
    assert [k.launches for k in sp.KERNELS] == [0] * len(sp.KERNELS)
    assert set(compute_probe.UNIT_ORDER) == set(sp.UNITS)
    assert set(compute_probe.KS) | {0, overlap_probe.K_TRIG} <= set(sp.UNIT_KS)
    assert {0, overlap_probe.K_TRIG} <= set(sp.BULK_UNIT_KS)


# ---- (d) the probes on the CPU ----

def test_compute_probe_runs_on_cpu(capsys):
    rows = compute_probe.main(["12", "--device", "cpu"])
    units = {f"{u} x{k}" for u in compute_probe.UNIT_ORDER for k in compute_probe.KS}
    computes = {f"{u} compute" for u in compute_probe.UNIT_ORDER}
    assert set(rows) == {compute_probe.BASELINE, "f32 substep1",
                         "port ss1 pattern 4r+2w"} | units | computes
    assert all(rows[lbl].ms > 0 for lbl in set(rows) - computes)
    assert rows["trig x4"].bytes == 7 * 4 * 2**12
    out = capsys.readouterr().out
    assert "GB/s" not in out and "marginal" in out and "overhang" in out
    assert out.count("its units") == 3


def test_overlap_probe_runs_on_cpu(capsys):
    rows = overlap_probe.main(["12", "--device", "cpu"])
    sweep = [f"{lbl} {w} consumer warps trig x{k}"
             for lbl, kernel, _ in overlap_probe.CASES if kernel is sp.stream_bulk_units
             for w in overlap_probe.SWEEP_WARPS for k in (0, overlap_probe.K_TRIG)]
    assert list(rows) == [f"{lbl} {what}" for lbl, *_ in overlap_probe.CASES
                          for what in ("trig x0", "trig x4", "compute")] + sweep
    assert all(r.ms > 0 for r in rows.values())
    assert len(sweep) == 3 * len(overlap_probe.SWEEP_WARPS) * 2
    assert max(overlap_probe.SWEEP_WARPS) == sp.MAX_CONSUMER_WARPS
    out = capsys.readouterr().out
    assert "no verdict" in out and "consumer-warp sweep" in out and "SASS" not in out


def test_turns_ring_rows_name_rows_of_both_probes():
    """probes/turns.py --ring picks its rows from the probes' own tables by
    kernel and label: the labels it names exist, and every ring of both
    probes is among its rows."""
    from pic1dp_tpu_torch.probes import pipeline_probe, turns

    assert "direct 4 blocks/SM" in [lbl for lbl, *_ in overlap_probe.CASES]
    assert "default 4 blocks/SM aliased" in [lbl for lbl, *_ in pipeline_probe.CASES]
    assert "bulk 8 KB x 4 aliased" in [lbl for lbl, k, *_ in pipeline_probe.CASES
                                       if k is sp.stream_bulk]
    assert "sp.stream_bulk_units" in turns._RING_TURN and "sp.stream_bulk " in turns._RING_TURN
    with pytest.raises(SystemExit):
        turns.main(["--ring"])


def test_pingpong_probe_runs_as_a_module_on_cpu():
    proc = subprocess.run([sys.executable, "-m", "pic1dp_tpu_torch.probes.pingpong_probe",
                           "12", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for layout in pingpong_probe.LAYOUTS:
        assert f"\n{layout} " in proc.stdout
    assert "pp2-free: no counterpart" in proc.stdout


def test_pingpong_probe_main_returns_every_layout():
    rows = pingpong_probe.main(["12", "--device", "cpu"])
    assert list(rows) == list(pingpong_probe.LAYOUTS)
    assert all(r.ms > 0 and r.bytes == 7 * 4 * 2**12 for r in rows.values())


# ---- (e) the build hash covers the headers ----

def test_build_hash_covers_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(REPO / "pic1dp_tpu_torch" / "csrc", csrc)
    src = csrc / "stream_probes.cu"
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["bulk_copy.cuh", "substep_math.cuh"]
    first = nvcc.build_hash(src)
    assert first == nvcc.build_hash(REPO / "pic1dp_tpu_torch" / "csrc" / "stream_probes.cu")
    header = csrc / "substep_math.cuh"
    data = bytearray(header.read_bytes())
    data[-2] ^= 1
    header.write_bytes(bytes(data))
    changed = nvcc.build_hash(src)
    assert changed != first
    assert nvcc.build_hash(csrc / "substep_kernels.cu") != nvcc.build_hash(
        REPO / "pic1dp_tpu_torch" / "csrc" / "substep_kernels.cu")
    assert nvcc.build_hash(csrc / "hist_kernels.cu") != nvcc.build_hash(
        REPO / "pic1dp_tpu_torch" / "csrc" / "hist_kernels.cu")
    (csrc / "bulk_copy.cuh").write_text((csrc / "bulk_copy.cuh").read_text() + "\n")
    edited = nvcc.build_hash(src)
    assert edited not in (first, changed)
    (csrc / "extra.cuh").write_text("// another header\n")
    assert nvcc.build_hash(src) not in (first, changed, edited)
