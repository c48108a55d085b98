"""The stream probe kernels' plain version (ops/stream_probes.py) against a
numpy transcription of the TPU probe kernel body (bench/kernel_probe.py
:143-158, the same body as bench/probe_pipeline.py:70-87), and both probe
entry points end to end on the CPU.  The CUDA kernels themselves run only
on the card (chip_smoke.py holds them bitwise to stream_plain)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch.ops import stream_probes as sp
from pic1dp_tpu_torch.probes import kernel_probe, pipeline_probe

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

# the alias maps of bench/kernel_probe.py:206-215: (reads, writes, alias)
PATTERNS = {
    "ss1_4r1w_aliased": (4, 1, {3: 0}),
    "ss2_4r3w_aliased": (4, 3, {0: 0, 1: 1, 3: 2}),
    "ss2_4r3w_no_alias": (4, 3, {}),
    "3r1w_aliased": (3, 1, {2: 0}),
    "4r4w_aliased": (4, 4, {0: 0, 1: 1, 2: 2, 3: 3}),
}


def numpy_stream_only(ins, n_write, alias, rows=128):
    """kernel_probe.py:143-158 in numpy: a sequential grid over blocks of
    `rows` rows of the (n/128, 128) streams, each block summing the inputs,
    writing acc * (1 + 0.25 j) to each output (over the aliased input), and
    folding acc into one (8, 128) float32 accumulator.  Returns the inputs
    after the call, the outputs and the accumulator's total."""
    arrs = [a.reshape(-1, 128).copy() for a in ins]
    by_out = {j: i for i, j in alias.items()}
    outs = [arrs[by_out[j]] if j in by_out else np.empty_like(arrs[0])
            for j in range(n_write)]
    acc_ref = np.zeros((8, 128), np.float32)
    for b in range(arrs[0].shape[0] // rows):
        blk = slice(b * rows, (b + 1) * rows)
        acc = arrs[0][blk].copy()
        for r in arrs[1:]:
            acc = acc + r[blk]
        for j, o in enumerate(outs):
            o[blk] = acc * np.float32(1.0 + 0.25 * j)
        acc_ref += np.sum(acc.reshape(rows // 8, 8, 128), axis=0)
    return ([a.reshape(-1) for a in arrs], [o.reshape(-1) for o in outs],
            float(acc_ref.sum(dtype=np.float64)))


def _inputs(n_read, n=128 * 128 * 4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(n_read)]


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_stream_plain_matches_numpy_transcription(name):
    n_read, n_write, alias = PATTERNS[name]
    ins = _inputs(n_read)
    want_ins, want_outs, want_total = numpy_stream_only(ins, n_write, alias)
    tins = [torch.from_numpy(a.copy()) for a in ins]
    outs, total = sp.stream_plain(tins, n_write, alias)
    assert total.dtype == torch.float64 and total.shape == ()
    for j, (o, w) in enumerate(zip(outs, want_outs)):
        np.testing.assert_array_equal(o.numpy(), w, err_msg=f"out {j}")
    # aliased inputs are overwritten by their outputs; the others are kept
    for i, (t, w) in enumerate(zip(tins, want_ins)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f"in {i}")
        if i in alias:
            assert outs[alias[i]] is tins[i]
        else:
            np.testing.assert_array_equal(t.numpy(), ins[i])
    assert abs(float(total) - want_total) <= 1e-6 * abs(want_total)


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("kernel", [sp.stream_rw, sp.stream_bulk],
                         ids=["stream_rw", "stream_bulk"])
def test_cpu_dispatch_takes_plain_and_launches_nothing(kernel, name):
    """On CPU tensors either stream kernel, at its defaults and at every
    grid or ring of the pipeline probe, is stream_plain bit for bit."""
    n_read, n_write, alias = PATTERNS[name]
    ins = _inputs(n_read, n=4099)          # not a multiple of 4 or of a tile
    before = [k.launches for k in sp.KERNELS]
    for kw in [{}] + [kw for _, k, kw, _ in pipeline_probe.CASES if k is kernel]:
        a = [torch.from_numpy(x.copy()) for x in ins]
        b = [torch.from_numpy(x.copy()) for x in ins]
        outs_a, total_a = kernel(a, n_write, alias, **kw)
        outs_b, total_b = sp.stream_plain(b, n_write, alias)
        assert all(torch.equal(x, y) for x, y in zip(outs_a + a, outs_b + b)), kw
        assert torch.equal(total_a, total_b)
    assert [k.launches for k in sp.KERNELS] == before == [0] * len(sp.KERNELS)


def test_cuda_path_checks_its_inputs():
    """Off the CPU a stream kernel launches or raises: an unbuilt pattern, a
    wrong dtype or a device without the kernel raise before any launch."""
    def meta(k, dtype=torch.float32):
        return [torch.empty(4096, dtype=dtype, device="meta") for _ in range(k)]

    with pytest.raises(NotImplementedError, match="5 reads and 2 writes"):
        sp.stream_rw(meta(5), 2, {})
    with pytest.raises(ValueError, match="float32"):
        sp.stream_bulk(meta(4, torch.float64), 3, {})
    for kernel in (sp.stream_rw, sp.stream_bulk):
        with pytest.raises(ValueError, match="no stream kernel for device meta"):
            kernel(meta(4), 3, {0: 0})
    with pytest.raises(ValueError, match="distinct"):
        sp.stream_plain([torch.zeros(8)] * 4, 3, {0: 0, 1: 0})
    with pytest.raises(ValueError, match="multiple of 16"):
        sp.bulk_ring(4, 3, 4100, 4)
    with pytest.raises(ValueError, match="stages"):
        sp.bulk_ring(4, 3, 4096, 0)
    built = {(nr, nw) for _, nr, nw, _ in kernel_probe.TPU_PATTERNS + kernel_probe.PORT_PATTERNS}
    assert built <= sp.PATTERNS


# ---- the ring's sizing, checked before the card is asked ----

# (reads, tile bytes, stages, consumer warps): shared memory
RINGS = {
    "4 KB x 4": ((4, 4096, 4, 31), 256 + 4 * 4 * 4096),
    "8 KB x 4": ((4, 8192, 4, 31), 256 + 4 * 4 * 8192),
    "16 KB x 3": ((4, 16384, 3, 8), 256 + 3 * 4 * 16384),
    "6r 8 KB x 4": ((6, 8192, 4, 1), 256 + 4 * 6 * 8192),
}


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_sizing(name):
    """One ring block: the full and empty mbarriers of MAX_STAGES slots,
    then `stages` slots of one tile per input, within what a block may
    have at any consumer count.  (The library checks these sizes against
    its own at load.)"""
    (n_read, tile_bytes, stages, warps), smem = RINGS[name]
    assert sp.bulk_smem_bytes(n_read, tile_bytes, stages) == smem
    assert sp.BAR_BYTES == 2 * 8 * sp.MAX_STAGES
    sp._check_ring(n_read, tile_bytes, stages, warps)       # fits: no error


def test_ring_too_large_or_too_many_warps_raises():
    """A ring larger than one SM's shared memory for a block, or a block
    past 1024 threads, raises before any library is loaded."""
    with pytest.raises(ValueError, match=r"3 stages x 6 inputs x 16384 bytes needs "
                                         r"295424 bytes"):
        sp.bulk_ring(6, 3, 16384, 3)
    with pytest.raises(ValueError, match=r"16 stages x 4 inputs x 4096 bytes needs \d+ bytes"):
        sp.bulk_units_ring("trig", 4, 4096, 16)
    for warps in (0, 32):
        with pytest.raises(ValueError, match="1 to 31 consumer warps"):
            sp.bulk_units_ring("trig", 4, 8192, 4, consumer_warps=warps)
    assert 32 * (sp.MAX_CONSUMER_WARPS + 1) == sp.MAX_BULK_THREADS
    # the largest ring the probes take fits, with the block sum beside it
    largest = max(sp.bulk_smem_bytes(pipeline_probe.N_READ, kw["tile_bytes"], kw["stages"])
                  for _, kernel, kw, _ in pipeline_probe.CASES if kernel is sp.stream_bulk)
    assert largest + sp.BLOCK_SUM_BYTES <= sp.SMEM_PER_BLOCK


def _occupancy(smem_blocks: int, registers: int) -> dict[int, int]:
    """Blocks an H100 SM holds at each consumer count: at most smem_blocks
    by shared memory and 64 warps, and as many warps as the four schedulers'
    16,384 registers each hold, allocated 256 a warp at a time."""
    warps = 4 * (16384 // (-(-registers * 32 // 256) * 256))
    return {c: min(smem_blocks, 64 // (c + 1), warps // (c + 1))
            for c in range(1, sp.MAX_CONSUMER_WARPS + 1)}


# (blocks by shared memory, registers, compute): consumer warps, blocks per
# SM; the registers are ptxas' for the ring's instantiations
PICKS = {
    "8 KB x 4, stream": ((1, 48, False), (31, 1)),
    "8 KB x 4, trig x4": ((1, 56, True), (31, 1)),
    "4 KB x 4, stream": ((3, 48, False), (12, 3)),
    "4 KB x 4, trig x4": ((3, 56, True), (31, 1)),
    "4 KB x 2, stream": ((5, 48, False), (7, 5)),
    "none fits": ((0, 48, False), (31, 0)),
    "none fits, compute": ((0, 56, True), (31, 0)),
}


@pytest.mark.parametrize("name", sorted(PICKS))
def test_ring_consumers_picks_blocks_or_warps(name):
    """ring_consumers: with compute, the most consumer warps of which a
    block fits; without, the most blocks, then the most consumer warps at
    that many blocks (a ring that fits nowhere keeps 0 blocks, which the
    wrapper refuses)."""
    (smem_blocks, registers, compute), want = PICKS[name]
    per_sm = _occupancy(smem_blocks, registers)
    c = sp.ring_consumers(per_sm, compute)
    assert (c, per_sm[c]) == want


def test_kernel_probe_runs_on_cpu(capsys):
    rows = kernel_probe.main(["12", "--device", "cpu"])
    labels = [lbl for lbl, *_ in kernel_probe.TPU_PATTERNS + kernel_probe.PORT_PATTERNS]
    grid_rows = {f"{m} modes nx {nx} n {2**12} substep{s} nonlinear"
                 for m, _, nx in kernel_probe.MANY_MODE_SHAPES for s in (1, 2)}
    assert set(rows) == {f"{d} substep{s}{tag}" for d in ("f32", "bf16") for s in (1, 2)
                         for tag in ("", " recompute")} | set(labels) | grid_rows
    assert all(r.ms > 0 for r in rows.values())
    assert rows[f"32 modes nx 1024 n {2**12} substep2 nonlinear"].bytes == 36 * 2**12
    assert rows["bf16 substep1"].bytes == 20 * 2**12
    assert rows["f32 substep1 recompute"].bytes == 16 * 2**12
    assert rows["bf16 substep2 recompute"].bytes == 26 * 2**12
    assert rows["port ss2 pattern 6r+3w aliased"].bytes == 9 * 4 * 2**12
    out = capsys.readouterr().out
    assert "host clock" in out and "GB/s" not in out.split("-- real kernels")[1].splitlines()[1]
    assert out.count("not ported") == 1       # the packed p||w1 layout


def test_pipeline_probe_runs_on_cpu():
    rows = pipeline_probe.main(["12", "--device", "cpu"])
    assert list(rows) == [lbl for lbl, *_ in pipeline_probe.CASES]
    assert all(r.ms > 0 and r.bytes == 7 * 4 * 2**12 for r in rows.values())


def test_probe_module_runs_with_device_cpu():
    proc = subprocess.run([sys.executable, "-m", "pic1dp_tpu_torch.probes.pipeline_probe",
                           "12", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "bulk 8 KB x 4 aliased" in proc.stdout


def test_probe_without_cuda_refuses():
    proc = subprocess.run([sys.executable, "-m", "pic1dp_tpu_torch.probes.kernel_probe", "12"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
