"""The stream probe kernels' plain version (ops/stream_probes.py) against a
numpy transcription of the TPU probe kernel body (bench/kernel_probe.py
:143-158, the same body as bench/probe_pipeline.py:70-87), and both probe
entry points end to end on the CPU.  The CUDA kernels themselves run only on
the card (chip_smoke.py holds them bitwise to stream_plain)."""

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


@pytest.mark.parametrize("kernel", [sp.stream_rw, sp.stream_bulk],
                         ids=["stream_rw", "stream_bulk"])
def test_cpu_dispatch_takes_plain_and_launches_nothing(kernel):
    n_read, n_write, alias = PATTERNS["ss2_4r3w_aliased"]
    ins = _inputs(n_read, n=4099)          # not a multiple of 4 or of a tile
    a = [torch.from_numpy(x.copy()) for x in ins]
    b = [torch.from_numpy(x.copy()) for x in ins]
    before = [k.launches for k in sp.KERNELS]
    outs_a, total_a = kernel(a, n_write, alias)
    outs_b, total_b = sp.stream_plain(b, n_write, alias)
    assert all(torch.equal(x, y) for x, y in zip(outs_a + a, outs_b + b))
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
        sp.bulk_blocks_per_sm(4, 3, 4100, 4)
    with pytest.raises(ValueError, match="stages"):
        sp.bulk_blocks_per_sm(4, 3, 4096, 0)
    built = {(nr, nw) for _, nr, nw, _ in kernel_probe.TPU_PATTERNS + kernel_probe.PORT_PATTERNS}
    assert built <= sp.PATTERNS


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
    assert rows["f32 substep1 recompute"].bytes == 20 * 2**12
    assert rows["bf16 substep2 recompute"].bytes == 28 * 2**12
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


def test_grid_forms_variants_apply():
    """probes/grid_forms.py finds in csrc/substep_kernels.cu each piece it
    swaps: every variant is a source of its own, the kernel's unchanged."""
    from pic1dp_tpu_torch.probes import grid_forms

    src = (grid_forms.CSRC / "substep_kernels.cu").read_text()
    variants = grid_forms.variant_sources()
    assert list(variants) == list(grid_forms.FORMS)
    assert variants["kernel"] == src
    assert len({text for text in variants.values()}) == len(variants)
    assert "deposit_lanes(r.rho" in src
    assert all("deposit_lanes(r.rho" not in variants[k]
               for k in ("match_half", "lane_serial", "atomic"))
