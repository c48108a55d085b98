"""What the port's substep wrapper hands its CUDA kernels (ops/substep_kernels.py).

The kernels themselves run only on the card (chip_smoke.py holds them to
their plain versions there).  Here: the grid-angle table against numpy's
cos and sin of the integer-reduced angle, the choice between shared and
device memory for it at the edges of the 48 KB rule, the grid as a pure
function of the marker count, the markers per thread, and the wrapper's
refusals before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch import distributions as tdist
from pic1dp_tpu_torch.ops import substep_kernels as sk

MODES = (1, 2, 3, 7, 8, 16)


def _cfg(nx, modes=MODES, dtype="float64"):
    return dataclasses.replace(
        tcfg_mod.bump_on_tail_default(nx=nx, nparticle_max=1024, dtype=dtype, verbosity=0),
        modes=modes)


def _substeps(cfg):
    dtype = getattr(torch, cfg.dtype)
    return sk.FusedSubsteps(cfg, tdist.SpeciesParams.from_config(cfg, dtype, "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("nx", [64, 192, 1024])
def test_angle_table_is_the_rounded_float64_angle(nx, dtype):
    tab = sk.angle_table(_cfg(nx), dtype, "cpu")
    assert tab.shape == (len(MODES), nx, 2) and tab.dtype == dtype
    k = (np.array(MODES)[:, None] * np.arange(nx)) % nx
    theta = 2.0 * np.pi * k / nx
    want = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    got = tab.numpy()
    # every entry is the float64 value rounded once to the table's dtype
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    # the integer reduction keeps the angle: against the unreduced 2 pi m ix / nx
    raw = 2.0 * np.pi * np.array(MODES)[:, None] * np.arange(nx) / nx
    np.testing.assert_allclose(want[..., 0], np.cos(raw), rtol=0, atol=1e-13)
    np.testing.assert_allclose(want[..., 1], np.sin(raw), rtol=0, atol=1e-13)
    # storage padded with zeros to a multiple of 16 bytes for the bulk copy
    store = tab.untyped_storage()
    assert tab.storage_offset() == 0 and store.nbytes() % 16 == 0
    flat = torch.empty(0, dtype=dtype).set_(store)
    assert torch.all(flat[tab.numel():] == 0)


@pytest.mark.parametrize("nmode,nx", [(1, 3), (3, 7), (1, 192)])
def test_angle_table_padding_of_odd_sizes(nmode, nx):
    tab = sk.angle_table(_cfg(nx, MODES[:nmode]), torch.float32, "cpu")
    nbytes = nmode * nx * 2 * 4
    assert tab.untyped_storage().nbytes() == -(-nbytes // 16) * 16
    assert sk.angle_smem_bytes(nmode, nx, 4) == -(-nbytes // 16) * 16


@pytest.mark.parametrize("nmode,nx,itemsize,smem", [
    (1, 5632, 4, 45056),          # f32: the largest table in shared memory
    (1, 5633, 4, 0),              # one entry more: read from device memory
    (8, 704, 4, 45056),
    (16, 353, 4, 0),
    (1, 2816, 8, 45056),          # f64
    (1, 2817, 8, 0),
    (3, 64, 8, 3072),
    (1, 1024, 4, 8192),           # the headline
])
def test_table_in_shared_memory_by_the_48_kb_rule(nmode, nx, itemsize, smem):
    assert sk.ANGLE_SMEM_MAX == 48 * 1024 - 4096
    assert sk.angle_smem_bytes(nmode, nx, itemsize) == smem


@pytest.mark.parametrize("markers", [1, 255, 102_400, 1_000_448, 2 * 2**20, 6_400_000, 2**26])
@pytest.mark.parametrize("vec", [1, 2, 4])
def test_launch_grid_is_a_pure_function_covering_the_markers(markers, vec):
    sms = 132
    for b in (2, 4, 8):
        grid = sk.launch_grid(markers, vec, sms, b)
        assert grid == sk.launch_grid(markers, vec, sms, b)      # fixed for a shape
        assert 1 <= grid <= b * sms
        # one iteration per thread covers the markers, unless the cap binds
        assert grid * sk.THREADS * vec >= markers or grid == b * sms
        # and no block is left without a group of markers
        assert (grid - 1) * sk.THREADS * vec < markers
    assert sk.launch_grid(markers, vec, sms) == sk.launch_grid(markers, vec, sms,
                                                               sk.BLOCKS_PER_SM)


def test_launch_grid_values():
    assert sk.launch_grid(102_400, 4, 132) == 100
    assert sk.launch_grid(6_400_000, 4, 132, 4) == 528
    assert sk.launch_grid(2**26, 4, 132, 8) == 1056
    assert sk.launch_grid(1, 1, 132) == 1


@pytest.mark.parametrize("nmode,itemsize,vec", [
    (1, 4, 4), (4, 4, 4), (5, 4, 4), (16, 4, 4), (1, 8, 2), (3, 8, 2), (16, 8, 2),
    (17, 4, 4), (33, 8, 2), (64, 4, 4)])
def test_vector_width_by_mode_bin(nmode, itemsize, vec):
    """16-byte loads in every bin: the grid bin keeps no per-mode sum in
    registers."""
    assert sk.vector_width(nmode, itemsize) == vec


def test_substeps_hold_table_and_counters_on_the_species_device():
    cfg = _cfg(192, (1, 2, 3))
    subs = _substeps(cfg)
    assert subs.angles.device.type == "cpu" and subs.angles.shape == (3, 192, 2)
    assert subs.angles.dtype == torch.float64
    torch.testing.assert_close(subs.angles, sk.angle_table(cfg, torch.float64, "cpu"),
                               rtol=0, atol=0)
    assert subs._done.dtype == torch.int32 and subs._done.tolist() == [0, 0]
    assert subs.blocks_per_sm == sk.BLOCKS_PER_SM
    bf16 = _substeps(dataclasses.replace(_cfg(64, (1,), "float32"), bf16_weights=True))
    assert bf16.angles.dtype == torch.float32        # the arithmetic type


def test_wrapper_refuses_table_or_counters_on_another_device():
    subs = _substeps(_cfg(64, (1,)))
    subs.check_scratch(torch.device("cpu"))
    with pytest.raises(ValueError, match="angle table lies on cpu, the streams on meta"):
        subs.check_scratch(torch.device("meta"))
    subs.angles = subs.angles.to("meta")
    with pytest.raises(ValueError, match="counters lies on cpu, the streams on meta"):
        subs.check_scratch(torch.device("meta"))


def test_meta_streams_raise_before_any_launch():
    cfg = _cfg(64, (1,))
    subs = _substeps(cfg)
    before = [k.launches for k in sk.KERNELS]
    meta = [torch.empty((1, 1024), dtype=torch.float64, device="meta")] * 4
    modes = [torch.empty((1,), dtype=torch.float64, device="meta")] * 2
    with pytest.raises(ValueError, match="no substep kernel for device meta"):
        subs.substep1(*meta, *modes)
    assert [k.launches for k in sk.KERNELS] == before
