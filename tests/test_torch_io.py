"""The port's copies of the JAX package's jax-free modules stay in step with
the originals: the config surface, the PETSc-binary stream and the writer's
golden bytes, the timers; and chip_smoke.py's dispersion root is the
package's own."""

import io
import os
import sys

import numpy as np
import pytest

import pic1dp_tpu.config as jcfg_mod
from pic1dp_tpu.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu.io import petsc_binary as jpb
from pic1dp_tpu_torch import config as tcfg_mod
from pic1dp_tpu_torch.core.diagnostics import Energies, PtclDist
from pic1dp_tpu_torch.io import petsc_binary as tpb
from pic1dp_tpu_torch.io.writer import SnapshotWriter
from pic1dp_tpu_torch.utils.timers import PhaseTimers

import test_golden_format as golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _presets():
    yield "default", {}
    for name in ("bump_on_tail_default", "landau_damping", "two_stream"):
        yield name, {}
    yield "bump_on_tail_default", dict(nx=256, dtype="float64", bf16_weights=False,
                                       modes=(1, 2), init_modes=(1, 2),
                                       init_amp_cos=(0.0, 1e-6), init_amp_sin=(1e-5, 0.0))


@pytest.mark.parametrize("name,kw", list(_presets()),
                         ids=["default", "bump_on_tail", "landau", "two_stream",
                              "bump_on_tail_overrides"])
def test_config_to_dict_matches(name, kw):
    if name == "default":
        a, b = tcfg_mod.Config(), jcfg_mod.Config()
    else:
        a, b = getattr(tcfg_mod, name)(**kw), getattr(jcfg_mod, name)(**kw)
    assert a.to_dict() == b.to_dict()
    assert a.to_json() == b.to_json()
    assert tcfg_mod.Config.from_json(b.to_json()) == a


def test_config_validate_matches():
    """The same configs are refused, with the same messages."""
    bad = [dict(marker="physical"), dict(linear=True, deltaf=False),
           dict(bf16_weights=True, dtype="float64"), dict(output_interval=0.05),
           dict(init_modes=(1, 2)), dict(species=[{"nparticle_init": 10**8}])]
    for kw in bad:
        msgs = []
        for mod in (tcfg_mod, jcfg_mod):
            with pytest.raises(ValueError) as exc:
                mod.Config.from_dict({**mod.Config().to_dict(), **kw}).validate()
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], kw


def test_writer_reproduces_golden_bytes(tmp_path):
    """tests/test_golden_format.py's fixture, byte for byte, from the port's
    writer."""
    g = golden
    cfg = tcfg_mod.Config(species=(tcfg_mod.SpeciesConfig(),), modes=g.MODES, nx=g.NX,
                          nv=g.NV, nx_opd=g.NX_OPD, nv_opd=g.NV_OPD, lx=g.LX,
                          v_max=g.V_MAX)
    with SnapshotWriter(cfg, str(tmp_path)) as w:
        eng = Energies(field=np.float64(g.E_FIELD), marker=np.array([g.MARKER]),
                       total=np.array([g.TOTAL]), pertb=np.array([g.PERTB]))
        shape_xv, shape_v = (1, g.NV_OPD, g.NX_OPD), (1, g.NV_OPD)
        ptcl = PtclDist(
            markr_xv=np.asarray(g.MARKR_XV).reshape(shape_xv),
            total_xv=np.asarray(g.TOTAL_XV).reshape(shape_xv),
            pertb_xv=np.asarray(g.PERTB_XV).reshape(shape_xv),
            markr_v=np.asarray(g.MARKR_V).reshape(shape_v),
            total_v=np.asarray(g.TOTAL_V).reshape(shape_v),
            pertb_v=np.asarray(g.PERTB_V).reshape(shape_v))
        w.write_snapshot(g.TIME, eng, np.asarray(g.MODE_RE), np.asarray(g.MODE_IM),
                         np.asarray(g.ELECTRIC), np.asarray(g.RHO), ptcl)
    produced = (tmp_path / "pic1dp.out").read_bytes()
    with open(g.FIXTURE, "rb") as fh:
        assert produced == fh.read()


def test_petsc_binary_round_trips_against_the_original(tmp_path):
    rng = np.random.default_rng(5)
    vec, ints, reals = rng.normal(size=17), [3, -1, 7], rng.normal(size=4)
    streams = []
    for pb in (tpb, jpb):
        fh = io.BytesIO()
        pb.write_int(fh, ints)
        pb.write_real(fh, reals)
        pb.write_vec(fh, vec)
        streams.append(fh.getvalue())
    assert streams[0] == streams[1]
    path = tmp_path / "stream.bin"
    path.write_bytes(streams[0])
    with open(path, "rb") as fh:
        np.testing.assert_array_equal(tpb.read_int(fh, 3), ints)
        np.testing.assert_array_equal(tpb.read_real(fh, 4), reals)
        np.testing.assert_array_equal(tpb.read_vec(fh), vec)
        with pytest.raises(EOFError):
            tpb.read_real(fh, 1)


def test_timers_report():
    t = PhaseTimers()
    with t.phase("step"):
        pass
    t.add("output", 0.5, count=2)
    lines = t.report().splitlines()
    assert lines[0] == "Info: timers:"
    assert [ln.split()[0] for ln in lines[2:]] == ["step", "output", "total"]
    assert t.seconds("output") == 0.5


def test_chip_smoke_dispersion_root():
    """chip_smoke.py holds gamma to a constant root; it must be the one the
    JAX package's kinetic dispersion solver gives for the default case."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    cfg = jcfg_mod.bump_on_tail_default()
    omega = Dispersion(species_for_config(cfg), 2.0 * np.pi / cfg.lx).solve_omega()
    assert abs(chip_smoke.BOT_OMEGA - omega) < 1e-4
