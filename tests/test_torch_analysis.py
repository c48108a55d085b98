"""The port's analysis tools against the JAX package's on the same
pic1dp.out: the golden fixture and a small run of the port on the CPU.
OutputData's arrays bit for bit, runinfo's and ptcldist's output text and
files byte for byte, the viewers headless, and every -m entry's --help."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import pic1dp_tpu_torch.config as tcfg
from _torch_port import CASES
from pic1dp_tpu.analysis import dispersion as j_disp
from pic1dp_tpu.analysis import output_data as j_od
from pic1dp_tpu.analysis import ptcldist as j_ptcl
from pic1dp_tpu.analysis import runinfo as j_runinfo
from pic1dp_tpu.analysis import visual as j_visual
from pic1dp_tpu.analysis import visual_dispersion as j_vdisp
from pic1dp_tpu_torch import Simulation
from pic1dp_tpu_torch.analysis import dispersion as t_disp
from pic1dp_tpu_torch.analysis import output_data as t_od
from pic1dp_tpu_torch.analysis import ptcldist as t_ptcl
from pic1dp_tpu_torch.analysis import runinfo as t_runinfo
from pic1dp_tpu_torch.analysis import visual as t_visual
from pic1dp_tpu_torch.analysis import visual_dispersion as t_vdisp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_pic1dp.out")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two species, two kept modes, a small port run on the CPU."""
    out = tmp_path_factory.mktemp("port_run")
    cfg = dataclasses.replace(CASES["two_species_maxwellian"](tcfg, "float64"),
                              modes=(1, 2), init_modes=(1,), time_max=2.0,
                              output_interval=0.5, nx_opd=16, nv_opd=16).validate()
    Simulation(cfg, out_path=str(out), device="cpu").run()
    return str(out)


@pytest.fixture(params=["golden", "port"])
def data_path(request, port_run):
    return GOLDEN if request.param == "golden" else port_run


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_output_data_equals_the_original(data_path):
    j, t = j_od.OutputData(data_path), t_od.OutputData(data_path)
    for name in ("nspecies", "nmode", "nx", "nv", "nx_pd", "nv_pd", "ntime", "lx", "v_max"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("mode", "x", "x_pd", "v_pd"):
        _same(getattr(t, name), getattr(j, name), name)
    _same(t.xv_pd, j.xv_pd, "xv_pd")
    _same(t.get_scalar_t(), j.get_scalar_t(), "scalar_t")
    _same(t.get_mode_t(), j.get_mode_t(), "mode_t")
    assert t.ntime >= 1
    for it in range(t.ntime):
        _same(t.get_field_x(it), j.get_field_x(it), f"field {it}")
        for s in range(t.nspecies + 1):
            for d in range(3):
                for periodic in (True, False):
                    _same(t.get_ptcldist_xv(it, s, d, periodic),
                          j.get_ptcldist_xv(it, s, d, periodic), f"xv {it} {s} {d}")
                _same(t.get_ptcldist_v(it, s, d), j.get_ptcldist_v(it, s, d), f"v {it} {s} {d}")
    if t.ntime < 2:
        return
    t_end = float(j.get_scalar_t()[0, -1])
    assert t.growthrate_energy_fit(0.0, t_end) == j.growthrate_energy_fit(0.0, t_end)
    assert t.findpeak_energy(0.0, t_end) == j.findpeak_energy(0.0, t_end)


def test_runinfo_prints_and_writes_as_the_original(data_path, port_run, tmp_path, capsys):
    # the golden file holds one snapshot, so it cannot be the reference run
    # (its time integral is 0): the port run is
    outputs = []
    for name, mod in (("jax", j_runinfo), ("port", t_runinfo)):
        wg = tmp_path / f"{name}.dat"
        mod.main(["-gr", "0", "2", "-sr", "0", "2", "-g", "2", "1", "-wg", str(wg),
                  port_run, data_path, port_run])
        text = capsys.readouterr().out.replace(str(wg), "<wg>")
        outputs.append((text, wg.read_bytes()))
    assert "growth rate =" in outputs[0][0] and "group 1 statistics" in outputs[0][0]
    assert outputs[1] == outputs[0]


@pytest.mark.parametrize("xv", [0, 1])
def test_ptcldist_prints_and_writes_as_the_original(data_path, xv, tmp_path, capsys):
    outputs = []
    for name, mod in (("jax", j_ptcl), ("port", t_ptcl)):
        out = tmp_path / name
        out.mkdir()
        mod.main([data_path, "-xv", str(xv), "-t", "-1", "-s", "0", "-d", "2", "-o", str(out)])
        files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        outputs.append((capsys.readouterr().out, files))
    assert len(outputs[0][1]) == (3 if xv == 0 else 2)
    assert outputs[1] == outputs[0]


def test_visual_app_headless(port_run):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    app = t_visual.VisualApp(port_run)
    app.itime = 2
    app.twindow = (0.5, 2.0)
    app.update_all()
    app._on_dist("total f")
    app._on_mode("mode 2")
    app._on_species("all")
    assert app.ispecies == 2
    plt.close(app.fig)


def test_visual_dispersion_headless():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    disp = t_disp.Dispersion([t_disp.Species(-1, 1, 1, 1, 0)], 0.5)
    ks = np.linspace(0.3, 0.6, 7)
    app = t_vdisp.VisualDispersion(disp, ks, disp.scan_k(ks))
    app._on_species("species 0")
    assert app.ispecies == 0
    plt.close(app.fig)


def test_dispersion_vis_branch_plots_what_the_original_plots(monkeypatch, capsys):
    """-vis hands the port's viewer the k scan the original hands its own;
    the viewer is then built headless from those arguments."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    shown = {}
    monkeypatch.setattr(j_vdisp, "show_dispersion",
                        lambda d, k, o: shown.setdefault("jax", (d.k, list(k), list(o))))
    monkeypatch.setattr(t_vdisp.VisualDispersion, "show",
                        lambda self: shown.setdefault("port", self))
    argv = ["-1", "1", "1", "1", "0", "-k", "0.4", "0.5", "-sks", "0.02", "-vis"]
    assert j_disp.main(argv) == 0
    assert t_disp.main(argv) == 0
    app = shown["port"]
    assert (app.disp.k, list(app.k_values), list(app.omegas)) == shown["jax"]
    text = capsys.readouterr().out
    assert text.count("k = ") == 2 * (1 + len(shown["jax"][1]))
    plt.close(app.fig)


def test_plots_need_matplotlib_as_the_originals_do(port_run, tmp_path, monkeypatch, capsys):
    """Without matplotlib, -vis and the viewers fail with the originals'
    ImportError (after ptcldist has written its files); nothing skips."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    errors = {}
    for name, (ptcl, visual, vdisp) in {"jax": (j_ptcl, j_visual, j_vdisp),
                                        "port": (t_ptcl, t_visual, t_vdisp)}.items():
        out = tmp_path / name
        out.mkdir()
        got = []
        for call in (lambda: ptcl.main([port_run, "-o", str(out), "-vis"]),
                     lambda: visual.VisualApp(port_run),
                     lambda: vdisp.VisualDispersion(None, [0.5], [1.0])):
            with pytest.raises(ImportError) as err:
                call()
            got.append((type(err.value), str(err.value)))
        assert sorted(os.listdir(out)) == ["ptcldist_xv.dat", "ptcldist_xv_v.dat",
                                           "ptcldist_xv_x.dat"]
        errors[name] = got
    capsys.readouterr()
    assert errors["port"] == errors["jax"]


TOOLS = ("runinfo", "ptcldist", "visual", "visual_dispersion", "dispersion")


@pytest.mark.parametrize("tool", TOOLS)
def test_module_entry_help(tool, capsys):
    proc = subprocess.run([sys.executable, "-m", f"pic1dp_tpu_torch.analysis.{tool}",
                           "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: ")
    helps = []
    for package in ("pic1dp_tpu", "pic1dp_tpu_torch"):
        mod = __import__(f"{package}.analysis.{tool}", fromlist=["main"])
        with pytest.raises(SystemExit) as done:
            mod.main(["--help"])
        assert done.value.code == 0
        helps.append(capsys.readouterr().out)
    assert helps[1] == helps[0]
