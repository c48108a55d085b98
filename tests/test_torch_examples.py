"""The port's example scripts (pic1dp_tpu_torch/examples/) against the JAX
package's (examples/): the same Config, and one small run of each on the
CPU that ends with a finite fitted rate (its value is not checked: a few
thousand markers are too noisy for the originals' tolerances)."""

import importlib.util
import math
import os
import re

import pytest

from pic1dp_tpu_torch.examples import bump_on_tail_pre83, ion_acoustic, landau_damping, two_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def _original_config(name, monkeypatch, argv=(), env=None):
    """The Config the original example hands Simulation, caught before it
    runs."""
    spec = importlib.util.spec_from_file_location(
        f"original_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    caught = []

    def simulation(cfg, *args, **kwargs):
        caught.append(cfg)
        raise _Stop

    monkeypatch.setattr(module, "Simulation", simulation)
    monkeypatch.setattr("sys.argv", [f"{name}.py", *argv])
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    with pytest.raises(_Stop):
        module.main()
    return caught[0]


CONFIGS = {
    "bump_default": ("bump_on_tail_pre83", (), None,
                     lambda: bump_on_tail_pre83.config()),
    "bump_full_width": ("bump_on_tail_pre83", ("6400000", "100"), None,
                        lambda: bump_on_tail_pre83.config(6_400_000, 100.0)),
    "bump_rounded": ("bump_on_tail_pre83", ("5000", "30"), None,
                     lambda: bump_on_tail_pre83.config(5000, 30.0)),
    "landau": ("landau_damping", (), None, lambda: landau_damping.config()),
    "two_stream": ("two_stream", (), None, lambda: two_stream.config(device="cpu")),
    "two_stream_env": ("two_stream", (), {"PIC1DP_EX_N": "3e5", "PIC1DP_EX_TMAX": "40"},
                       lambda: two_stream.config(300_000, 40.0, device="cpu")),
    "ion_acoustic": ("ion_acoustic", (), None, lambda: ion_acoustic.config(device="cpu")),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_equals_the_original(case, monkeypatch):
    name, argv, env, port = CONFIGS[case]
    original = _original_config(name, monkeypatch, argv, env)
    assert port().to_dict() == original.to_dict()


RUNS = {
    "bump_on_tail_pre83": (bump_on_tail_pre83, ["4096", "32"], "simulated gamma"),
    "landau_damping": (landau_damping, ["--nparticle", "4096", "--time-max", "16"],
                       "simulated gamma"),
    "two_stream": (two_stream, ["--nparticle", "4096", "--time-max", "40"],
                   "simulated gamma"),
    "ion_acoustic": (ion_acoustic, ["--nparticle", "4096", "--time-max", "70"],
                     "measured:       omega"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_small_cpu_run_reports_a_rate(name, capsys):
    module, argv, line = RUNS[name]
    rc = module.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc in (0, 1), out
    found = [ln for ln in out.splitlines() if ln.startswith(line)]
    assert found, out
    rate = float(re.search(r"gamma = (-?[0-9.e+-]+)", found[0]).group(1))
    assert math.isfinite(rate)
