"""The port stands alone: it imports neither jax nor the JAX package, nor
anything of the repository above it, and chip_smoke.py refuses to run
without a CUDA card instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pic1dp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports_in(tree: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def _imported_modules(path: Path) -> set[str]:
    return _imports_in(ast.parse(path.read_text(), filename=str(path)))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "pic1dp_tpu")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


PACKAGE = REPO / "pic1dp_tpu_torch"
SUBPACKAGES = ("analysis", "core", "examples", "io", "ops", "parallel", "probes", "rng", "utils")
TOP_LEVEL = ("__init__", "config", "distributions", "run")
# what sits beside the package in the repository: scripts, harnesses, tests
ABOVE = ("chip_smoke", "benchmark", "bench", "tests", "_chipcheck")


def _imports_with_scripts(path: Path) -> set[str]:
    """_imported_modules, and the imports of every string literal in the
    file that parses as Python (a script the module runs in another
    process)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = _imports_in(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "import" in node.value:
            try:
                names |= _imports_in(ast.parse(node.value))
            except SyntaxError:
                pass
    return names


@pytest.mark.parametrize("group", SUBPACKAGES + ("top-level",))
def test_package_imports_nothing_above_it(group):
    """No module of the package imports the repository's scripts,
    harnesses or tests, in its own code or in a script it runs."""
    if group == "top-level":
        files = sorted(PACKAGE.glob("*.py"))
        assert [p.stem for p in files] == sorted(TOP_LEVEL)
        assert {p.parent.name for p in PACKAGE.glob("*/__init__.py")} == set(SUBPACKAGES)
    else:
        files = sorted((PACKAGE / group).rglob("*.py"))
        assert files
    bad = {}
    for p in files:
        above = sorted(m for m in _imports_with_scripts(p) if m.split(".")[0] in ABOVE)
        if above:
            bad[str(p.relative_to(REPO))] = above
    assert not bad, f"modules import from above the package: {bad}"


def test_port_imports_without_jax_in_a_fresh_process():
    code = ("import sys, pic1dp_tpu_torch, pic1dp_tpu_torch.run, "
            "pic1dp_tpu_torch.ops.substep_kernels, pic1dp_tpu_torch.core.simulation, "
            "pic1dp_tpu_torch.ops.stream_probes, pic1dp_tpu_torch.probes.kernel_probe, "
            "pic1dp_tpu_torch.probes.pipeline_probe, pic1dp_tpu_torch.probes.compute_probe, "
            "pic1dp_tpu_torch.probes.overlap_probe, pic1dp_tpu_torch.probes.pingpong_probe, "
            "pic1dp_tpu_torch.analysis.dispersion, pic1dp_tpu_torch.core.optimize, "
            "pic1dp_tpu_torch.ops.shape_matrix, pic1dp_tpu_torch.ops.deposit, "
            "pic1dp_tpu_torch.ops.gather, pic1dp_tpu_torch.rng.multirand, "
            "pic1dp_tpu_torch.rng.native, pic1dp_tpu_torch.analysis.output_data, "
            "pic1dp_tpu_torch.analysis.runinfo, pic1dp_tpu_torch.analysis.ptcldist, "
            "pic1dp_tpu_torch.analysis.visual, pic1dp_tpu_torch.analysis.visual_dispersion, "
            "pic1dp_tpu_torch.examples.bump_on_tail_pre83, "
            "pic1dp_tpu_torch.examples.landau_damping, pic1dp_tpu_torch.examples.two_stream, "
            "pic1dp_tpu_torch.examples.ion_acoustic, pic1dp_tpu_torch.parallel.mesh, "
            "pic1dp_tpu_torch.parallel.launch, pic1dp_tpu_torch.ops.hist_kernels; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pic1dp_tpu')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_new_modules_are_among_the_checked_files():
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"pic1dp_tpu_torch/rng/__init__.py", "pic1dp_tpu_torch/rng/multirand.py",
            "pic1dp_tpu_torch/rng/native/__init__.py", "pic1dp_tpu_torch/core/optimize.py",
            "pic1dp_tpu_torch/ops/shape_matrix.py", "pic1dp_tpu_torch/ops/deposit.py",
            "pic1dp_tpu_torch/ops/gather.py"} <= checked
    analysis = {f"pic1dp_tpu_torch/analysis/{m}.py" for m in (
        "output_data", "runinfo", "ptcldist", "visual", "visual_dispersion")}
    examples = {f"pic1dp_tpu_torch/examples/{m}.py" for m in (
        "__init__", "bump_on_tail_pre83", "landau_damping", "two_stream", "ion_acoustic")}
    parallel = {f"pic1dp_tpu_torch/parallel/{m}.py" for m in ("__init__", "mesh", "launch")}
    assert analysis | examples | parallel | {"pic1dp_tpu_torch/ops/hist_kernels.py"} <= checked


def _no_cuda_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_no_cuda_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the checkout beside it the script must fail too."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_no_cuda_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
