"""The port stands alone: it imports neither jax nor the JAX package, and
chip_smoke.py refuses to run without a CUDA card instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pic1dp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "pic1dp_tpu")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


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
