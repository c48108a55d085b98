"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Top-level module names are compared
whole: the port's name, pic1dp_tpu_torch, begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pic1dp_tpu"}
HARNESS = ["benchmark.run", "benchmark.session", "benchmark.spec", "benchmark.check",
           "benchmark.trace", "benchmark.yardstick", "benchmark.outfile", "benchmark.markers",
           "benchmark.reference.deltaf_spectral"]
REFERENCE = ["benchmark.reference.deltaf_spectral", "benchmark.check", "benchmark.outfile",
             "benchmark.markers", "benchmark.yardstick"]


def _top_level_after_import(modules, extra=""):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in modules) + extra +
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    # the harness, every metric reader and the program's run path
    readers = "".join(f"spec.metric_reader({m['name']!r})\n" for m in
                      spec.load()["end_to_end"] + spec.load()["per_layer"])
    loaded = _top_level_after_import(
        HARNESS + ["pic1dp_tpu_torch.core.simulation", "pic1dp_tpu_torch.parallel.mesh"],
        "from benchmark import spec\n" + readers)
    assert "pic1dp_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after_import(REFERENCE)
    assert "pic1dp_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_no_source_of_the_benchmark_imports_jax():
    for path in sorted(spec.HERE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)
