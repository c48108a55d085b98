"""Build a CUDA source of the package with nvcc and load it with ctypes.

A source `pic1dp_tpu_torch/csrc/<name>.cu` exports a plain C interface (no
PyTorch headers, so it builds in seconds).  It is compiled at first use into
`pic1dp_tpu_torch/_build/<name>-<hash>.so`, where the hash covers the source
and the flags: an edit rebuilds, and an unchanged source loads the library
already built.  Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
# sm_90a: Hopper with its architecture-specific features; -Xptxas=-v prints
# each kernel's registers and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclasses.dataclass
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was loaded
    log: str               # nvcc's output ("" when nothing was built)


_loaded: dict[str, Library] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels of pic1dp_tpu_torch are built from source")


def load(name: str) -> Library:
    """Build (if needed) and load csrc/<name>.cu; one load per process."""
    if name in _loaded:
        return _loaded[name]
    src = PACKAGE_DIR / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        # build under a private name, then rename: a concurrent process sees
        # either no library or a whole one
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
        os.replace(tmp, path)
    _loaded[name] = Library(ctypes.CDLL(str(path)), path, seconds, log)
    return _loaded[name]
