"""Build a CUDA source of the package with nvcc and load it with ctypes.

A source `pic1dp_tpu_torch/csrc/<name>.cu` exports a plain C interface (no
PyTorch headers, so it builds in seconds), including `const char*
pic1dp_error_string(int)` for its launch errors.  It is compiled at first
use into `pic1dp_tpu_torch/_build/<name>-<hash>.so`, where the hash covers
the source, every header (`*.cuh`) beside it and the flags: an edit to any of
them rebuilds, and unchanged files load the library already built.  Nothing
is compiled when a module is imported.
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
# sm_90a: Hopper with its architecture-specific features; -Xptxas=-v prints
# each kernel's registers and spills into the build log; --split-compile=0
# optimizes a source's kernels in parallel on every core (the substep
# source's ~130 instantiations build in about half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--split-compile=0")


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


def build_hash(src: Path) -> str:
    """Hash of what a build of `src` depends on: its bytes, the name and
    bytes of every header in its directory, and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _paths(name: str) -> tuple[Path, Path]:
    src = PACKAGE_DIR / "csrc" / f"{name}.cu"
    return src, BUILD_DIR / f"{name}-{build_hash(src)}.so"


def load_all(names) -> list[Library]:
    """Build (where needed) and load csrc/<name>.cu for each name; one load
    per process.  The sources that need a build are compiled together, one
    nvcc process each, all started at once."""
    jobs = {}
    for name in dict.fromkeys(names):
        if name in _loaded:
            continue
        src, path = _paths(name)
        if path.exists():
            _loaded[name] = Library(ctypes.CDLL(str(path)), path, 0.0, "")
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        # build under a private name, then rename: a concurrent process sees
        # either no library or a whole one
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs[name] = (src, path, tmp, proc, time.perf_counter())
    failed = []
    for name, (src, path, tmp, proc, start) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
            continue
        os.replace(tmp, path)
        _loaded[name] = Library(ctypes.CDLL(str(path)), path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_loaded[name] for name in names]


def load(name: str) -> Library:
    """Build (if needed) and load csrc/<name>.cu; one load per process."""
    return load_all([name])[0]


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (queried once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


@dataclasses.dataclass
class CudaKernel:
    """A hand-written kernel, the TPU kernel it replaces, and the number of
    times its wrapper has launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0

    def launched(self, rc: int, lib: ctypes.CDLL) -> None:
        """Count a launch whose C entry point returned rc (a cudaError_t);
        raise instead if the launch failed."""
        if rc != 0:
            msg = lib.pic1dp_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({rc})")
        self.launches += 1
