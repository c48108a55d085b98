"""ctypes binding for the native multirand engines (multirand.cpp; the
port's copy of pic1dp_tpu/rng/native).

The shared library is built lazily with g++ on first use into the package's
build directory, pic1dp_tpu_torch/_build/libmultirand-<hash of the
source>.so, beside the CUDA kernels' libraries; everything degrades to the
pure-Python engines in pic1dp_tpu_torch.rng.multirand when no compiler is
available (`available()` tells which path you get, `build_error()` why).
Both implementations are bit-exact ports of the reference src/multirand.F90
and are cross-checked in tests/test_torch_multirand.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from pic1dp_tpu_torch.rng.multirand import MultiRand

_SRC = Path(__file__).resolve().parent / "multirand.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def library_path() -> Path:
    """Where the library built from the present source lies."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmultirand-{digest}.so"


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                BUILD_DIR.mkdir(exist_ok=True)
                # build under a private name, then rename: a concurrent
                # process sees either no library or a whole one
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                        check=True, capture_output=True, timeout=300)
                    os.replace(tmp, path)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(path))
            lib.mr_create.restype = ctypes.c_void_p
            lib.mr_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_long, ctypes.c_int]
            lib.mr_destroy.argtypes = [ctypes.c_void_p]
            lib.mr_int64.restype = ctypes.c_uint64
            lib.mr_int64.argtypes = [ctypes.c_void_p]
            for fn in (lib.mr_real_array, lib.mr_gaussian_array):
                fn.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_double), ctypes.c_long]
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            # no compiler, a failed build or an unloadable library: record it
            # and let make_multirand take the pure-Python engine
            _build_error = repr(e)
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


class NativeMultiRand:
    """Drop-in fast replacement for rng.multirand.MultiRand (loading subset:
    int64 / real_array / gaussian_array)."""

    def __init__(self, algorithm: int = 3, seed_type: int = 1,
                 mype: int | None = None, warmup: int = 5):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native multirand unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.mr_create(algorithm, seed_type,
                                -1 if mype is None else mype, warmup)
        if not self._h:
            raise ValueError(f"bad multirand algorithm {algorithm}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mr_destroy(self._h)
            self._h = None

    def int64(self) -> int:
        return int(self._lib.mr_int64(self._h))

    def _fill(self, fn, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        fn(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        return out

    def real_array(self, n: int) -> np.ndarray:
        return self._fill(self._lib.mr_real_array, n)

    def gaussian_array(self, n: int) -> np.ndarray:
        return self._fill(self._lib.mr_gaussian_array, n)


def make_multirand(algorithm: int = 3, seed_type: int = 1,
                   mype: int | None = None, warmup: int = 5,
                   selftest: bool = False):
    """Native engine when buildable, pure-Python otherwise.

    selftest=True (reference input_multirand_selftest,
    src/pic1dp_input.F90:228-233) runs the Python oracle's known-answer test
    AND, when the native engine is used, cross-checks its first draws against
    the oracle with identical seeding — catching both bad engine constants
    and a corrupted native build."""
    if selftest:
        errors = MultiRand(algorithm=algorithm, seed_type=1,
                           warmup=0).selftest()
        if errors:
            raise AssertionError(
                "multirand selftest failed: " + "; ".join(errors))
    if available():
        eng = NativeMultiRand(algorithm, seed_type, mype, warmup)
        if selftest and seed_type != 2:  # clock seeds are not reproducible
            oracle = MultiRand(algorithm=algorithm, seed_type=seed_type,
                               mype=mype, warmup=warmup)
            native_probe = NativeMultiRand(algorithm, seed_type, mype, warmup)
            got = [native_probe.int64() for _ in range(10)]
            want = [oracle.int64() for _ in range(10)]
            if got != want and seed_type == 1:
                raise AssertionError(
                    f"native multirand diverges from the Python oracle "
                    f"(algorithm {algorithm}): {got[:3]} != {want[:3]}")
        return eng
    return MultiRand(algorithm=algorithm, seed_type=seed_type, mype=mype,
                     warmup=warmup)
