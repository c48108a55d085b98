"""Minimal PETSc binary-viewer format support (no PETSc dependency).

The reference writes its science-data stream `pic1dp.out` with
PetscViewerBinaryOpen/WriteInt/WriteReal/WriteScalar and VecView
(reference src/pic1dp_output.F90:68-92, :173-187, :456-474).  The on-disk
format, as consumed by the reference's own reader
(tools/XPetscBinaryIO.py:23-71, tools/OutputData.py:28-79), is:

  * WriteInt    -> raw big-endian int32 array
  * WriteReal / WriteScalar -> raw big-endian float64 array
  * VecView     -> int32 classid (1211214) + int32 length + float64 data

This module reads and writes exactly that, so output produced here is
readable by the reference's tools and vice versa.
"""

from __future__ import annotations

import io
from typing import BinaryIO

import numpy as np

VEC_FILE_CLASSID = 1211214  # PETSc VEC_FILE_CLASSID


def write_int(fh: BinaryIO, values) -> None:
    fh.write(np.asarray(values, dtype=">i4").tobytes())


def write_real(fh: BinaryIO, values) -> None:
    fh.write(np.asarray(values, dtype=">f8").tobytes())


def write_vec(fh: BinaryIO, values) -> None:
    arr = np.asarray(values, dtype=">f8")
    write_int(fh, [VEC_FILE_CLASSID, arr.size])
    fh.write(arr.tobytes())


def read_int(fh: BinaryIO, n: int) -> np.ndarray:
    arr = np.fromfile(fh, dtype=">i4", count=n)
    if arr.size < n:
        raise EOFError("unexpected EOF reading ints")
    return arr.astype(np.int64)


def read_real(fh: BinaryIO, n: int) -> np.ndarray:
    arr = np.fromfile(fh, dtype=">f8", count=n)
    if arr.size < n:
        raise EOFError("unexpected EOF reading reals")
    return arr.astype(np.float64)


def read_vec(fh: BinaryIO) -> np.ndarray:
    classid, n = read_int(fh, 2)
    if classid != VEC_FILE_CLASSID:
        raise ValueError(f"expected Vec classid {VEC_FILE_CLASSID}, got {classid}")
    return read_real(fh, int(n))
