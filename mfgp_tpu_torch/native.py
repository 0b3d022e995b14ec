"""ctypes bindings of the repository's native CSV reader and writer
(counterpart of ``mfgp_tpu/native.py``).

The data pipeline reads large telemetry CSVs (36k-row estimate tables x 30
trajectories, GPRes grids); ``native/fastcsv.cpp`` parses and writes them
in C++. ``build()`` compiles that source with ``g++`` into the port's
git-ignored build directory (``mfgp_tpu_torch/.kernel_build/fastcsv-<hash>/``,
keyed by a hash of the source and flags), never into ``native/``, whose
``libfastcsv.so`` belongs to the JAX package's ``make``. Until it is built,
``load_csv`` and ``write_csv`` use NumPy, as the JAX package's do. Nothing
in the port calls ``build()`` on its own (no command, no import): build it
once with ``python -c "from mfgp_tpu_torch import native; native.build()"``
on a host with ``g++``. This is a host parser, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastcsv.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / ".kernel_build"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
LIB_NAME = "libfastcsv.so"
_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"fastcsv-{h.hexdigest()[:16]}" / LIB_NAME


def build(force: bool = False) -> bool:
    """Compile the library with ``g++`` unless it is built (or ``force``);
    returns whether it is available."""
    path = lib_path()
    if force or not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, path)  # atomic: concurrent builders race safely
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.is_file():
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.fastcsv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.fastcsv_dims.restype = ctypes.c_int
    lib.fastcsv_load.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int64]
    lib.fastcsv_load.restype = ctypes.c_int64
    lib.fastcsv_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int]
    lib.fastcsv_write.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def load_csv(path: str, skiprows: int = 1) -> np.ndarray:
    """Numeric CSV -> (rows, cols) float64 array. Native when built,
    numpy.loadtxt otherwise; identical results for well-formed files."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, delimiter=",", skiprows=skiprows, ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.fastcsv_dims(str(path).encode(), skiprows, ctypes.byref(rows),
                          ctypes.byref(cols))
    if rc != 0:
        raise FileNotFoundError(path)
    r, c = rows.value, cols.value
    out = np.empty(r * c, np.float64)
    n = lib.fastcsv_load(str(path).encode(), skiprows,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         r * c)
    if n != r * c:
        # ragged file: numpy's stricter parser raises the error
        return np.loadtxt(path, delimiter=",", skiprows=skiprows, ndmin=2)
    return out.reshape(r, c)


def write_csv(path: str, data: np.ndarray, header: str = "",
              precision: int = 17) -> None:
    """(rows, cols) array -> CSV with a header line, ``%.{precision}g``
    (17 digits round-trip float64 exactly)."""
    lib = _load()
    d = np.ascontiguousarray(np.atleast_2d(np.asarray(data, np.float64)))
    if lib is None:
        np.savetxt(path, d, delimiter=",", header=header, comments="")
        return
    rc = lib.fastcsv_write(str(path).encode(), header.encode(),
                           d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           d.shape[0], d.shape[1], precision)
    if rc != 0:
        raise OSError(f"fastcsv_write failed for {path}")
