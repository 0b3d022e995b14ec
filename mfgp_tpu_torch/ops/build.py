"""Build and bind the port's CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds rather than minutes). The ``.cu`` files are compiled
by parallel ``nvcc -c`` processes, then linked. The tensor-core kernels
fetch the TMA encoder (``cuTensorMapEncodeTiled``) through the runtime, so
nothing links ``libcuda``. The library is built at first use into
``ops/.kernel_build/<hash>/`` (listed in ``.gitignore``), keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmfgp_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argument types; every one returns cudaError_t as int
_SIGNATURES = {
    # A, wA, B, wB, ils, noise, out, lo, ldo, L, N, M, F, D, kern, sym,
    # lane strides of A, wA, B, wB, ils, noise and out (lo), stream
    "mfgp_ar1_cov_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                         _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                         _P],
    # src, rows, cols, ld_src, transpose, hi, lo, ld_out, stream
    "mfgp_tf32_split_f32": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    # Linv, LinvT hi, lo, ldt, alpha, A, w, X, N, F, D, kern, kdiag, sv,
    # sv2, diagW, stream
    "mfgp_syrk_grad_f32": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P],
    # Linv hi, lo, ldl, S^T hi, lo, lds, alpha, N, Mb, mu, quad, stream
    "mfgp_posterior_f32": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
    # A hi, lo, lda, B hi, lo, ldb, Z, M, N, K, left, alpha, out, ldo, the
    # Z output offsets (host array), C^T hi, lo, ldp, stream
    "mfgp_tri_gemm_f32": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                          _P, _LL, _P, _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


CUDA_ROOTS = ("/usr/local/cuda",)  # searched after PATH and $CUDA_HOME


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``CUDA_ROOTS``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME, {', '.join(CUDA_ROOTS)}): the "
        "CUDA kernels cannot be built")


def build() -> Path:
    """Compile the sources if no library for their hash exists; return its
    path. Every ``.cu`` file is compiled by its own ``nvcc -c``, all started
    together, then linked. The compilers' reports (``-Xptxas -v``:
    registers, shared memory, spills per kernel) are kept beside the library
    as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    log = [" ".join(c) + "\n" + out for c, out in zip(cmds, outs)]
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    (out_dir / "build.log").write_text("".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(log)[-4000:])
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and return types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mfgp_error_string.argtypes = [ctypes.c_int]
        lib.mfgp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
