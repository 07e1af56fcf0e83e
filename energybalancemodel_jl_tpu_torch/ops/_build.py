"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library with
a plain C interface, at first use, into ``_build/`` beside the package (the
directory is git-ignored). The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded. The library is loaded with :mod:`ctypes`; pointers and the CUDA
stream pass as ``c_void_p``. No PyTorch headers are compiled, which keeps a
build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "build_log", "NVCC_FLAGS"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -fmad=false: no contraction of a*b+c into one fused multiply-add, so the
# kernel rounds every operation where the plain PyTorch version (one kernel
# per operation) and the JAX reference do; the MIZ year amplifies that
# difference by ~1e5 over a year (measured, PERF.md)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# name -> (argtypes, restype) of every exported C entry point
_SIGNATURES = {
    # (cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, raw,
    #  K, nx, nt, w0, s0, pcr_steps, max_iter,
    #  dt, abstol, reltol, max_step, stream)
    "ebm_miz_year_f32": ([_P] * 11 + [_I] * 7 + [_D] * 4 + [_P], _I),
    "ebm_miz_year_f64": ([_P] * 11 + [_I] * 7 + [_D] * 4 + [_P], _I),
    "ebm_cuda_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "energybalancemodel_jl_tpu_torch are built from source at first use"
    )


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def _library_path(sources) -> Path:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libebm_kernels_{h.hexdigest()[:16]}.so"


def _build(sources, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent first uses (several
    # test processes) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = _sources()
    target = _library_path(sources)
    if not target.exists():
        _build(sources, target)
    lib = ctypes.CDLL(str(target))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) for the library :func:`load_library` loads, or ""
    when it was built by another process that left no log."""
    log = _library_path(_sources()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.ebm_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
