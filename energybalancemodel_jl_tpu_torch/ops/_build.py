"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain C
interface, at first use, into ``_build/`` beside the package (the directory
is git-ignored). The library's name carries a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. The library is loaded
with :mod:`ctypes`; pointers and the CUDA stream pass as ``c_void_p``. No
PyTorch headers are compiled, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["load_library", "build_log", "launch", "launch_raw", "count", "NVCC_FLAGS"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -fmad=false: no contraction of a*b+c into one fused multiply-add that the
# source does not ask for. XLA:CPU contracts the JAX reference's a*b+c where
# product and sum share a fused loop (utils/numerics.py lists the sites);
# the plain PyTorch version makes exactly those fused multiply-adds
# (utils.numerics.fma) and the kernels write them as __fmaf_rn / __fma_rn,
# so a kernel rounds where its plain version does. The MIZ year amplifies a
# difference of one rounding by ~1e5 over a year (measured, PERF.md)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# name -> (argtypes, restype) of every exported C entry point
_SIGNATURES = {
    # (cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters, raw,
    #  noise, keys, ou, eta_out, cross, cross_out, wts, ws,
    #  K, nx, nt, w0, s0, pcr_steps, max_iter, ou_mode, ou_unroll, ws_words, ws_blocks,
    #  force_c, dt, abstol, reltol, max_step, stream)
    "ebm_miz_year_f32": ([_P] * 20 + [_I] * 12 + [_D] * 4 + [_P], _I),
    "ebm_miz_year_f64": ([_P] * 20 + [_I] * 12 + [_D] * 4 + [_P], _I),
    # the cluster build's plan: (nx, nt, K, noisy, ou_mode, count, force_c, out[5])
    "ebm_miz_year_plan_f32": ([_I] * 7 + [_P], _I),
    "ebm_miz_year_plan_f64": ([_I] * 7 + [_P], _I),
    # (cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
    #  noise, keys, ou, eta_out, cross, cross_out, wts, ws,
    #  K, nx, nt, w0, s0, pcr_steps, ou_mode, ou_unroll, warp_min_k, ws_words, ws_blocks,
    #  force_c, dt, stream)
    "ebm_classic_year_f32": ([_P] * 18 + [_I] * 12 + [_D] + [_P], _I),
    "ebm_classic_year_f64": ([_P] * 18 + [_I] * 12 + [_D] + [_P], _I),
    # the cluster build's plan: (nx, nt, K, noisy, ou_mode, force_c, out[5])
    "ebm_classic_year_plan_f32": ([_I] * 6 + [_P], _I),
    "ebm_classic_year_plan_f64": ([_I] * 6 + [_P], _I),
    # (keys, out, K, nt, stream) and (bits, out, n, stream)
    "ebm_normal_table": ([_P] * 2 + [_I] * 2 + [_P], _I),
    "ebm_normal_bits": ([_P] * 2 + [_I] + [_P], _I),
    # (lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride, steps, force_c,
    #  stream)
    "ebm_pcr_f32": ([_P] * 5 + [_I] * 7 + [_P], _I),
    "ebm_pcr_f64": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # the cluster build's plan: (n, K, force_c, out[5])
    "ebm_pcr_plan_f32": ([_I] * 3 + [_P], _I),
    "ebm_pcr_plan_f64": ([_I] * 3 + [_P], _I),
    # (T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters, steps,
    #  ws_words, ws_blocks, force_c, stream)
    "ebm_newton_t0_f32": ([_P] * 10 + [_I] * 7 + [_P], _I),
    "ebm_newton_t0_f64": ([_P] * 10 + [_I] * 7 + [_P], _I),
    # the cluster build's plan: (n, K, force_c, out[5])
    "ebm_newton_t0_plan_f32": ([_I] * 3 + [_P], _I),
    "ebm_newton_t0_plan_f64": ([_I] * 3 + [_P], _I),
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


def _sources(csrc: Path = CSRC_DIR):
    """The compiled sources, ``csrc/*.cu``."""
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return sources


def _library_path(csrc: Path = CSRC_DIR) -> Path:
    """The library built from ``csrc``: its name hashes the flags and every
    source and header (``*.cu``, ``*.cuh``), names and bytes."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libebm_kernels_{h.hexdigest()[:16]}.so"


def _build(sources, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: concurrent first uses
    # (several test processes) never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        # one nvcc per source, all at once; every process is waited for
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        outputs = [p.communicate() for p in procs]
        failed = [f"nvcc failed on {src.name} (exit {p.returncode}):\n{out}\n{err}"
                  for src, p, (out, err) in zip(sources, procs, outputs) if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        log = [f"== {src.name}\n{out}{err}" for src, (out, err) in zip(sources, outputs)]
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        target.with_suffix(".log").write_text("".join(log))
        os.replace(lib, target)


# the shards of a mesh (parallel/mesh.py) launch from threads of their own:
# one lock for the first build and one for the launch counts
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    target = _library_path()
    with _BUILD_LOCK:
        if not target.exists():
            _build(_sources(), target)
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
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.ebm_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")


def count(wrapper, counter: str = "launches", n: int = 1) -> None:
    """Add ``n`` to ``wrapper.<counter>``, by default one to
    ``wrapper.launches``, the launch count of a kernel wrapper; safe against
    the concurrent launches of a mesh's shards."""
    with _COUNT_LOCK:
        setattr(wrapper, counter, getattr(wrapper, counter) + n)


def launch(name: str, dtype: torch.dtype, device, *args) -> None:
    """Call the C entry point ``{name}_f32`` or ``{name}_f64`` (by ``dtype``)
    with ``args`` and the current CUDA stream of ``device``; raise if the
    launch was refused."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise ValueError(f"the {name} kernel takes float32 or float64, got {dtype}")
    launch_raw(f"{name}_{suffix}", device, *args)


def launch_raw(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current CUDA
    stream of ``device``; raise if the launch was refused."""
    lib = load_library()
    fn = getattr(lib, name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err)
