"""Batched tridiagonal solve in one launch: the wrapper of the CUDA kernel
``csrc/pcr.cu``.

Port of the JAX package's ``ops/pallas_tridiag.py::pallas_pcr_solve``, the
``method='pcr_fused'`` solver of :func:`.tridiag.tridiag_solve`: ``K``
systems of ``n`` rows, bands ``(n,)`` (shared) or ``(K, n)``, right-hand
side ``(K, n)``. The batched engine reaches it through its implicit solves
(the Classic ``Tg`` step) and the MIZ Newton inner solves.

:func:`pcr_fused` dispatches on the device of the right-hand side: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain version
:func:`.tridiag.pcr_solve`, whose operations the kernel repeats in the same
order (row scaling, ``safe_div``, identity rows out of range).
"""
from __future__ import annotations

import torch

from . import _build
from ._year import refuse_grad
from .tridiag import pcr_solve, pcr_steps

__all__ = ["pcr_fused", "MAX_N"]

# rows strided over at most 1024 threads, at most 4 per thread
MAX_N = 4096


def pcr_fused(lo, di, up, b):
    """Solve the ``(K, n)`` systems ``lo x[i-1] + di x[i] + up x[i+1] = b``
    (``lo[..., 0]`` and ``up[..., -1]`` are not read as couplings: the rows
    out of range are identity rows). On a CUDA device this launches the
    kernel (counted in ``pcr_fused.launches``); on the CPU it runs
    :func:`.tridiag.pcr_solve`."""
    if b.ndim != 2:
        raise ValueError(f"pcr_fused solves (K, n) systems, got rhs shape {tuple(b.shape)}")
    if b.device.type == "cpu":
        return pcr_solve(lo, di, up, b)
    if b.device.type != "cuda":
        raise ValueError(f"pcr_fused has no kernel for device {b.device}")
    refuse_grad("pcr_fused", lo, di, up, b)
    K, n = b.shape
    if n > MAX_N:
        raise ValueError(
            f"the pcr_fused kernel solves systems of at most {MAX_N} rows, got n={n}"
        )

    def band(v):
        """A band and its row stride: 0 for one row shared by every system."""
        v = torch.as_tensor(v, dtype=b.dtype, device=b.device)
        if v.ndim == 1 and v.shape[0] == n:
            return v.contiguous(), 0
        return v.expand(K, n).contiguous(), n

    (lo, s_lo), (di, s_di), (up, s_up) = band(lo), band(di), band(up)
    b = b.contiguous()
    x = torch.empty_like(b)
    _build.launch("ebm_pcr", b.dtype, b.device, lo.data_ptr(), di.data_ptr(),
                  up.data_ptr(), b.data_ptr(), x.data_ptr(), K, n, s_lo, s_di, s_up,
                  pcr_steps(n))
    pcr_fused.launches += 1
    return x


pcr_fused.launches = 0
