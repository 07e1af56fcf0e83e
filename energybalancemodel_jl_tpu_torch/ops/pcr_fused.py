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
from ._year import FORCE_CLUSTER, WIDE, check_width, cluster_plan, refuse_grad
from .tridiag import pcr_solve, pcr_steps

__all__ = ["pcr_fused", "MAX_N"]

# up to 4096 rows in shared memory (at most 4 per thread of 1024), above
# that the cluster build (each system's rows across the shared memory of a
# thread-block cluster)
MAX_N = WIDE["pcr_fused"]["max"]


def pcr_fused(lo, di, up, b):
    """Solve the ``(K, n)`` systems ``lo x[i-1] + di x[i] + up x[i+1] = b``
    (``lo[..., 0]`` and ``up[..., -1]`` are not read as couplings: the rows
    out of range are identity rows). On a CUDA device this launches the
    kernel (counted in ``pcr_fused.launches``; above n = 4096 its cluster
    build as the C side plans it, up to ``MAX_N`` rows, raising
    ``RuntimeError`` where no plan can launch); on the CPU it runs
    :func:`.tridiag.pcr_solve`."""
    if b.ndim != 2:
        raise ValueError(f"pcr_fused solves (K, n) systems, got rhs shape {tuple(b.shape)}")
    if b.device.type == "cpu":
        return pcr_solve(lo, di, up, b)
    if b.device.type != "cuda":
        raise ValueError(f"pcr_fused has no kernel for device {b.device}")
    refuse_grad("pcr_fused", lo, di, up, b)
    K, n = b.shape
    check_width("pcr_fused", n)

    def band(v):
        """A band and its row stride: 0 for one row shared by every system."""
        v = torch.as_tensor(v, dtype=b.dtype, device=b.device)
        if v.ndim == 1 and v.shape[0] == n:
            return v.contiguous(), 0
        return v.expand(K, n).contiguous(), n

    (lo, s_lo), (di, s_di), (up, s_up) = band(lo), band(di), band(up)
    b = b.contiguous()
    x = torch.empty_like(b)
    if n > WIDE["pcr_fused"]["narrow"]:
        cluster_plan("pcr_fused", n, 1, K, b.dtype, b.device)  # raises where none launches
    _build.launch("ebm_pcr", b.dtype, b.device, lo.data_ptr(), di.data_ptr(),
                  up.data_ptr(), b.data_ptr(), x.data_ptr(), K, n, s_lo, s_di, s_up,
                  pcr_steps(n), FORCE_CLUSTER["pcr_fused"])
    _build.count(pcr_fused)
    return x


pcr_fused.launches = 0
