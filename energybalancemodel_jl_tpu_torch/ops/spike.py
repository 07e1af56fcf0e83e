"""Distributed tridiagonal solver (SPIKE) for grids sharded over a mesh axis.

Port of the JAX package's ``ops/spike.py``. With the line split into P
contiguous blocks of m rows, each shard solves three systems against its own
block ``A_j``::

    A_j g = d_local          (particular solution)
    A_j v = b_j e_1          (left coupling spike,  b_j = lo[first])
    A_j w = c_j e_m          (right coupling spike, c_j = up[last])

so that ``x_j = g - v y_left - w y_right``, where ``y`` are the 2P interface
unknowns (the first and last entry of every block). Every shard assembles the
small ``2P x 2P`` interface system from an ``all_gather`` of six scalars per
shard and solves it densely: one collective per solve. The local solves are
the port's plain :func:`.tridiag.pcr_solve`, the three right-hand sides
batched, as in the JAX package (which calls its ``pcr_solve``, not a Pallas
kernel).
"""
from __future__ import annotations

import torch

from .tridiag import pcr_solve

__all__ = ["spike_tridiag_solve"]


def spike_tridiag_solve(lo, di, up, b, axis_name: str):
    """Solve a global tridiagonal system whose bands and right-hand side are
    sharded along the last axis over the mesh axis ``axis_name`` (call
    inside :func:`..parallel.mesh.shard_map`).

    ``lo/di/up/b`` are this shard's blocks, shape ``(..., m)`` (the bands may
    broadcast against ``b``); ``lo`` of the first global row and ``up`` of
    the last must be 0. The couplings to the neighbouring blocks are the
    block's own first ``lo`` and last ``up`` entries. Returns this shard's
    block of the solution.
    """
    from ..parallel.mesh import all_gather, axis_index, axis_size

    P = axis_size(axis_name)
    j = axis_index(axis_name)
    batch = b.shape[:-1]

    b_cpl = lo[..., :1]  # coupling to the previous block's last unknown
    c_cpl = up[..., -1:]  # coupling to the next block's first unknown
    # interior bands: the couplings zeroed, so the local system is closed
    lo_l = torch.cat([torch.zeros_like(b_cpl), lo[..., 1:]], dim=-1)
    up_l = torch.cat([up[..., :-1], torch.zeros_like(c_cpl)], dim=-1)

    # three local solves with shared bands: [particular | left | right spike]
    e1 = torch.zeros_like(b)
    e1[..., 0] = 1.0
    em = torch.zeros_like(b)
    em[..., -1] = 1.0
    rhs = torch.stack([b, (b_cpl * e1).expand(b.shape), (c_cpl * em).expand(b.shape)], dim=-2)
    sol = pcr_solve(lo_l[..., None, :], di[..., None, :], up_l[..., None, :], rhs)
    g, v, w = sol[..., 0, :], sol[..., 1, :], sol[..., 2, :]

    # interface unknowns y = [x_first^0, x_last^0, ..., x_first^{P-1}, x_last^{P-1}]:
    #   x_first = g[0]   - v[0]   y_prev_last - w[0]   y_next_first
    #   x_last  = g[m-1] - v[m-1] y_prev_last - w[m-1] y_next_first
    mine = torch.stack([g[..., 0], g[..., -1], v[..., 0], v[..., -1], w[..., 0], w[..., -1]],
                       dim=-1)  # (..., 6)
    allq = torch.movedim(all_gather(mine, axis_name), 0, -2)  # (..., P, 6)
    g0, gm, v0, vm, w0, wm = (allq[..., i] for i in range(6))

    n2 = 2 * P
    M = torch.eye(n2, dtype=b.dtype, device=b.device).expand(batch + (n2, n2)).clone()
    first = 2 * torch.arange(P, device=b.device)
    last = first + 1
    M[..., first[1:], last[:-1]] += v0[..., 1:]
    M[..., last[1:], last[:-1]] += vm[..., 1:]
    M[..., first[:-1], first[1:]] += w0[..., :-1]
    M[..., last[:-1], first[1:]] += wm[..., :-1]
    rhs_y = torch.stack([g0, gm], dim=-1).reshape(batch + (n2,))
    y = torch.linalg.solve(M, rhs_y[..., None])[..., 0]

    zero = torch.zeros_like(y[..., 0])
    y_prev_last = y[..., 2 * j - 1] if j > 0 else zero
    y_next_first = y[..., 2 * j + 2] if j < P - 1 else zero
    return g - v * y_prev_last[..., None] - w * y_next_first[..., None]
