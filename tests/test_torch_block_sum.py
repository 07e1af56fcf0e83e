"""The fixed-order sum of the crossing area (``ops/_year.py::block_sum``),
on the CPU.

The year kernels sum a member's cells in one fixed order
(``csrc/noise.cuh::noise_crossing``): a thread adds its own cells in cell
order, a warp's 32 lanes add in a halving tree, thread 0 adds the warps'
sums in warp order. ``block_sum`` is that order in plain PyTorch, so kernel
and plain version agree bit for bit. Bars:

- against a scalar emulation of the block, thread by thread: bitwise, at
  every shape class (one cell, around a warp, the canonical 180, 1024, and
  the 2- and 4-cells-per-thread layouts);
- against ``torch.sum`` and a float64 sum: ``(5 + warps + cells per thread)
  * eps * sum |v|``, the first-order bound of the tree's depth;
- members are summed independently: any chunking of the batch, and a
  non-contiguous view, give the same bits.
"""
import numpy as np
import pytest
import torch

from energybalancemodel_jl_tpu_torch.ops import _year

SHAPES = [1, 2, 31, 32, 33, 180, 1024, 1025, 2048, 2049, 4096]


def emulate_block(v):
    """One member's sum as the block computes it, in scalar arithmetic of
    ``v``'s dtype."""
    n = v.shape[0]
    cpt, threads = _year.block_layout(n)
    zero = v.dtype.type(0)
    part = []
    for t in range(threads):
        acc = v[t] if t < n else zero
        for c in range(1, cpt):
            i = t + c * threads
            acc = acc + (v[i] if i < n else zero)
        part.append(acc)
    warps = []
    for w in range(threads // 32):
        lanes = part[32 * w:32 * w + 32]
        for half in (16, 8, 4, 2, 1):
            lanes = [lanes[l] + lanes[l + half] for l in range(half)]
        warps.append(lanes[0])
    total = warps[0]
    for s in warps[1:]:
        total = total + s
    return total


@pytest.mark.parametrize("n", SHAPES)
def test_block_layout_matches_the_kernels(n):
    cpt, threads = _year.block_layout(n)
    assert cpt == (1 if n <= 1024 else 2 if n <= 2048 else 4)
    assert threads % 32 == 0 and threads <= 1024
    assert cpt * threads >= n > cpt * (threads - 32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", SHAPES)
def test_block_sum_is_the_block_order_bitwise(n, dtype):
    rng = np.random.default_rng(n)
    v = (rng.normal(size=(3, n)) * 10.0 ** rng.integers(-3, 4, size=(3, n))).astype(dtype)
    got = _year.block_sum(torch.as_tensor(v)).numpy()
    want = np.array([emulate_block(row) for row in v], dtype)
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SHAPES)
def test_block_sum_against_torch_sum_and_float64(n, dtype):
    g = torch.Generator().manual_seed(n)
    v = torch.randn(7, n, generator=g, dtype=torch.float64).to(dtype)
    got = _year.block_sum(v).double()
    cpt, threads = _year.block_layout(n)
    bound = (5 + threads // 32 + cpt) * torch.finfo(dtype).eps * v.double().abs().sum(-1)
    assert bool(((got - v.double().sum(-1)).abs() <= bound).all())
    assert bool(((got - v.sum(-1).double()).abs() <= 2 * bound).all())


def test_block_sum_members_are_independent_of_chunking():
    g = torch.Generator().manual_seed(0)
    v = torch.randn(24, 180, generator=g)
    whole = _year.block_sum(v)
    for sizes in ((24,), (1,) * 24, (5, 7, 12), (12, 7, 5), (23, 1)):
        parts = torch.cat([_year.block_sum(c) for c in torch.split(v, sizes)])
        assert torch.equal(parts, whole), sizes
    assert torch.equal(_year.block_sum(v.t().contiguous().t()), whole)
    assert torch.equal(_year.block_sum(v[0]), whole[0])  # a single member, no batch axis


def test_block_sum_counts_signed_zeros_like_the_block():
    """Cells beyond the grid count as +0: a row of -0 sums to +0 when the
    block has lanes beyond the grid (180 cells on 192 threads), and keeps -0
    when it has none (32 cells)."""
    assert not torch.signbit(_year.block_sum(torch.full((1, 180), -0.0)))[0]
    assert torch.signbit(_year.block_sum(torch.full((1, 32), -0.0)))[0]


def test_crossing_tracker_area_is_the_block_sum():
    import energybalancemodel_jl_tpu_torch as ebt

    st = ebt.SpaceTime.sin(40, 200, 1)
    K = 4
    tracker = _year.CrossingTracker("MIZ", (0.3, 1.0), st, K, torch.float32, "cpu")
    g = torch.Generator().manual_seed(1)
    phi = torch.rand(K, st.nx, generator=g)
    phi[0, 3] = float("nan")  # counted as 0
    tracker(5, {"phi": phi})
    area = _year.block_sum(tracker.w * torch.nan_to_num(phi, nan=0.0))
    assert torch.equal(tracker.first, torch.where(area - 0.3 > 0, 5.0, -1.0))
