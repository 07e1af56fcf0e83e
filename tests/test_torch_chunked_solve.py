"""The chunked (hybrid Thomas-PCR) tridiagonal solve, ``ops/tridiag.py::
chunked_solve``, which the Classic year kernel's cluster build runs above
4096 cells (``csrc/classic_year.cu``), on the CPU (~25 s alone, 16 s of it
the two JAX years):

- on the Tg systems of a Classic step (an ice cap, so the masked diagonal
  varies) at nx = 4352, 8192 and 32768: its error against an
  extended-precision Thomas solve within twice the larger of
  ``thomas_solve``'s and ``pcr_solve``'s, and its normwise backward error
  below ``pcr_solve``'s, in float64 and float32. Measured (float64, forward,
  chunked / Thomas / PCR): 1.8e-13 / 1.4e-13 / 1.8e-13 at 4352, 4.2e-12 /
  1.4e-12 / 5.1e-12 at 32768; backward 1.3e-13 against PCR's 9.9e-13 at
  32768. The systems' condition grows with nx^2, so no fixed bar on the
  solvers' differences holds at every width: PCR and Thomas themselves
  differ by 2.8e-13 to 6.1e-12 (float64) and 7.8e-5 to 3.2e-2 (float32);
- edge shapes: widths that are no multiple of the chunk, identity rows at
  both ends, and a zero pivot anywhere in a chunk giving 0, as an identity
  row would (Thomas on that system, 1e-13);
- the cluster build's layout, rank by rank for C = 2 to 16: every slice is
  whole chunks, each chunk's two interface rows lie on its own rank and the
  kernel's multiply-high finds that rank, and the workspace counts the
  rounded slice;
- ``classic_year_reference`` at ``SpaceTime.sin(8192, 1000, 1)`` from the
  warm init against the JAX package's scan engine: within four times the
  difference between the JAX package's own PCR and Thomas years. The bar of
  ``test_torch_highres.py::test_classic_year_at_nx_8192_matches_jax``
  (1e-9) holds only for the same arithmetic: at the ice edge a year
  amplifies a solve's last bits, and the JAX package's two solvers differ
  there by 3.05e-8, the chunked year by 7.19e-8 (PCR) and 4.14e-8 (Thomas);
- the plain year takes the chunked solve exactly where the kernel takes its
  cluster build (nx > 4096), the scan engine keeps PCR, and
  ``classic_year.chunked_launches`` counts exactly the cluster-build
  launches (the wrapper's CUDA path on CPU tensors, the C launch stubbed).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models import classic as mc
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import _build, _year
from energybalancemodel_jl_tpu_torch.ops import classic_year as tcy
from energybalancemodel_jl_tpu_torch.ops import tridiag
from energybalancemodel_jl_tpu_torch.ops.tridiag import (CHUNK, chunk_count, chunked_solve,
                                                         pcr_solve, pcr_steps, thomas_solve,
                                                         tridiag_matvec)
from energybalancemodel_jl_tpu_torch.utils.collection import Collection

CPU = torch.device("cpu")
CSRC = Path(tcy.__file__).resolve().parent.parent / "csrc"


def test_the_kernel_and_the_plain_solve_share_the_chunk():
    src = (CSRC / "classic_year.cu").read_text()
    assert re.findall(r"constexpr int CHUNK_ROWS = (\d+);", src) == [str(CHUNK)]
    assert CHUNK in (4, 8, 16)


def tg_system(nx, dtype):
    """The Tg system ``(lo, di, up, rhs)`` of a Classic step's solve: the
    second step from an ice cap (E = 30 - 60 x^2), so the diagonal is masked
    where the ice is."""
    st = ebt.SpaceTime.sin(nx, 1000, 1)
    par = ebt.default_parameters("Classic")
    stat = mc.statics(st, par, dtype, CPU)
    x = torch.as_tensor(st.x, dtype=dtype)
    E = 30.0 - 60.0 * x * x
    carry = Collection(E=E, Tg=torch.where(E > 0, E / par["cw"], torch.full_like(E, -1.0)))
    got, solve = [], mc.tridiag_solve

    def spy(lo, di, up, b, **kw):
        got.append(torch.broadcast_tensors(lo, di, up, b))
        return solve(lo, di, up, b, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "tridiag_solve", spy)
        for t in range(2):
            carry, _ = mc.step(carry, mc.step_inputs(stat, torch.zeros(2, dtype=dtype), t), stat,
                               par, default_step_config("float64"))
    masked = got[-1][1] != stat.kdi
    assert 0 < int(masked.sum()) < nx
    return got[-1]


def thomas_extended(lo, di, up, b):
    """Thomas in numpy's extended precision: the reference solution."""
    lo, di, up, b = (v.double().numpy().astype(np.longdouble) for v in (lo, di, up, b))
    n = b.shape[0]
    cp, dp = np.zeros(n, np.longdouble), np.zeros(n, np.longdouble)
    c = d = np.longdouble(0)
    for i in range(n):
        den = di[i] - lo[i] * c
        c, d = up[i] / den, (b[i] - lo[i] * d) / den
        cp[i], dp[i] = c, d
    x, xn = np.zeros(n, np.longdouble), np.longdouble(0)
    for i in range(n - 1, -1, -1):
        xn = dp[i] - cp[i] * xn
        x[i] = xn
    return x


def backward_error(system, x):
    """``|A x - b|_inf / (|A|_inf |x|_inf + |b|_inf)``, in float64."""
    lo, di, up, b = (v.double() for v in system)
    x = x.double()
    r = tridiag_matvec(lo, di, up, x) - b
    return float(r.abs().max() / ((lo.abs() + di.abs() + up.abs()).max() * x.abs().max()
                                  + b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx", [4352, 8192, 32768])
def test_chunked_solve_is_as_accurate_as_thomas_and_pcr(nx, dtype):
    system = tg_system(nx, dtype)
    truth = thomas_extended(*system)
    xs = {name: fn(*system) for name, fn in
          (("chunked", chunked_solve), ("thomas", thomas_solve), ("pcr", pcr_solve))}
    err = {name: float(np.linalg.norm(x.double().numpy().astype(np.longdouble) - truth)
                       / np.linalg.norm(truth)) for name, x in xs.items()}
    assert all(x.dtype == dtype and x.shape == (nx,) for x in xs.values())
    assert err["chunked"] <= 2.0 * max(err["thomas"], err["pcr"]), err
    assert backward_error(system, xs["chunked"]) <= backward_error(system, xs["pcr"])


def random_system(n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    lo, up = (torch.randn(n, generator=g, dtype=torch.float64) for _ in range(2))
    lo[0], up[-1] = 0.0, 0.0
    di = lo.abs() + up.abs() + 0.5 + torch.rand(n, generator=g, dtype=torch.float64)
    di = di * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).double()
    b = torch.randn(n, generator=g, dtype=torch.float64)
    return tuple(v.to(dtype) for v in (lo, di, up, b))


def close(x, y, bar=1e-13):
    return float((x - y).norm() / y.norm()) <= bar


@pytest.mark.parametrize("n", [3, CHUNK - 1, CHUNK + 1, 2 * CHUNK, 4097, 4352 + 3, 8193])
def test_widths_that_are_no_multiple_of_the_chunk(n):
    system = random_system(n, n)
    x = chunked_solve(*system)
    assert x.shape == (n,) and close(x, thomas_solve(*system))
    # a batch of members along the leading axis, each its own system
    batch = tuple(torch.stack([v, v.flip(0)]) for v in system)
    xb = chunked_solve(*batch)
    assert torch.equal(xb[0], x) and close(xb[1], thomas_solve(*(v[1] for v in batch)))


def test_identity_rows_at_both_ends():
    lo, di, up, b = random_system(4 * CHUNK + 3, 1)
    for i in (0, 1, -2, -1):
        lo[i], di[i], up[i] = 0.0, 1.0, 0.0
    x = chunked_solve(lo, di, up, b)
    assert torch.equal(x[[0, 1, -2, -1]], b[[0, 1, -2, -1]])
    assert close(x, thomas_solve(lo, di, up, b))


@pytest.mark.parametrize("row", [0, 1, 3, CHUNK - 1, CHUNK, 3 * CHUNK + 2, 4 * CHUNK + 2])
def test_a_zero_pivot_gives_zero(row):
    """A row whose pivot vanishes (0 x = 7) gives x = 0, and the others the
    system in which that row is an identity row (x = 0)."""
    lo, di, up, b = random_system(4 * CHUNK + 3, 2)
    lo[row], di[row], up[row], b[row] = 0.0, 0.0, 0.0, 7.0
    x = chunked_solve(lo, di, up, b)
    assert torch.isfinite(x).all() and x[row] == 0.0
    di[row], b[row] = 1.0, 0.0
    assert close(x, thomas_solve(lo, di, up, b))


def cluster_slice(nx, C):
    """``csrc/classic_year.cu::classic_cluster_slice``: ceil(nx / C) cells
    rounded up to whole chunks."""
    return -(-(-(-nx // C)) // CHUNK) * CHUNK


@pytest.mark.parametrize("nx", [4097, 4352, 8192, 8200, 16448, 32767, 32768])
def test_chunks_never_straddle_a_rank(nx):
    """The cluster build's layout, as the kernel computes it: rank r holds
    cells [r slice, r slice + cnt) and the interface rows [r islice, r
    islice + icnt), islice = 2 slice / CHUNK; chunk j's rows 2j and 2j + 1
    lie on the rank that holds its cells, where the multiply-high of
    cluster.cuh::cluster_at finds them; a thread's chunks fit the slots of
    classic_chunk_slots at the plan's threads."""
    nc = chunk_count(nx)
    for C in (2, 4, 8, 16):
        slice_ = cluster_slice(nx, C)
        assert slice_ % CHUNK == 0 and slice_ >= -(-nx // C) and C * slice_ >= nx
        islice = 2 * slice_ // CHUNK
        magic = ((1 << 32) + islice - 1) // islice
        held = 0
        for r in range(C):
            cnt = min(max(nx - r * slice_, 0), slice_)
            icnt = min(max(2 * nc - r * islice, 0), islice)
            assert icnt == 2 * -(-cnt // CHUNK)  # the rank's chunks that hold cells
            for j in range(r * slice_ // CHUNK, r * slice_ // CHUNK + icnt // 2):
                assert j * CHUNK // slice_ == r
                for row in (2 * j, 2 * j + 1):
                    assert (row * magic) >> 32 == row // islice == r
            held += icnt // 2
        assert held == nc
        t = min(-(-(slice_ // CHUNK) // 32) * 32, 256)
        assert -(-(slice_ // CHUNK) // t) <= 32768 // 2 // CHUNK // 256
        assert _year.wide_words("classic_year", nx, C) == -(-(11 * slice_) // 32) * 32


def test_classic_year_reference_at_nx_8192_matches_jax():
    import energybalancemodel_jl_tpu as ebm

    st = ebt.SpaceTime.sin(8192, 1000, 1)
    par = ebt.default_parameters("Classic")
    E0 = np.full(st.nx, 30.0)
    init = {"E": E0, "Tg": E0 / par["cw"]}
    jax_years = {
        solver: ebm.integrate("Classic", st, ebm.Forcing(0.0), ebm.default_parameters("Classic"),
                              ebm.Collection(init), engine="scan", raw_mode="none",
                              dtype="float64", solver=solver, progress=False).seasonal
        for solver in ("pcr", "thomas")}
    carry = Collection({k: torch.as_tensor(v)[None] for k, v in init.items()})
    _, seasonal, _, _ = tcy.classic_year_reference(carry, par,
                                                   torch.zeros(st.nt, dtype=torch.float64),
                                                   st, default_step_config("float64"))

    def worst(a, b):
        return max(float(np.max(np.abs(np.asarray(x[k]) - np.asarray(y[k]))))
                   for x, y in zip(a, b) for k in ("E", "T", "h"))

    witness = worst(jax_years["thomas"], jax_years["pcr"])
    assert 1e-9 < witness < 1e-7  # a solve's last bits, amplified at the ice edge
    for solver in ("pcr", "thomas"):
        assert worst(seasonal, jax_years[solver]) <= 4.0 * witness, solver
    assert all(np.isfinite(np.asarray(s[k])).all() for s in seasonal for k in s)
    assert np.ptp(np.asarray(seasonal.avg["E"])) > 10.0  # not a flat field


@pytest.mark.parametrize("nx", [4096, 4097])
def test_the_plain_year_solves_by_chunks_where_the_kernel_runs_its_cluster_build(nx):
    methods = []
    solve = mc.tridiag_solve

    def spy(lo, di, up, b, method="pcr", **kw):
        methods.append(method)
        return solve(lo, di, up, b, method=method, **kw)

    st = ebt.SpaceTime.sin(nx, 1000, 1)
    par = ebt.default_parameters("Classic")
    E = np.full(nx, 30.0)
    init = {"E": E, "Tg": E / par["cw"]}
    short = ebt.SpaceTime.sin(nx, 2, 1)  # two steps a year
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "tridiag_solve", spy)
        carry = Collection({k: torch.as_tensor(v)[None] for k, v in init.items()})
        tcy.classic_year_reference(carry, par, torch.zeros(short.nt, dtype=torch.float64),
                                   short, default_step_config("float64"))
        assert methods == ["chunked" if nx > 4096 else "pcr"] * 2
        methods.clear()
        ebt.integrate("Classic", short, ebt.Forcing(0.0), par, init, engine="scan",
                      raw_mode="none", dtype="float64", device="cpu", progress=False)
        assert methods == ["pcr"] * 2
    assert st.nx == nx


def test_chunked_launches_count_the_cluster_builds(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, the C launch and the C side's
    plan stubbed: every launch counts in ``launches``, the cluster builds'
    (nx > 4096) in ``chunked_launches`` too, each with the PCR levels of
    the interface system."""
    launched = []
    monkeypatch.setattr(_build, "launch", lambda name, dtype, device, *a: launched.append(a))
    monkeypatch.setattr(tcy, "cluster_plan", lambda *a, **kw: _year.ClusterPlan(
        C=16, threads=256, records_shared=True, clusters=8, shared_bytes=200000))
    par = ebt.default_parameters("Classic")
    for nx, cluster in ((180, False), (4096, False), (4097, True), (8192, True), (180, False)):
        st = ebt.SpaceTime.sin(nx, 4, 1)
        E = torch.full((1, nx), 30.0, dtype=torch.float64)
        before = tcy.classic_year.launches, tcy.classic_year.chunked_launches
        tcy._year_cuda(Collection(E=E, Tg=E / par["cw"]), par,
                       torch.zeros(st.nt, dtype=torch.float64), st, False, None, None, None,
                       False, None)
        assert (tcy.classic_year.launches, tcy.classic_year.chunked_launches) == (
            before[0] + 1, before[1] + int(cluster))
        # (the year's 10 pointers, 7 noise pointers, the workspace, K, nx,
        # nt, w0, s0, then the PCR levels)
        args = launched[-1]
        assert args[19] == nx
        assert args[23] == pcr_steps(2 * chunk_count(nx) if cluster else nx)
    assert tridiag.CHUNK == CHUNK
