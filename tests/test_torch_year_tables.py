"""The year-table cache of the whole-year kernel wrappers
(``ops/_year.py::year_tables``) and the device tables the entry points hand
them, on the CPU (~7 s):

- the cached per-cell columns, ``cos`` table, ``dt``, default ``F`` and
  trapezoid weights equal freshly built ones bit for bit (MIZ and Classic,
  float32 and float64, two grids);
- entries differ by ``nx``, ``nt`` (and so ``dt``), dtype and device, and the
  cache keeps at most ``YEAR_TABLES_MAX`` of them;
- ``year_tables.builds`` and ``.hits`` count: closed loops of calls to
  ``integrate``, ``ensemble_integrate`` and ``transitions`` on one grid build
  one entry and hit it on every later launch. The wrappers' CUDA path runs
  here on CPU tensors with the C launch stubbed out, and every launch reads
  the cached tables and the entry point's forcing row (and keys) in place,
  with no copy;
- the ``(years, K, 2)`` key table's row ``y`` is
  ``keys_tensor(prng.fold_in(mkeys, year0 + y))``;
- the forcing table's row ``y`` is ``as_tensor(forcing.table(st)[y], dtype)``.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.classic import cos_table, uniform_bands
from energybalancemodel_jl_tpu_torch.ops import _build, _year, classic_year, miz_year, prng
from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
from energybalancemodel_jl_tpu_torch.utils.numerics import host_cos

# the module (the package's attribute of that name is the function)
integrate_mod = importlib.import_module("energybalancemodel_jl_tpu_torch.integrate")
torch.set_num_threads(1)
CPU = torch.device("cpu")
# a ramp over three years: every year's forcing row differs
RAMP = (0.0, 2.0, 1.0, (0, 0), (1.0, -1.0))
HOST = {"miz_year": miz_year._host_tables, "classic_year": classic_year._host_tables}


def _bits(v: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, so that -0.0 and 0.0 differ."""
    return v.contiguous().view({torch.float32: torch.int32, torch.float64: torch.int64}[v.dtype])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _fresh(kernel, st, dtype):
    """The tables as the wrappers built them on every launch before the
    cache: columns (5, nx), cos table, dt, default F, trapezoid weights."""
    band = lambda b: torch.as_tensor(np.asarray(b), dtype=dtype)
    x = torch.as_tensor(st.x, dtype=dtype)
    if kernel == "miz_year":
        geom = diffusion_bands(st)
        cosv = host_cos(2.0 * math.pi * torch.as_tensor(st.t, dtype=dtype))
    else:
        geom = uniform_bands(st.nx)
        cosv = cos_table(st, dtype)
    cols = torch.stack([x, x * x, band(geom.lo), band(geom.di), band(geom.up)])
    return (cols, cosv, torch.as_tensor(st.dt, dtype=dtype), torch.as_tensor(0.0, dtype=dtype),
            _year.trapezoid_weights(st.x, dtype) if st.nx > 1 else None)


@pytest.fixture(autouse=True)
def empty_cache():
    _year.clear_year_tables()
    yield
    _year.clear_year_tables()


def _counts():
    return _year.year_tables.builds, _year.year_tables.hits


@pytest.mark.parametrize("grid", [(180, 2000), (8192, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["miz_year", "classic_year"])
def test_cached_tables_are_the_fresh_ones_bit_for_bit(kernel, dtype, grid):
    st = ebt.SpaceTime.sin(*grid, 1)
    first = _year.year_tables(kernel, st, dtype, CPU, HOST[kernel])
    # a new SpaceTime of the same grid, as every call of an entry point makes
    again = _year.year_tables(kernel, ebt.SpaceTime.sin(*grid, 3), dtype, CPU, HOST[kernel])
    assert all(a is b for a, b in zip(first, again))
    for got, want in zip(first, _fresh(kernel, st, dtype)):
        assert _same(got, want)
    assert first.cols.shape == (5, st.nx) and first.cols.is_contiguous()
    assert first.cos.shape == ((st.nt,) if kernel == "miz_year" else (st.nt + 1,))


@pytest.mark.parametrize("kernel", ["miz_year", "classic_year"])
def test_a_one_cell_grid_has_tables_but_no_crossing_weights(kernel):
    st = ebt.SpaceTime.sin(1, 100, 1)
    tables = _year.year_tables(kernel, st, torch.float64, CPU, HOST[kernel])
    fresh = _fresh(kernel, st, torch.float64)
    assert tables.weights is None and fresh[-1] is None
    for got, want in zip(tables[:-1], fresh[:-1]):
        assert _same(got, want)
    with pytest.raises(ValueError, match="at least two cells"):
        _year.NoiseLaunch(None, (0.5, 1.0, 0.0), np.zeros((3, 2), np.uint32), False,
                          (0.1, 1.0), st, 3, torch.float64, CPU, 0, tables.weights)


@pytest.mark.parametrize("change", ["nx", "nt", "dtype", "device"])
def test_an_entry_per_grid_dtype_and_device(change):
    st, dtype, device = ebt.SpaceTime.sin(16, 100, 1), torch.float32, CPU
    base = _year.year_tables("classic_year", st, dtype, device, HOST["classic_year"])
    if change == "nx":
        st = ebt.SpaceTime.sin(32, 100, 1)
    elif change == "nt":
        st = ebt.SpaceTime.sin(16, 200, 1)
    elif change == "dtype":
        dtype = torch.float64
    else:
        device = torch.device("meta")  # stands in for a second device
    b0, h0 = _counts()
    other = _year.year_tables("classic_year", st, dtype, device, HOST["classic_year"])
    assert _counts() == (b0 + 1, h0)
    assert other.cols.device == device and other.cols.dtype == dtype
    if change == "nt":
        assert _same(other.dt, torch.as_tensor(1 / 200, dtype=dtype))
        assert _same(base.dt, torch.as_tensor(1 / 100, dtype=dtype))
    if change in ("nx", "nt"):
        assert other.cols.shape != base.cols.shape or other.cos.shape != base.cos.shape
    # the kernel is part of the key too
    _year.year_tables("miz_year", st, dtype, device, HOST["miz_year"])
    assert _counts() == (b0 + 2, h0)


def test_the_cache_keeps_at_most_its_bound():
    grids = [ebt.SpaceTime.sin(8 + i, 50, 1) for i in range(_year.YEAR_TABLES_MAX + 3)]
    b0, h0 = _counts()
    for st in grids:
        _year.year_tables("miz_year", st, torch.float32, CPU, HOST["miz_year"])
    assert len(_year._TABLES) == _year.YEAR_TABLES_MAX
    assert _counts() == (b0 + len(grids), h0)
    # the newest entries stay, the oldest went first
    _year.year_tables("miz_year", grids[-1], torch.float32, CPU, HOST["miz_year"])
    assert _counts() == (b0 + len(grids), h0 + 1)
    _year.year_tables("miz_year", grids[0], torch.float32, CPU, HOST["miz_year"])
    assert _counts() == (b0 + len(grids) + 1, h0 + 1)
    assert len(_year._TABLES) == _year.YEAR_TABLES_MAX


class _Spy:
    """Runs each fused year twice: through the wrapper's CUDA path on the
    CPU tensors with the C launch stubbed out (so the cache is looked up and
    the launch's pointers recorded), then through the real wrapper (its plain
    version here), whose results the entry point gets."""

    def __init__(self, monkeypatch, model):
        self.model, self.real = model, integrate_mod.FUSED_YEARS[model]
        self.launches = []  # (pointer args, fyear, noise_keys)
        self.args = None
        monkeypatch.setattr(_build, "launch", lambda name, dtype, device, *a: self._record(a))
        monkeypatch.setitem(integrate_mod.FUSED_YEARS, model, (self, self.real[1]))

    def _record(self, args):
        self.args = args

    def __call__(self, carry, par, fyear, st, cfg, collect_raw=False, noise=None, noise_ou=None,
                 noise_keys=None, ou_assoc=False, crossing=None):
        noise_kw = (noise, noise_ou, noise_keys, ou_assoc, crossing)
        if self.model == "MIZ":
            miz_year._year_cuda(carry, par, fyear, st, cfg, collect_raw, *noise_kw, None)
        else:
            classic_year._year_cuda(carry, par, fyear, st, collect_raw, *noise_kw)
        self.launches.append((self.args, fyear, noise_keys))
        return self.real[0](carry, par, fyear, st, cfg, collect_raw=collect_raw, noise=noise,
                            noise_ou=noise_ou, noise_keys=noise_keys, ou_assoc=ou_assoc,
                            crossing=crossing)

    def check(self, kernel, st, dtype):
        """Every launch read the one cached entry and its forcing row (and
        keys) in place; returns the rows and keys it read."""
        tables = _year._TABLES[(kernel, st.grid, tuple(st.urange), st.nx, st.nt, dtype, CPU)]
        nptrs = 12 if kernel == "miz_year" else 10  # the year pointers, then the noise ones
        rows, keys = [], []
        for args, fyear, noise_keys in self.launches:
            assert args[2] == tables.cols.data_ptr() and args[3] == tables.cos.data_ptr()
            assert torch.is_tensor(fyear) and fyear.dtype == dtype
            assert args[4] == fyear.data_ptr()
            rows.append(fyear)
            if noise_keys is not None:
                assert args[nptrs + 1] == noise_keys.data_ptr()
                keys.append(noise_keys)
        return rows, keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_integrate_builds_once_and_reads_its_rows_in_place(monkeypatch, dtype):
    spy = _Spy(monkeypatch, "Classic")
    forcing = ebt.Forcing(*RAMP)
    E = np.full(16, 30.0)
    init = {"E": E, "Tg": E / ebt.default_parameters("Classic")["cw"]}
    b0, h0 = _counts()
    for call in range(2):
        st = ebt.SpaceTime.sin(16, 200, 3)
        ebt.integrate("Classic", st, forcing, ebt.default_parameters("Classic"), init,
                      dtype=dtype, device="cpu", engine="fused", raw_mode="none",
                      progress=False)
    assert len(spy.launches) == 6
    assert _counts() == (b0 + 1, h0 + 5)
    rows, _ = spy.check("classic_year", st, dtype)
    table = forcing.table(st)
    for y, row in enumerate(rows):
        assert _same(row, torch.as_tensor(table[y % 3], dtype=dtype))


def test_ensemble_integrate_builds_once_and_reads_its_rows_in_place(monkeypatch):
    spy = _Spy(monkeypatch, "MIZ")
    st = ebt.SpaceTime.sin(8, 50, 2)
    par = dict(ebt.default_parameters("MIZ"), D=np.linspace(0.5, 0.7, 4))
    b0, h0 = _counts()
    for call in range(2):
        ebt.ensemble_integrate("MIZ", st, ebt.Forcing(1.5), par, ebt.zeros_init(st),
                               device="cpu", engine="fused", progress=False)
    assert len(spy.launches) == 4
    assert _counts() == (b0 + 1, h0 + 3)
    rows, _ = spy.check("miz_year", st, torch.float32)
    for y, row in enumerate(rows):
        assert _same(row, torch.as_tensor(ebt.Forcing(1.5).table(st)[y % 2], dtype=torch.float32))


def test_transitions_builds_once_and_reads_its_keys_in_place(monkeypatch):
    spy = _Spy(monkeypatch, "Classic")
    st = ebt.SpaceTime.sin(8, 200, 1)
    cw = ebt.default_parameters("Classic")["cw"]
    warm, cold = np.full(8, 30.0), np.full(8, -10.0)
    a, b = {"E": warm, "Tg": warm / cw}, {"E": cold, "Tg": cold / cw}
    b0, h0 = _counts()
    ebt.transitions("Classic", st, ebt.Forcing(0.0), ebt.default_parameters("Classic"), a, b,
                    sigma=2.0, tau=0.05, K=4, years=2, year0=5, seed=7, device="cpu",
                    engine="fused")
    # the two reference years (K=1), then the study's two
    assert len(spy.launches) == 4
    assert _counts() == (b0 + 1, h0 + 3)
    _, keys = spy.check("classic_year", st, torch.float32)
    mkeys = prng.fold_in(prng.prng_key(7), np.arange(4))
    assert len(keys) == 2
    for y, k in enumerate(keys):
        assert torch.equal(k, _year.keys_tensor(prng.fold_in(mkeys, 5 + y), 4, CPU))


@pytest.mark.parametrize("year0,years", [(0, 1), (37, 5)])
def test_year_key_table_rows_are_the_yearly_folds(year0, years):
    mkeys = prng.fold_in(prng.prng_key(2**31 + 11), np.arange(6))
    table = _year.year_keys(mkeys, year0 + np.arange(years), CPU)
    assert table.dtype == torch.int32 and tuple(table.shape) == (years, 6, 2)
    for y in range(years):
        assert torch.equal(table[y], _year.keys_tensor(prng.fold_in(mkeys, year0 + y), 6, CPU))
        # the kernels' form: the row passes through keys_tensor as it is
        assert _year.keys_tensor(table[y], 6, CPU).data_ptr() == table[y].data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("forcing", [(0.7,), RAMP])
def test_forcing_table_rows_are_the_yearly_rows(forcing, dtype):
    st = ebt.SpaceTime.sin(8, 300, 4)
    host = ebt.Forcing(*forcing).table(st)
    table = integrate_mod._as_tensor(host, dtype, CPU)
    for y in range(st.dur):
        assert _same(table[y], torch.as_tensor(host[y], dtype=dtype))
        # a row of the run's dtype on its device takes no copy in the wrappers
        assert torch.as_tensor(table[y], dtype=dtype, device=CPU).data_ptr() == table[y].data_ptr()
