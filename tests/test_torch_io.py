"""Persistence of the PyTorch port (``io.py``, ``io_jld2.py``, the
safehouse) against the JAX package.

Bars: every registered type (``Solutions``, ``EnsembleSolutions`` and the 11
public ``*Result`` types) round-trips within the port and across packages in
both directions (JAX ``save`` -> port ``load``, port ``save`` -> JAX
``load``) with every array bitwise, scalars and strings equal, grids and
forcings equal by ``repr``; the fields are drawn from one numpy seed, as JAX
``tests/test_io.py`` builds them, not by running the drivers. JLD2 files
written by either package load in the other bitwise. The reference's file
semantics (an existing file renamed, ``load_into`` housing the old value)
hold as in the JAX package.
"""
import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu import io_jld2 as jjld2
from energybalancemodel_jl_tpu_torch import io_jld2 as tjld2
from torch_results import factories

MODS = {"jax": ebm, "torch": ebt}


NAMES = sorted(factories(ebt))


def check(a, b, key=""):
    """Field by field: arrays bitwise (NaNs at the same places), grids and
    forcings by repr (the two packages' classes differ)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, key
        if type(a).__name__ in ("SpaceTime", "Forcing"):
            assert repr(a) == repr(b), key
            return
        for f in dataclasses.fields(a):
            check(getattr(a, f.name), getattr(b, f.name), f"{key}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), key
        for k in a:
            check(a[k], b[k], f"{key}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), key
        for i, (x, y) in enumerate(zip(a, b)):
            check(x, y, f"{key}[{i}]")
    elif a is None or isinstance(a, str):
        assert a == b, key
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


def test_registry_covers_every_public_result_type():
    public = sorted(n for n in ebt.__all__ if n.endswith("Result"))
    assert public == sorted(n for n in ebm.__all__ if n.endswith("Result"))
    assert len(public) == 11
    assert sorted(public + ["Solutions", "EnsembleSolutions"]) == NAMES
    for name in NAMES:  # no type falls through to the generic array writer
        obj = factories(ebt)[name]()
        assert type(obj).__module__.startswith("energybalancemodel_jl_tpu_torch")


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("name", NAMES)
def test_round_trip_across_packages(name, writer, reader, tmp_path):
    w, r = MODS[writer], MODS[reader]
    obj = factories(w)[name]()
    path = str(tmp_path / f"{name}.h5")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the generic-array fallthrough warns
        w.save(obj, path)
    back = r.load(path)
    assert type(back).__name__ == name
    assert type(back).__module__.startswith(r.__name__ + ".") and (
        r is ebm) == ("_torch" not in type(back).__module__)
    check(factories(r)[name](), back)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_jld2_crosses_packages(writer, reader, tmp_path):
    w, r = (jjld2 if m == "jax" else tjld2 for m in (writer, reader))
    obj = factories(MODS[writer])["Solutions"]()
    path = str(tmp_path / "sols.jld2")
    w.write_jld2(obj, path)
    back = r.load_jld2_solutions(path)
    assert repr(back.spacetime) == repr(obj.spacetime)
    assert repr(back.forcing) == repr(obj.forcing)
    for k in obj.raw:
        np.testing.assert_array_equal(back.raw[k], obj.raw[k], err_msg=k)
    for season in ("winter", "summer", "avg"):
        for k in obj.raw:
            np.testing.assert_array_equal(getattr(back.seasonal, season)[k],
                                          getattr(obj.seasonal, season)[k])
    named = str(tmp_path / "named.jld2")
    w.write_jld2(obj, named, name="sols")
    np.testing.assert_array_equal(r.load_jld2_solutions(named, name="sols").raw["E"],
                                  obj.raw["E"])


@pytest.fixture
def without_h5py(monkeypatch):
    """The port's files written and read by its numpy-only HDF5 module."""
    from energybalancemodel_jl_tpu_torch import checkpoint as tck
    from energybalancemodel_jl_tpu_torch import io as tio
    from energybalancemodel_jl_tpu_torch.utils.hdf5 import lite

    monkeypatch.setattr(tio, "h5py", lite)
    monkeypatch.setattr(tck, "h5py", lite)
    return lite


@pytest.mark.parametrize("name", NAMES)
def test_numpy_only_hdf5_files_load_in_both_packages(name, tmp_path, without_h5py):
    path = str(tmp_path / f"{name}.h5")
    ebt.save(factories(ebt)[name](), path)
    check(factories(ebm)[name](), ebm.load(path))  # h5py reads the file
    check(factories(ebt)[name](), ebt.load(path))  # and so does the module itself


def test_numpy_only_hdf5_reads_only_its_own_layout(tmp_path, without_h5py):
    path = str(tmp_path / "jax.h5")
    ebm.save("Hello World", path)  # libhdf5's layout
    with pytest.raises(ValueError, match="layout"):
        ebt.load(path)
    mine = str(tmp_path / "mine.h5")
    ebt.save("Hello World", mine)
    assert ebm.load(mine) == "Hello World" == ebt.load(mine)


def test_integrated_solutions_round_trip(tmp_path):
    st = ebt.SpaceTime.sin(12, 20, 2)
    sols = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                         ebt.zeros_init(st), progress=False, dtype="float64", device="cpu")
    path = str(tmp_path / "sols.h5")
    assert ebt.save(sols, path) == path
    loaded = ebm.load(path)
    assert loaded.spacetime == ebm.SpaceTime.sin(12, 20, 2)
    assert loaded.lastonly == sols.lastonly
    for k in sols.raw:
        np.testing.assert_array_equal(loaded.raw[k], sols.raw[k], err_msg=k)
        np.testing.assert_array_equal(loaded.seasonal.avg[k], sols.seasonal.avg[k])
    for k in sols.parameters:
        assert loaded.parameters[k] == sols.parameters[k]


def test_strings_arrays_and_collections(tmp_path):
    p1, p2, p3 = (str(tmp_path / n) for n in ("s.h5", "a.h5", "d.h5"))
    ebt.save("Hello World", p1)
    assert ebt.load(p1) == "Hello World" == ebm.load(p1)
    arr = np.arange(12.0).reshape(3, 4)
    ebt.save(arr, p2)
    np.testing.assert_array_equal(ebt.load(p2), arr)
    ebt.save(ebt.Collection(a=1.0, b=np.ones(3)), p3)
    out = ebt.load(p3)
    assert out["a"] == 1.0
    np.testing.assert_array_equal(out["b"], np.ones(3))


def test_existing_file_is_renamed_and_load_into_houses(tmp_path):
    path = str(tmp_path / "greeting.h5")
    ebt.save("Hello World", path)
    with pytest.warns(UserWarning, match="has been renamed"):
        ebt.save("Hello again", path)
    assert ebt.load(path) == "Hello again"
    renamed = [f for f in os.listdir(tmp_path) if f.startswith("greeting_")]
    assert len(renamed) == 1 and ebt.load(str(tmp_path / renamed[0])) == "Hello World"
    with pytest.warns(UserWarning, match="unsafesave"):
        ebt.unsafesave("x", str(tmp_path / "x.h5"))
    with pytest.warns(UserWarning, match="unsafeload"):
        assert ebt.unsafeload(str(tmp_path / "x.h5")) == "x"
    ns = {"v": "old value"}
    with pytest.warns(UserWarning, match="safehouse"):
        ebt.load_into("v", path, ns)
    assert ns["v"] == "Hello again"
    assert ebt.retrieve("v", ebt.safehouse(ns))[-1].value == "old value"
    fresh = {}
    assert ebt.load_into("w", path, fresh) == "Hello again" == fresh["w"]


def test_port_imports_no_jax():
    """The port's modules, this slice's included, import no jax and nothing
    of the JAX package."""
    root = os.path.join(os.path.dirname(__file__), "..", "energybalancemodel_jl_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for line in text.splitlines():
                    s = line.strip()
                    if (s.startswith(("import ", "from ")) and
                            ("jax" in s.split()[1] or
                             s.split()[1].startswith("energybalancemodel_jl_tpu")
                             and not s.split()[1].startswith("energybalancemodel_jl_tpu_torch"))):
                        offenders.append(f"{f}: {s}")
    smoke = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    for line in open(smoke).read().splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")) and "jax" in s.split()[1]:
            offenders.append(f"chip_smoke.py: {s}")
    assert not offenders, offenders
    assert "energybalancemodel_jl_tpu_torch.io" in sys.modules
