"""Mid-run checkpoint / resume (a port of the JAX package's ``checkpoint.py``).

The reference has no mid-run checkpointing — a run restarts from ``init``
(SURVEY.md §5); its ``save``/``load!`` serialize only finished ``Solutions``.
Here the year loop's carry is a small set of ``(nx,)`` or ``(K, nx)``
fields, so the per-year drivers can write a checkpoint every N simulated
years and resume a run bit-exactly: the checkpoint holds the carry, the
completed-year count, and the seasonal storage accumulated so far.

Used through :func:`energybalancemodel_jl_tpu_torch.integrate`::

    sols = integrate("MIZ", st, forcing, par, init,
                     checkpoint="run.ckpt.h5", checkpoint_every=5)
    # ... interrupted ...
    sols = integrate("MIZ", st, forcing, par, init,
                     checkpoint="run.ckpt.h5", resume=True)

Resume validates that the grid, duration, and parameters match the
checkpoint and continues from the first unfinished year; the returned
``Solutions`` is identical to an uninterrupted run (the carry is the
complete model state, the MIZ Newton warm start ``T0`` included).

The files and the :func:`config_key` strings are the JAX package's: a
checkpoint written by either package resumes in the other when both are
asked for the same run (same model, grid, forcing, parameters, dtype,
solver, Newton cap and engine).
"""
from __future__ import annotations

import hashlib
import os
import warnings
from typing import List, Tuple

import numpy as np
import torch

from .utils.collection import Collection
from .utils.hdf5 import h5py

__all__ = [
    "write_checkpoint", "read_checkpoint", "checkpoint_matches",
    "config_key", "resume_state", "year_writer",
    "write_eq_checkpoint", "read_eq_checkpoint",
    "write_cont_checkpoint", "read_cont_checkpoint",
    "write_fold_checkpoint", "read_fold_checkpoint",
    "write_edge_checkpoint", "read_edge_checkpoint",
    "digest_array", "digest_collection", "search_key",
    "try_resume_search", "key_kwargs", "fetch_host",
]

_FORMAT = 1


def write_checkpoint(
    path: str,
    carry: Collection,
    years_done: int,
    seasonal_acc: Tuple[List[Collection], List[Collection], List[Collection]],
    config_key: str,
) -> str:
    """Atomically write a checkpoint (write to ``path.tmp`` then rename)."""
    tmp = path + ".tmp"
    winter, summer, avg = seasonal_acc
    with h5py.File(tmp, "w") as f:
        f.attrs["__ebm_type__"] = "Checkpoint"
        f.attrs["format"] = _FORMAT
        f.attrs["years_done"] = int(years_done)
        f.attrs["config_key"] = config_key
        g = f.create_group("carry")
        for k, v in carry.items():
            g.create_dataset(k, data=np.asarray(v))
        for name, acc in (("winter", winter), ("summer", summer), ("avg", avg)):
            ga = f.create_group(f"seasonal_{name}")
            for y, coll in enumerate(acc):
                gy = ga.create_group(str(y))
                for k, v in coll.items():
                    gy.create_dataset(k, data=np.asarray(v))
    os.replace(tmp, path)
    return path


def read_checkpoint(path: str):
    """Read a checkpoint; returns ``(carry, years_done, seasonal_acc,
    config_key)``."""
    with h5py.File(path, "r") as f:
        if f.attrs.get("__ebm_type__") != "Checkpoint":
            raise ValueError(f"{path} is not an integrate checkpoint")
        years_done = int(f.attrs["years_done"])
        config_key = str(f.attrs["config_key"])
        carry = Collection({k: np.asarray(v) for k, v in f["carry"].items()})
        acc = []
        for name in ("winter", "summer", "avg"):
            ga = f[f"seasonal_{name}"]
            acc.append(
                [
                    Collection({k: np.asarray(v) for k, v in ga[str(y)].items()})
                    for y in range(years_done)
                ]
            )
    return carry, years_done, tuple(acc), config_key


def write_eq_checkpoint(path, carry, seasonal, years, resid, myears,
                        newton, config_key) -> str:
    """Atomic checkpoint of an :func:`~energybalancemodel_jl_tpu_torch.equilibrate`
    convergence loop: the loop carry (the next iterate — under Anderson
    acceleration this is the extrapolated vector, exactly what the loop
    would step next), the last completed year's seasonal store, and the
    convergence bookkeeping (years, per-member residual/first-converged
    year, Newton health). Everything a resume needs to re-enter the loop
    bit-exactly (Picard) or with a reseeded AA history (``anderson>0``)."""
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["__ebm_type__"] = "EqCheckpoint"
        f.attrs["format"] = _FORMAT
        f.attrs["years_done"] = int(years)
        f.attrs["newton_ok"] = float(newton)
        f.attrs["config_key"] = config_key
        g = f.create_group("carry")
        for k, v in carry.items():
            g.create_dataset(k, data=np.asarray(v))
        for name, coll in zip(("winter", "summer", "avg"), seasonal):
            gs = f.create_group(f"seasonal_{name}")
            for k, v in coll.items():
                gs.create_dataset(k, data=np.asarray(v))
        f.create_dataset("resid", data=np.asarray(resid))
        f.create_dataset("member_years", data=np.asarray(myears))
    os.replace(tmp, path)
    return path


def read_eq_checkpoint(path: str):
    """Read an equilibrate checkpoint; returns ``(carry, seasonal_colls,
    years, resid, myears, newton, config_key)``."""
    with h5py.File(path, "r") as f:
        if f.attrs.get("__ebm_type__") != "EqCheckpoint":
            raise ValueError(f"{path} is not an equilibrate checkpoint")
        carry = Collection({k: np.asarray(v) for k, v in f["carry"].items()})
        seasonal = tuple(
            Collection({k: np.asarray(v)
                        for k, v in f[f"seasonal_{n}"].items()})
            for n in ("winter", "summer", "avg")
        )
        return (carry, seasonal, int(f.attrs["years_done"]),
                np.asarray(f["resid"]), np.asarray(f["member_years"]),
                float(f.attrs["newton_ok"]), str(f.attrs["config_key"]))


def write_cont_checkpoint(path, results, config_key, n_prev=None) -> str:
    """Checkpoint of a :func:`~energybalancemodel_jl_tpu_torch.continuation`
    path: every COMPLETED level's EquilibriumResult (the io.py schema).

    ``n_prev`` is how many leading levels the file already holds from THIS
    run (the continuation driver threads it): only levels ``n_prev:`` are
    appended, so per-level cost stays O(1) in completed levels instead of
    re-serializing the whole prefix (O(n^2) for long scans). The
    ``n_done`` attribute is bumped only AFTER the new groups are written
    and flushed, so an interrupted write leaves at most orphan groups
    past ``n_done``, which the reader ignores (and a later write
    replaces). ``n_prev=None`` (external callers, e.g. truncating a file
    in tests) rewrites the file from scratch via tmp+rename."""
    from .io import _write_equilibrium
    if n_prev is None or not os.path.exists(path):
        tmp = path + ".tmp"
        with h5py.File(tmp, "w") as f:
            f.attrs["__ebm_type__"] = "ContCheckpoint"
            f.attrs["format"] = _FORMAT
            f.attrs["config_key"] = config_key
            g = f.create_group("levels")
            for i, r in enumerate(results):
                _write_equilibrium(g.create_group(f"{i:08d}"), r)
            f.flush()
            f.attrs["n_done"] = len(results)
        os.replace(tmp, path)
        return path
    with h5py.File(path, "a") as f:
        if (f.attrs.get("__ebm_type__") != "ContCheckpoint"
                or str(f.attrs.get("config_key")) != config_key):
            raise ValueError(
                f"{path} holds a different run's checkpoint; the driver "
                "recreates the file on the first write (n_prev=None)")
        g = f["levels"]
        for i in range(int(n_prev), len(results)):
            name = f"{i:08d}"
            if name in g:  # orphan from an interrupted earlier write
                del g[name]
            _write_equilibrium(g.create_group(name), results[i])
        f.flush()
        f.attrs["n_done"] = len(results)
    return path


def read_cont_checkpoint(path: str):
    """Read a continuation checkpoint; returns ``(results, config_key)``.
    Only the ``n_done`` gated prefix of level groups is trusted (orphans
    past it are a crash artifact of an interrupted append)."""
    from .io import _read_equilibrium
    with h5py.File(path, "r") as f:
        if f.attrs.get("__ebm_type__") != "ContCheckpoint":
            raise ValueError(f"{path} is not a continuation checkpoint")
        g = f["levels"]
        n = f.attrs.get("n_done")
        keys = (sorted(g.keys(), key=int) if n is None
                else [f"{i:08d}" for i in range(int(n))])
        results = [_read_equilibrium(g[k]) for k in keys]
        return results, str(f.attrs["config_key"])


def write_fold_checkpoint(path, config_key, anchor, lo, hi, history,
                          survived, conv, ref_on, ref_off) -> str:
    """Checkpoint of a :func:`~energybalancemodel_jl_tpu_torch.fold` search:
    the converged anchor (io.py equilibrium schema), the current
    per-member brackets, the per-step histories, and — under the default
    classifier — the two evolving ice-area references. Everything a
    probe's outcome depends on is in the file, so a resume replays the
    remaining bisection steps bit-exactly. The state is a few KB;
    each write is a whole-file tmp+rename (atomic against interruption)."""
    from .io import _write_equilibrium

    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["__ebm_type__"] = "FoldCheckpoint"
        f.attrs["format"] = _FORMAT
        f.attrs["config_key"] = config_key
        f.attrs["n_done"] = int(np.shape(history)[0])
        f.create_dataset("lo", data=np.asarray(lo, dtype=np.float64))
        f.create_dataset("hi", data=np.asarray(hi, dtype=np.float64))
        f.create_dataset("history", data=np.asarray(history))
        f.create_dataset("survived", data=np.asarray(survived))
        f.create_dataset("probe_converged", data=np.asarray(conv))
        if ref_on is not None:
            f.create_dataset("ref_on",
                             data=np.asarray(ref_on, dtype=np.float64))
            f.create_dataset("ref_off",
                             data=np.asarray(ref_off, dtype=np.float64))
        _write_equilibrium(f.create_group("anchor"), anchor)
    os.replace(tmp, path)
    return path


def read_fold_checkpoint(path: str):
    """Read a fold checkpoint; returns ``(state_dict, config_key)``. The
    ``n_done`` attribute gates how many bisection steps the histories
    hold (the writer is atomic, so no orphan handling is needed)."""
    from .io import _read_equilibrium

    with h5py.File(path, "r") as f:
        if f.attrs.get("__ebm_type__") != "FoldCheckpoint":
            raise ValueError(f"{path} is not a fold checkpoint")
        n = int(f.attrs["n_done"])
        out = dict(
            lo=np.asarray(f["lo"]),
            hi=np.asarray(f["hi"]),
            history=np.asarray(f["history"])[:n],
            survived=np.asarray(f["survived"], dtype=bool)[:n],
            conv=np.asarray(f["probe_converged"], dtype=bool)[:n],
            ref_on=np.asarray(f["ref_on"]) if "ref_on" in f else None,
            ref_off=np.asarray(f["ref_off"]) if "ref_off" in f else None,
            anchor=_read_equilibrium(f["anchor"]),
        )
        return out, str(f.attrs["config_key"])


def write_edge_checkpoint(path, config_key, result_a, result_b, area_a,
                          area_b, wa, wb, history, in_a, conv,
                          finite) -> str:
    """Checkpoint of an :func:`~energybalancemodel_jl_tpu_torch.basins.edge`
    search: the two converged endpoint attractors (io.py equilibrium
    schema), their classification reference areas, the current
    per-member weight brackets, and the per-step histories. Everything a
    probe's outcome depends on is in the file, so a resume replays the
    remaining bisection steps bit-exactly and never re-pays the endpoint
    solves. Atomic whole-file tmp+rename writes, like the fold writer."""
    from .io import _write_equilibrium

    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["__ebm_type__"] = "EdgeCheckpoint"
        f.attrs["format"] = _FORMAT
        f.attrs["config_key"] = config_key
        f.attrs["n_done"] = int(np.shape(history)[0])
        for name, arr in (("wa", wa), ("wb", wb),
                          ("area_a", area_a), ("area_b", area_b)):
            f.create_dataset(name, data=np.asarray(arr, dtype=np.float64))
        f.create_dataset("history", data=np.asarray(history))
        f.create_dataset("in_a", data=np.asarray(in_a))
        f.create_dataset("probe_converged", data=np.asarray(conv))
        f.create_dataset("probe_finite", data=np.asarray(finite))
        _write_equilibrium(f.create_group("result_a"), result_a)
        _write_equilibrium(f.create_group("result_b"), result_b)
    os.replace(tmp, path)
    return path


def read_edge_checkpoint(path: str):
    """Read an edge checkpoint; returns ``(state_dict, config_key)``."""
    from .io import _read_equilibrium

    with h5py.File(path, "r") as f:
        if f.attrs.get("__ebm_type__") != "EdgeCheckpoint":
            raise ValueError(f"{path} is not an edge checkpoint")
        if "probe_finite" not in f:  # pre-r3 file: resume restarts fresh
            raise ValueError(f"{path} predates the probe_finite record")
        n = int(f.attrs["n_done"])
        out = dict(
            wa=np.asarray(f["wa"]),
            wb=np.asarray(f["wb"]),
            area_a=np.asarray(f["area_a"]),
            area_b=np.asarray(f["area_b"]),
            history=np.asarray(f["history"])[:n],
            in_a=np.asarray(f["in_a"], dtype=bool)[:n],
            conv=np.asarray(f["probe_converged"], dtype=bool)[:n],
            finite=np.asarray(f["probe_finite"], dtype=bool)[:n],
            result_a=_read_equilibrium(f["result_a"]),
            result_b=_read_equilibrium(f["result_b"]),
        )
        return out, str(f.attrs["config_key"])


def digest_array(a) -> str:
    """16-hex-char digest of an array's float64 bytes (bracket ends,
    sweep leaves — anything a search fingerprint must pin exactly)."""
    b = np.ascontiguousarray(np.asarray(_host(a), dtype=np.float64))
    return hashlib.sha1(b.tobytes()).hexdigest()[:16]


def digest_collection(c) -> str:
    """16-hex-char digest of a state Collection (key-sorted leaves)."""
    h = hashlib.sha1()
    for k in sorted(c.keys()):
        h.update(str(k).encode())
        h.update(np.ascontiguousarray(
            np.asarray(_host(c[k]), dtype=np.float64)).tobytes())
    return h.hexdigest()[:16]


def key_kwargs(kwargs) -> dict:
    """The pass-through keywords of a driver as the JAX package sees them:
    ``device`` (where the run goes, not what it computes; the JAX package
    has no such keyword) is left out, and a ``torch.dtype`` becomes its
    numpy name (``torch.float64`` -> ``'float64'``), so the keys of the two
    packages agree for the same call."""
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        out[k] = str(v).rsplit(".", 1)[-1] if isinstance(v, torch.dtype) else v
    return out


def _host(v):
    """A parameter leaf as host numpy (a tensor is copied off its device)."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return v


def search_key(prefix, model, st, forcing, par, equilibrate_kwargs,
               extras=()) -> str:
    """Config fingerprint shared by the bisection searches
    (:func:`~energybalancemodel_jl_tpu_torch.fold.fold`,
    :func:`~energybalancemodel_jl_tpu_torch.basins.edge`): the common driver
    key plus a digest of the pass-through equilibrate options
    (:func:`key_kwargs`). Both callers deliberately EXCLUDE ``steps`` so a
    resume may extend a refinement; everything that changes a probe's
    outcome must ride in ``extras``.

    Array-valued kwargs go through :func:`digest_array`, never ``repr``:
    numpy reprs elide large arrays with ``...``, so two different arrays
    could hash identically and a resume would silently reuse a checkpoint
    from a different configuration."""
    equilibrate_kwargs = key_kwargs(equilibrate_kwargs)

    def _rep(v):
        if isinstance(v, np.ndarray) or torch.is_tensor(v):
            a = np.asarray(_host(v))
            if a.dtype != object:
                return f"array{a.shape}#{digest_array(a)}"
        return repr(v)

    kw = ",".join(f"{k}={_rep(equilibrate_kwargs[k])}"
                  for k in sorted(equilibrate_kwargs))
    return config_key(
        prefix, model, st, forcing, par,
        str(equilibrate_kwargs.get("dtype", "auto")), "",
        int(equilibrate_kwargs.get("newton_max_iter", 30)),
        extras=(*extras,
                f"kw={hashlib.sha1(kw.encode()).hexdigest()[:16]}"),
    )


def try_resume_search(checkpoint, key, kind, reader):
    """The bisection searches' shared resume block: validate the file's
    kind and config key, then load its state dict; a present-but-
    mismatched (or torn/corrupt) file warns and returns ``None`` (start
    fresh)."""
    resumed = None
    try:
        if checkpoint_matches(checkpoint, key, kind=kind):
            resumed = reader(checkpoint)[0]
    except (OSError, ValueError):  # torn/corrupt file: start fresh
        resumed = None
    if resumed is None and os.path.exists(checkpoint):
        warnings.warn(
            f"Checkpoint {checkpoint} does not match this search's "
            "configuration; starting fresh."
        )
    return resumed


def config_key(prefix, model, st, forcing, par, dtype_name, solver,
               newton_max_iter, extras=()) -> str:
    """Config fingerprint shared by every per-year driver (``integrate``,
    ``ensemble_integrate``, ``spatial_integrate``).

    A resume silently continues any run whose key matches, so the key must
    cover EVERYTHING that changes the computed trajectory: model, grid,
    forcing (lossless repr), parameters (swept ``(K,)`` leaves are digested
    from their host values, scalars stay readable), dtype (its numpy name),
    solver, and the Newton iteration cap (a cap change alters non-converged
    steps).
    Driver-specific graph choices (engine, chunking, mesh size) ride in
    ``prefix``/``extras``.
    """
    def leaf(k, v):
        a = np.asarray(_host(v), dtype=np.float64)
        if a.ndim == 0:
            return f"{k}={float(a)}"
        digest = hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()
        return f"{k}#{a.shape}:{digest[:16]}"

    pars = ",".join(leaf(k, v) for k, v in sorted(par.items()))
    parts = [prefix, model, repr(st), repr(forcing), pars, dtype_name,
             solver, f"ni={int(newton_max_iter)}", *extras]
    return "|".join(p for p in parts if p)


def resume_state(checkpoint, key, resume, raw_mode, dur, to_device, carry):
    """The per-year drivers' common resume block: validate the key, load the
    carry + seasonal accumulators, and emit the standard warnings.

    ``to_device`` maps one host array leaf back to a contiguous tensor of
    the run's dtype on its device; the seasonal accumulators of the
    completed years go through it too, so the year loop's tensors stack
    with them. Returns ``(carry, start_year, winter_acc, summer_acc,
    avg_acc)`` — the inputs unchanged plus empty accumulators when there is
    nothing to resume.
    """
    winter_acc, summer_acc, avg_acc = [], [], []
    start_year = 0
    if resume:
        if raw_mode == "all":
            raise ValueError(
                "resume is not supported with raw_mode='all' (per-step raw "
                "data of completed years is not checkpointed)"
            )
        if checkpoint_matches(checkpoint, key):
            c_np, start_year, (winter_acc, summer_acc, avg_acc), _ = (
                read_checkpoint(checkpoint)
            )
            winter_acc, summer_acc, avg_acc = (
                [Collection({k: to_device(v) for k, v in c.items()})
                 for c in acc]
                for acc in (winter_acc, summer_acc, avg_acc)
            )
            carry = Collection({k: to_device(v) for k, v in c_np.items()})
        elif os.path.exists(checkpoint):
            warnings.warn(
                f"Checkpoint {checkpoint} does not match this run's "
                "configuration; starting from init."
            )
        if start_year >= dur and raw_mode == "last":
            warnings.warn(
                "Resuming an already-completed run: per-step raw data is "
                "not checkpointed, so the returned Solutions has empty "
                "raw storage (seasonal storage is complete)."
            )
    return carry, start_year, winter_acc, summer_acc, avg_acc


def fetch_host(tree):
    """Every tensor leaf of ``tree`` (nested lists, tuples and mappings) as
    numpy: one stream sync, then one device-to-host copy per dtype of all
    CUDA leaves packed into one flat buffer. Host leaves pass through."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
        elif torch.is_tensor(node) and node.device.type != "cpu":
            leaves.append(node)

    collect(tree)
    host = {}
    if leaves:
        torch.cuda.current_stream(leaves[0].device).synchronize()
        by_dtype = {}
        for t in leaves:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group]).cpu().numpy()
            i = 0
            for t in group:
                n = t.numel()
                host[id(t)] = flat[i:i + n].reshape(tuple(t.shape))
                i += n

    def rebuild(node):
        if isinstance(node, dict):
            return Collection({k: rebuild(v) for k, v in node.items()})
        if isinstance(node, tuple):
            return tuple(rebuild(v) for v in node)
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        if torch.is_tensor(node):
            return host[id(node)] if id(node) in host else node.detach().numpy()
        return np.asarray(node)

    return rebuild(tree)


def year_writer(checkpoint, key, get_state):
    """Writer closure shared by the per-year drivers. ``get_state`` returns
    the CURRENT ``(carry, (winter_acc, summer_acc, avg_acc))`` (the drivers
    rebind ``carry`` every year, so it must be read at write time); the
    fetch is one bulk copy (:func:`fetch_host`)."""

    def _write(years_done):
        carry, accs = get_state()
        carry_np, accs_np = fetch_host((carry, accs))
        write_checkpoint(
            checkpoint, Collection(carry_np), years_done, accs_np, key
        )

    return _write


def checkpoint_matches(path: str, config_key: str,
                       kind: str = "Checkpoint") -> bool:
    if not os.path.exists(path):
        return False
    with h5py.File(path, "r") as f:
        return (
            f.attrs.get("__ebm_type__") == kind
            and str(f.attrs.get("config_key")) == config_key
        )
