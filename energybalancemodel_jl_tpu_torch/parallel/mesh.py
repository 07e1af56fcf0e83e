"""A mesh of shards and its collectives: the port's counterpart of
``jax.sharding.Mesh``, ``jax.shard_map`` and the ``lax`` collectives that
the JAX package's multi-device modules use.

One process drives every shard, as one JAX controller drives a mesh of local
devices. A :class:`Mesh` is a 1-D or 2-D array of ``torch.device``\\ s with a
name per axis; a device may repeat, which is how one card (or the CPU) runs a
mesh of 4 or 8 shards. :func:`shard_map` splits its inputs by partition
specs (:class:`P`, one mesh axis or ``None`` per tensor dimension), runs the
function once per shard, each in a Python thread of its own with that
shard's device and (on a GPU) a CUDA stream of its own current, and
reassembles the outputs. Inside the function the collectives
(:func:`psum`, :func:`pmax`, :func:`pmin`, :func:`all_gather`,
:func:`ppermute`, :func:`ring_neighbors`, :func:`axis_index`,
:func:`axis_size`) resolve against the calling shard: every shard of the
group writes its value to a slot, a ``threading.Barrier`` lets them read
each other's, and on a GPU a CUDA event recorded by the producer is waited
on by the consumer's stream. Reductions run in shard-index order, so a run
repeats bitwise. A shard that raises aborts the barriers, and the caller
gets that exception.

The shards' host code runs one shard at a time: a shard holds the run's
token while it runs and hands it on only while it waits at a collective.
PyTorch releases the interpreter lock around every operation, and shards
that ran their small operations at once would spend most of their time
handing that lock back and forth (measured on the CPU: four threads of
16-element operations take ~20x one thread's time per operation); their
device work still runs concurrently, on their own streams.

Collectives follow the SPMD contract of ``shard_map``: every shard of a group
calls the same collectives in the same order. The shards of two GPUs
exchange tensors by peer copies; only meshes on one card (and on the CPU)
are checked by the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Sequence

import numpy as np
import torch

from ..solutions import Seasonal

__all__ = ["Mesh", "P", "shard_map", "psum", "pmax", "pmin", "all_gather", "ppermute",
           "ring_neighbors", "axis_index", "axis_size", "mesh_devices"]


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: entry ``d`` names
    the mesh axis that tensor dimension ``d`` is split over, or ``None``;
    dimensions past the spec are whole. ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Mesh:
    """A 1-D or 2-D array of devices with a name per axis.

    ``devices`` is a (nested) sequence of ``torch.device``\\ s or device
    strings; the same device may appear more than once (each entry is a shard
    of its own). ``shape`` maps each axis name to its size, ``size`` is the
    number of shards, ``devices`` the numpy array of ``torch.device``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.ndim not in (1, 2) or arr.size == 0:
            raise ValueError(
                f"a mesh is a non-empty 1-D or 2-D array of devices with one name per "
                f"axis; got shape {arr.shape} and axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must differ, got {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            dev = torch.device(arr[idx])
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.devices[idx] = dev
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices are all CPU or all CUDA, got {sorted(kinds)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.size = int(arr.size)
        self._streams = None
        self._lock = threading.Lock()

    @property
    def is_cuda(self) -> bool:
        return self.devices.flat[0].type == "cuda"

    def streams(self):
        """One CUDA stream per shard (row-major), made at first use."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device=d) for d in self.devices.flat]
            return self._streams

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def mesh_devices(n_devices=None, device=None):
    """The device list of a mesh: ``device`` (one device, or a sequence) or,
    when ``None``, every CUDA device; a RuntimeError names ``device="cpu"``
    when there is none, as every entry point's ``device=None`` does. With
    ``n_devices`` the list is cycled to that many shards, so a mesh of 4 on
    one card is ``mesh_devices(4)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh runs on the GPUs by default; pass device=\"cpu\" "
                "(or build Mesh([torch.device('cpu')] * n, ...)) for a mesh on the CPU")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(device, (str, torch.device)):
        devs = [torch.device(device)]
    else:
        devs = [torch.device(d) for d in device]
    if n_devices is None:
        return devs
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got n_devices={n}")
    return [devs[i % len(devs)] for i in range(n)]


# ---------------------------------------------------------------------------
# the shard a thread runs, and the groups its collectives meet in


class _Barrier:
    """A barrier for shards that hold the run's token: a waiting shard hands
    the token on, and the last to arrive keeps it and runs on, so a
    collective costs one hand-over fewer than with ``threading.Barrier``."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.count = 0
        self.generation = 0
        self.broken = False

    def wait(self, token) -> None:
        with self.cond:
            if self.broken:
                raise threading.BrokenBarrierError
            self.count += 1
            if self.count == self.n:
                self.count = 0
                self.generation += 1
                self.cond.notify_all()
                return
            generation = self.generation
        token.release()
        try:
            with self.cond:
                while self.generation == generation and not self.broken:
                    self.cond.wait()
                if self.generation == generation:
                    raise threading.BrokenBarrierError
        finally:
            token.acquire()

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()


class _Group:
    """The shards that share their coordinates on every mesh axis but the
    collective's: a barrier and two sets of slots, used in turn, so one
    barrier per collective suffices (a shard can write a set again only
    after every shard has passed the next barrier, and so has read it)."""

    def __init__(self, n: int):
        self.barrier = _Barrier(n)
        self.slots = ([None] * n, [None] * n)
        self.turn = [0] * n  # each member's count of collectives, mod 2


class _Run:
    """The shared state of one :func:`shard_map` call: the groups, made at
    first use, the token that one shard's host code holds at a time, and the
    first failure."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.lock = threading.Lock()
        self.token = threading.Lock()
        self.groups = {}
        self.error = None

    def group(self, axes, coords) -> _Group:
        """The group of shards that share ``coords`` on every axis not in
        ``axes``."""
        key = (axes, tuple(c for a, c in zip(self.mesh.axis_names, coords) if a not in axes))
        with self.lock:
            g = self.groups.get(key)
            if g is None:
                g = self.groups[key] = _Group(math.prod(self.mesh.shape[a] for a in axes))
                if self.error is not None:
                    g.barrier.abort()
            return g

    def fail(self, err):
        with self.lock:
            if self.error is None:
                self.error = err
            barriers = [g.barrier for g in self.groups.values()]
        for b in barriers:
            b.abort()


class _Shard:
    def __init__(self, run: _Run, coords, device, stream):
        self.run = run
        self.coords = coords
        self.device = device
        self.stream = stream


_local = threading.local()


def _shard() -> _Shard:
    s = getattr(_local, "shard", None)
    if s is None:
        raise RuntimeError("a collective was called outside shard_map")
    return s


def _axes(axis_name):
    s = _shard()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    unknown = [a for a in names if a not in s.run.mesh.axis_names]
    if unknown or not names:
        raise ValueError(f"unknown mesh axes {unknown or names}; the mesh has "
                         f"{s.run.mesh.axis_names}")
    # mesh order: a shard's position in the group is row-major over them
    return s, tuple(a for a in s.run.mesh.axis_names if a in names)


def _position(s: _Shard, axes) -> int:
    pos = 0
    for a, c in zip(s.run.mesh.axis_names, s.coords):
        if a in axes:
            pos = pos * s.run.mesh.shape[a] + c
    return pos


def _exchange(axis_name, value):
    """Every value of the group, in shard order, as the producers left them
    (tensors with the CUDA event that completes them), and this shard's
    position in the group."""
    s, axes = _axes(axis_name)
    g = s.run.group(axes, s.coords)
    pos = _position(s, axes)
    event = None
    if torch.is_tensor(value) and value.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
    slots = g.slots[g.turn[pos]]
    g.turn[pos] ^= 1
    slots[pos] = (value, event)
    g.barrier.wait(s.run.token)  # the other shards run while this one waits
    return list(slots), pos


def _receive(item):
    """A value another shard produced, usable on this shard's device and
    stream: the stream waits for the producer's event, and the tensor is
    marked in use by this stream (or copied to this shard's device)."""
    value, event = item
    if not torch.is_tensor(value):
        return value
    dev = _shard().device
    if event is not None:
        torch.cuda.current_stream(dev).wait_event(event)
        if value.device == dev:
            value.record_stream(torch.cuda.current_stream(dev))
            return value
        torch.cuda.current_stream(value.device).wait_event(event)
    return value.to(dev)


def _reduce(axis_name, x, op):
    got, _ = _exchange(axis_name, x)
    vals = [_receive(item) for item in got]
    acc = vals[0]
    for v in vals[1:]:  # shard order: every shard rounds alike
        acc = op(acc, v)
    return acc


def psum(x, axis_name):
    """Sum of ``x`` over the shards of ``axis_name`` (a name or a tuple of
    names), added in shard order; ``psum(1, axis)`` is the axis size."""
    return _reduce(axis_name, x, lambda a, b: a + b)


def pmax(x, axis_name):
    """Elementwise maximum over the shards (NaN-propagating for tensors);
    Python booleans and numbers reduce with ``max``."""
    return _reduce(axis_name, x, lambda a, b: torch.maximum(a, b) if torch.is_tensor(a)
                   else max(a, b))


def pmin(x, axis_name):
    """Elementwise minimum over the shards (see :func:`pmax`)."""
    return _reduce(axis_name, x, lambda a, b: torch.minimum(a, b) if torch.is_tensor(a)
                   else min(a, b))


def all_gather(x, axis_name):
    """The shards' ``x`` stacked along a new leading axis, in shard order
    (``lax.all_gather`` with ``axis=0, tiled=False``)."""
    got, _ = _exchange(axis_name, x)
    return torch.stack([_receive(item) for item in got])


def ppermute(x, axis_name, perm):
    """``x`` of the shard that ``perm`` (pairs ``(source, destination)`` of
    indices along ``axis_name``) names as this shard's source; zeros where
    no pair ends here (``lax.ppermute``)."""
    got, pos = _exchange(axis_name, x)
    src = [a for a, b in perm if b == pos]
    if len(src) > 1:
        raise ValueError(f"ppermute: shard {pos} receives from {src}; a permutation "
                         "sends to each shard at most once")
    return _receive(got[src[0]]) if src else torch.zeros_like(x)


def ring_neighbors(x, axis_name):
    """``(x of the previous shard, x of the next shard)`` along
    ``axis_name``, on a ring: the two ``ppermute`` calls of a halo exchange in
    one collective."""
    got, pos = _exchange(axis_name, x)
    n = len(got)
    return _receive(got[(pos - 1) % n]), _receive(got[(pos + 1) % n])


def axis_index(axis_name) -> int:
    """This shard's index along the mesh axis ``axis_name``."""
    s = _shard()
    return s.coords[s.run.mesh.axis_names.index(axis_name)]


def axis_size(axis_name) -> int:
    """The number of shards along ``axis_name`` (a name or tuple of names)."""
    s, axes = _axes(axis_name)
    return math.prod(s.run.mesh.shape[a] for a in axes)


# ---------------------------------------------------------------------------
# splitting and reassembling pytrees


def _is_spec(x):
    return isinstance(x, P) or x is None


def _map(fn, spec, value, path=()):
    """``fn(spec_leaf, value_leaf)`` over ``value``, with ``spec`` a prefix
    of its tree (a :class:`P` covers a whole subtree, as in ``shard_map``)."""
    if _is_spec(spec):
        return _map_leaves(lambda v: fn(spec, v), value)
    if isinstance(spec, dict):
        if not isinstance(value, dict) or set(spec) != set(value):
            raise ValueError(f"spec keys {sorted(spec)} do not match the value's at {path}")
        return type(value)({k: _map(fn, spec[k], value[k], path + (k,)) for k in value})
    if isinstance(spec, tuple):
        if not isinstance(value, tuple) or len(spec) != len(value):
            raise ValueError(f"spec {spec!r} does not match the value at {path}")
        items = [_map(fn, s, v, path + (i,)) for i, (s, v) in enumerate(zip(spec, value))]
        return type(value)(*items) if isinstance(value, Seasonal) else type(value)(items)
    raise TypeError(f"not a partition spec: {spec!r}")


def _map_leaves(fn, value):
    if isinstance(value, dict):
        return type(value)({k: _map_leaves(fn, v) for k, v in value.items()})
    if isinstance(value, Seasonal):
        return Seasonal(*(_map_leaves(fn, v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_map_leaves(fn, v) for v in value)
    return fn(value)


def _dims(spec: P, mesh: Mesh, shape):
    """axis name -> tensor dimension it splits, checked against ``shape``."""
    dims = {}
    for d, a in enumerate(spec):
        if a is None:
            continue
        if a not in mesh.shape:
            raise ValueError(f"spec {spec!r} names axis {a!r}; the mesh has {mesh.axis_names}")
        if a in dims:
            raise ValueError(f"spec {spec!r} names axis {a!r} twice")
        if d >= len(shape):
            raise ValueError(f"spec {spec!r} splits dimension {d} of a shape {tuple(shape)}")
        if shape[d] % mesh.shape[a]:
            raise ValueError(
                f"dimension {d} of size {shape[d]} does not divide evenly over the "
                f"{mesh.shape[a]} shards of mesh axis {a!r}")
        dims[a] = d
    return dims


def _split(spec, value, mesh: Mesh, coords, device):
    """This shard's block of a leaf: a tensor sliced and moved to the
    shard's device, a numpy array sliced (host data, such as key words),
    anything else as it is."""
    if not (torch.is_tensor(value) or isinstance(value, np.ndarray)):
        return value
    index = [slice(None)] * value.ndim
    for a, d in _dims(spec, mesh, value.shape).items():
        n = value.shape[d] // mesh.shape[a]
        c = coords[mesh.axis_names.index(a)]
        index[d] = slice(c * n, (c + 1) * n)
    value = value[tuple(index)]
    return value.to(device) if torch.is_tensor(value) else value


def _assemble(spec, pieces: dict, mesh: Mesh, home):
    """One output leaf from the shards' pieces (``coords -> piece``):
    concatenated along the dimensions its spec splits, the first shard's
    piece along the mesh axes it does not name."""
    first = pieces[(0,) * len(mesh.axis_names)]
    if not torch.is_tensor(first):
        return first
    full = list(first.shape)
    for d, a in enumerate(spec):
        if a is not None and d < len(full):
            full[d] *= mesh.shape.get(a, 1)
    dims = _dims(spec, mesh, full)

    def rec(level, coords):
        if level == len(mesh.axis_names):
            return pieces[tuple(coords)].to(home)
        a = mesh.axis_names[level]
        if a not in dims:
            return rec(level + 1, coords + [0])
        parts = [rec(level + 1, coords + [i]) for i in range(mesh.shape[a])]
        return torch.cat(parts, dim=dims[a])

    return rec(0, [])


def _tensors(tree):
    out = []
    _map_leaves(lambda v: out.append(v) if torch.is_tensor(v) else None, tree)
    return out


def _gather(spec, outs, mesh: Mesh, coords_list, home):
    """The reassembled output tree from each shard's output tree."""
    first = outs[0]
    if _is_spec(spec):
        if isinstance(first, (dict, tuple, list)) and not torch.is_tensor(first):
            if isinstance(first, dict):
                return type(first)({k: _gather(spec, [o[k] for o in outs], mesh,
                                               coords_list, home) for k in first})
            items = [_gather(spec, [o[i] for o in outs], mesh, coords_list, home)
                     for i in range(len(first))]
            return type(first)(*items) if isinstance(first, Seasonal) else type(first)(items)
        return _assemble(spec or P(), dict(zip(coords_list, outs)), mesh, home)
    if isinstance(spec, dict):
        return type(first)({k: _gather(spec[k], [o[k] for o in outs], mesh, coords_list, home)
                            for k in first})
    if isinstance(spec, tuple):
        if len(spec) != len(first):
            raise ValueError(f"out_specs {spec!r} do not match an output of {len(first)} items")
        items = [_gather(s, [o[i] for o in outs], mesh, coords_list, home)
                 for i, s in enumerate(spec)]
        return type(first)(*items) if isinstance(first, Seasonal) else type(first)(items)
    raise TypeError(f"not a partition spec: {spec!r}")


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """``fn`` run once per shard of ``mesh`` on its part of the inputs
    (``jax.shard_map``).

    ``in_specs`` holds one spec tree per positional argument, ``out_specs``
    one for the output (a tuple of them for a tuple output); a :class:`P`
    stands for every leaf below it. A tensor leaf is split along the
    dimensions its spec names and moved to the shard's device, a numpy array
    split and left on the host; any other leaf (a scalar, None, a string)
    goes to every shard as it is. An
    output leaf is concatenated from the shards along the dimensions its
    spec names, and taken from the first shard along the mesh axes the spec
    does not name (a replicated value); it lands on the first shard's
    device. Grad mode is the caller's in every shard.

    Each shard runs in a thread of its own with its device current and, on
    a GPU, a stream of its own (the mesh's), ordered after the caller's
    current stream; the caller's stream then waits for every shard's. The
    first exception a shard raises aborts the collectives of the others and
    is raised to the caller once every shard's thread has ended."""
    in_specs = tuple(in_specs) if isinstance(in_specs, (list, tuple)) and not isinstance(
        in_specs, P) else (in_specs,)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for {len(in_specs)} in_specs")
        coords_list = list(itertools.product(*(range(n) for n in mesh.devices.shape)))
        devices = [mesh.devices[c] for c in coords_list]
        home = devices[0]
        local = [tuple(_map(lambda s, v, c=c, d=d: _split(s, v, mesh, c, d), spec, a)
                       for spec, a in zip(in_specs, args))
                 for c, d in zip(coords_list, devices)]
        run = _Run(mesh)
        outs = [None] * len(coords_list)
        grad = torch.is_grad_enabled()
        streams = callers = None
        if mesh.is_cuda:
            streams = mesh.streams()
            callers = {d: torch.cuda.current_stream(d) for d in set(devices)}
            for s, d in zip(streams, devices):
                s.wait_stream(callers[d])

        def body(i):
            shard = _Shard(run, coords_list[i], devices[i], streams[i] if streams else None)
            _local.shard = shard
            run.token.acquire()
            try:
                with torch.set_grad_enabled(grad):
                    if streams is None:
                        outs[i] = fn(*local[i])
                    else:
                        with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
                            outs[i] = fn(*local[i])
            except BaseException as err:  # noqa: BLE001 - raised to the caller below
                # a broken barrier is the echo of another shard's failure
                if not isinstance(err, threading.BrokenBarrierError):
                    run.fail(err)
                outs[i] = err
            finally:
                _local.shard = None
                run.token.release()

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"shard{coords_list[i]}")
                   for i in range(len(coords_list))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if streams is not None:
            for s, d in zip(streams, devices):
                callers[d].wait_stream(s)
        if run.error is not None:
            raise run.error
        broken = [o for o in outs if isinstance(o, BaseException)]
        if broken:
            raise broken[0]
        if streams is not None:
            for o, d in zip(outs, devices):
                for t in _tensors(o):
                    if t.is_cuda:
                        t.record_stream(callers[t.device])
        return _gather(out_specs, outs, mesh, coords_list, home)

    return mapped
