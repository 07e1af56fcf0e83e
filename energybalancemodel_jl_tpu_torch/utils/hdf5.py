"""HDF5 files without h5py: a numpy-only writer and reader of the subset of
the format that the port's files use.

``h5py`` below is the real module where it is installed; where it is not, it
is this module's stand-in, which offers the part of h5py's interface that
:mod:`..io` and :mod:`..checkpoint` call (``File`` in modes ``'r'``, ``'w'``
and ``'a'``, groups, attributes, datasets). Its files are genuine HDF5
(superblock version 2, version 2 object headers, groups with compact link
storage, contiguous datasets, variable-length UTF-8 string attributes in one
global heap), so h5py reads them and the JAX package loads them. It reads
only files of that layout, the ones it wrote: a file from libhdf5 raises
``ValueError``.

Types: floats, signed and unsigned integers, ``bool`` (h5py's enum of int8),
``complex`` (h5py's compound of ``r`` and ``i``), and ``str`` attributes.
A file is held in memory while it is open; ``'w'`` and ``'a'`` write it out
whole on close.
"""
from __future__ import annotations

import struct
import types

import numpy as np

__all__ = ["h5py", "lite"]

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
_HEAP_MIN = 4096


# -- Bob Jenkins' lookup3 hashlittle: the checksum of HDF5's metadata -------

def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    M = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & M
    i = 0
    while n > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M
        a = (a - c) & M; a ^= _rot(c, 4); c = (c + b) & M
        b = (b - a) & M; b ^= _rot(a, 6); a = (a + c) & M
        c = (c - b) & M; c ^= _rot(b, 8); b = (b + a) & M
        a = (a - c) & M; a ^= _rot(c, 16); c = (c + b) & M
        b = (b - a) & M; b ^= _rot(a, 19); a = (a + c) & M
        c = (c - b) & M; c ^= _rot(b, 4); b = (b + a) & M
        i += 12
        n -= 12
    if n == 0:
        return c
    tail = data[i:] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & M
    b = (b + int.from_bytes(tail[4:8], "little")) & M
    c = (c + int.from_bytes(tail[8:12], "little")) & M
    c ^= b; c = (c - _rot(b, 14)) & M
    a ^= c; a = (a - _rot(c, 11)) & M
    b ^= a; b = (b - _rot(a, 25)) & M
    c ^= b; c = (c - _rot(b, 16)) & M
    a ^= c; a = (a - _rot(c, 4)) & M
    b ^= a; b = (b - _rot(a, 14)) & M
    c ^= b; c = (c - _rot(b, 24)) & M
    return c


# -- the in-memory tree --------------------------------------------------

class AttributeManager(dict):
    """A node's attributes: a dict whose values come back as h5py gives
    them (numpy scalars and arrays, ``str``)."""

    def __setitem__(self, key, value):
        super().__setitem__(str(key), _attr_value(value))

    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v


def _attr_value(v):
    if isinstance(v, str):
        return v
    a = np.asarray(v)
    return a[()] if a.ndim == 0 else a


class Dataset:
    def __init__(self, data):
        self._data = data
        self.attrs = AttributeManager()

    shape = property(lambda self: self._data.shape)
    ndim = property(lambda self: self._data.ndim)
    dtype = property(lambda self: self._data.dtype)

    def __array__(self, dtype=None, copy=None):
        return self._data if dtype is None else self._data.astype(dtype)

    def __getitem__(self, idx):
        return self._data[idx]


class Group:
    def __init__(self):
        self._links = {}
        self.attrs = AttributeManager()

    def _walk(self, path, create=False):
        node = self
        parts = [p for p in str(path).split("/") if p]
        for p in parts[:-1]:
            if p not in node._links:
                if not create:
                    raise KeyError(path)
                node._links[p] = Group()
            node = node._links[p]
        return node, parts[-1]

    def __getitem__(self, path):
        node, name = self._walk(path)
        if name not in node._links:
            raise KeyError(f"{path!r} is not in the file")
        return node._links[name]

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __delitem__(self, path):
        node, name = self._walk(path)
        del node._links[name]

    def keys(self):
        return sorted(self._links)  # h5py lists links by name

    def items(self):
        return [(k, self._links[k]) for k in self.keys()]

    def create_group(self, path):
        node, name = self._walk(path, create=True)
        if name in node._links:
            raise ValueError(f"{path!r} already exists")
        node._links[name] = Group()
        return node._links[name]

    def create_dataset(self, path, data=None, dtype=None):
        node, name = self._walk(path, create=True)
        if name in node._links:
            raise ValueError(f"{path!r} already exists")
        arr = np.array(data, dtype=dtype)
        if arr.dtype.kind not in "biufc":
            raise TypeError(f"dataset {path!r}: dtype {arr.dtype} is not supported")
        node._links[name] = Dataset(arr)  # np.array copies C-contiguous, 0-d kept
        return node._links[name]

    def flush(self):
        pass


class File(Group):
    def __init__(self, path, mode="r"):
        super().__init__()
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: expected 'r', 'w' or 'a'")
        self.filename, self.mode = str(path), mode
        if mode in ("r", "a"):
            try:
                with open(self.filename, "rb") as f:
                    buf = f.read()
            except FileNotFoundError:
                if mode == "r":
                    raise
                buf = None
            if buf is not None:
                root = _Reader(buf).root()
                self._links, self.attrs = root._links, root.attrs

    def close(self):
        if self.mode in ("w", "a"):
            _write(self.filename, self)
            self.mode = "r"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        return False


# -- datatypes -------------------------------------------------------------

def _fixed(size, signed):
    return (struct.pack("<B3sI", 0x10, bytes([0x08 if signed else 0x00, 0, 0]), size)
            + struct.pack("<HH", 0, 8 * size))


def _float(size):
    exp_loc, exp_size, mant_size, bias = ((23, 8, 23, 127) if size == 4
                                          else (52, 11, 52, 1023))
    return (struct.pack("<B3sI", 0x11, bytes([0x20, 8 * size - 1, 0]), size)
            + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0, mant_size, bias))


def _pad8(b):
    return b + bytes(-len(b) % 8)


def _dtype_message(dt: np.dtype) -> bytes:
    if dt.kind == "f":
        return _float(dt.itemsize)
    if dt.kind in "iu":
        return _fixed(dt.itemsize, dt.kind == "i")
    if dt.kind == "b":  # h5py's bool: an enum of int8, FALSE = 0, TRUE = 1
        names = _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
        return (struct.pack("<B3sI", 0x18, struct.pack("<H", 2) + b"\0", 1)
                + _fixed(1, True) + names + bytes([0, 1]))
    if dt.kind == "c":  # h5py's complex: a compound of r and i
        half = dt.itemsize // 2
        members = b"".join(_pad8(name + b"\0") + struct.pack("<I", off) + _float(half)
                           for name, off in ((b"r", 0), (b"i", half)))
        return struct.pack("<B3sI", 0x26, struct.pack("<H", 2) + b"\0", dt.itemsize) + members
    raise TypeError(f"dtype {dt} is not supported")


# variable-length UTF-8 string, null-terminated, of unsigned bytes
_VLEN_STR = struct.pack("<B3sI", 0x19, bytes([0x01, 0x01, 0]), 16) + (
    struct.pack("<B3sI", 0x10, bytes(3), 1) + struct.pack("<HH", 0, 8))


def _dataspace(shape) -> bytes:
    kind = 0 if len(shape) == 0 else 1
    return struct.pack("<BBBB", 2, len(shape), 0, kind) + b"".join(
        struct.pack("<Q", int(n)) for n in shape)


# -- writer -------------------------------------------------------------------

class _Out:
    def __init__(self):
        self.parts, self.pos = [], 48  # the superblock goes first

    def put(self, b) -> int:
        addr = self.pos
        self.parts.append(b)
        self.pos += len(b)
        return addr


def _message(mtype, body):
    if len(body) > 0xFFFF:
        raise ValueError("an object header message is larger than 64 KiB")
    return struct.pack("<BHB", mtype, len(body), 0) + body


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    head = b"OHDR" + struct.pack("<BBI", 2, 0x02, len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _strings(node, out):
    for v in node.attrs.values():
        if isinstance(v, str):
            out.append(v)
    if isinstance(node, Group):
        for child in node._links.values():
            _strings(child, out)


def _attributes(node, heap):
    msgs = []
    for name, v in node.attrs.items():
        nm = name.encode() + b"\0"
        if isinstance(v, str):
            dtm, dsm = _VLEN_STR, _dataspace(())
            addr, idx, n = heap[v]
            data = struct.pack("<IQI", n, addr, idx)
        else:
            a = np.array(v, order="C")
            dtm, dsm = _dtype_message(a.dtype), _dataspace(a.shape)
            data = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        msgs.append(_message(0x0C, struct.pack("<BBHHHB", 3, 0, len(nm), len(dtm), len(dsm), 1)
                             + nm + dtm + dsm + data))
    return msgs


def _put_node(node, out, heap) -> int:
    if isinstance(node, Dataset):
        a = node._data
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        addr = out.put(raw) if raw else UNDEF
        msgs = [_message(0x01, _dataspace(a.shape)),
                _message(0x03, _dtype_message(a.dtype)),
                _message(0x05, bytes([3, 0x0A])),  # fill value: late, if set
                _message(0x08, struct.pack("<BBQQ", 3, 1, addr, len(raw)))]
    else:
        links = [(name, _put_node(node._links[name], out, heap)) for name in node.keys()]
        msgs = [_message(0x02, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF)),
                _message(0x0A, bytes([0, 0]))]
        for name, addr in links:
            nm = name.encode()
            if len(nm) > 255:
                raise ValueError(f"link name {name!r} is longer than 255 bytes")
            msgs.append(_message(0x06, struct.pack("<BBB", 1, 0, len(nm)) + nm
                                 + struct.pack("<Q", addr)))
    return out.put(_object_header(msgs + _attributes(node, heap)))


def _write(path, root):
    out = _Out()
    strings = []
    _strings(root, strings)
    heap = {}
    if strings:
        objs, idx = b"", 0
        for s in dict.fromkeys(strings):
            idx += 1
            data = s.encode()
            objs += struct.pack("<HHIQ", idx, 1, 0, len(data)) + _pad8(data)
            heap[s] = (idx, len(data))
        size = max(_HEAP_MIN, 16 + len(objs) + 16)
        free = size - 16 - len(objs)
        gcol = (b"GCOL" + struct.pack("<B3sQ", 1, bytes(3), size) + objs
                + struct.pack("<HHIQ", 0, 0, 0, free) + bytes(free - 16))
        addr = out.put(gcol)
        heap = {s: (addr, i, n) for s, (i, n) in heap.items()}
    root_addr = _put_node(root, out, heap)
    sb = SIGNATURE + struct.pack("<BBBBQQQQ", 2, 8, 8, 0, 0, UNDEF, out.pos, root_addr)
    with open(path, "wb") as f:
        f.write(sb + struct.pack("<I", lookup3(sb)))
        for part in out.parts:
            f.write(part)


# -- reader ---------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        if bytes(self.buf[:8]) != SIGNATURE or self.buf[8] != 2 or bytes(self.buf[9:11]) != b"\x08\x08":
            raise ValueError("not an HDF5 file of the layout this module writes "
                             "(superblock version 2, 8-byte offsets and lengths)")
        self.root_addr = struct.unpack_from("<Q", self.buf, 36)[0]

    def root(self):
        return self.node(self.root_addr)

    def node(self, addr):
        b = self.buf
        if bytes(b[addr:addr + 4]) != b"OHDR" or b[addr + 4] != 2:
            raise ValueError(f"no version 2 object header at {addr}")
        flags = b[addr + 5]
        if flags & 0x3C:
            raise ValueError("object header with times or attribute phases: not written here")
        width = 1 << (flags & 3)
        p = addr + 6
        size = int.from_bytes(b[p:p + width], "little")
        p += width
        end = p + size
        msgs = []
        while p + 4 <= end:
            mtype, msize, _ = struct.unpack_from("<BHB", b, p)
            msgs.append((mtype, p + 4, msize))
            p += 4 + msize
        types_ = {m[0] for m in msgs}
        node = Dataset(None) if 0x08 in types_ else Group()
        layout = space = dtype = None
        for mtype, q, msize in msgs:
            if mtype == 0x06:
                if b[q] != 1:
                    raise ValueError("link message version")
                lflags = b[q + 1]
                if lflags & 0x1C or lflags & 3:
                    raise ValueError("link message form not written here")
                n = b[q + 2]
                name = bytes(b[q + 3:q + 3 + n]).decode()
                node._links[name] = self.node(struct.unpack_from("<Q", b, q + 3 + n)[0])
            elif mtype == 0x02 and struct.unpack_from("<Q", b, q + 2)[0] != UNDEF:
                raise ValueError("dense link storage: not written here")
            elif mtype == 0x01:
                space = self.dataspace(q)
            elif mtype == 0x03:
                dtype = self.datatype(q)[0]
            elif mtype == 0x08:
                if b[q] != 3 or b[q + 1] != 1:
                    raise ValueError("data layout other than contiguous version 3")
                layout = struct.unpack_from("<QQ", b, q + 2)
            elif mtype == 0x0C:
                name, value = self.attribute(q)
                dict.__setitem__(node.attrs, name, value)
        if isinstance(node, Dataset):
            addr, nbytes = layout
            raw = bytes(b[addr:addr + nbytes]) if nbytes else b""
            node._data = self.values(raw, dtype, space)
        return node

    def dataspace(self, q):
        b = self.buf
        version, rank, flags, _ = struct.unpack_from("<BBBB", b, q)
        if version != 2:
            raise ValueError("dataspace version")
        return tuple(struct.unpack_from(f"<{rank}Q", b, q + 4)) if rank else ()

    def datatype(self, q):
        """``(numpy dtype or 'str', bytes read)``."""
        b = self.buf
        cls, version = b[q] & 0x0F, b[q] >> 4
        bits = bytes(b[q + 1:q + 4])
        size = struct.unpack_from("<I", b, q + 4)[0]
        p = q + 8
        if cls == 0:
            return np.dtype(f"<{'i' if bits[0] & 0x08 else 'u'}{size}"), 12
        if cls == 1:
            return np.dtype(f"<f{size}"), 20
        if cls == 8:
            nmemb = struct.unpack_from("<H", bits)[0]
            base, n = self.datatype(p)
            p += n
            names = []
            for _ in range(nmemb):
                end = bytes(b[p:p + 256]).index(b"\0")
                names.append(bytes(b[p:p + end]).decode())
                p += end + 1 if version >= 3 else len(_pad8(bytes(end + 1)))
            p += nmemb * base.itemsize
            if sorted(names) != ["FALSE", "TRUE"]:
                raise ValueError("enum other than h5py's bool")
            return np.dtype(bool), p - q
        if cls == 6:
            nmemb = struct.unpack_from("<H", bits)[0]
            names = []
            for _ in range(nmemb):
                end = bytes(b[p:p + 256]).index(b"\0")
                names.append(bytes(b[p:p + end]).decode())
                p += len(_pad8(bytes(end + 1))) + 4
                member, n = self.datatype(p)
                p += n
            if names != ["r", "i"]:
                raise ValueError("compound other than h5py's complex")
            return np.dtype(f"<c{size}"), p - q
        if cls == 9:
            base, n = self.datatype(p)
            return "str", 8 + n
        raise ValueError(f"datatype class {cls} is not written here")

    def attribute(self, q):
        b = self.buf
        version, _, nlen, tlen, slen, _ = struct.unpack_from("<BBHHHB", b, q)
        if version != 3:
            raise ValueError("attribute message version")
        p = q + 9
        name = bytes(b[p:p + nlen - 1]).decode()
        p += nlen
        dtype = self.datatype(p)[0]
        p += tlen
        shape = self.dataspace(p)
        p += slen
        if dtype == "str":
            n, addr, idx = struct.unpack_from("<IQI", b, p)
            return name, self.heap_string(addr, idx, n)
        count = int(np.prod(shape, dtype=np.int64))
        raw = bytes(b[p:p + count * dtype.itemsize])
        v = self.values(raw, dtype, shape)
        return name, v[()] if v.ndim == 0 else v

    def heap_string(self, addr, idx, n):
        b = self.buf
        if bytes(b[addr:addr + 4]) != b"GCOL":
            raise ValueError("no global heap collection where a string points")
        size = struct.unpack_from("<Q", b, addr + 8)[0]
        p, end = addr + 16, addr + size
        while p + 16 <= end:
            i, _, _, n_obj = struct.unpack_from("<HHIQ", b, p)
            if i == 0:
                break
            if i == idx:
                return bytes(b[p + 16:p + 16 + n]).decode()
            p += 16 + n_obj + (-n_obj % 8)
        raise ValueError(f"string {idx} is not in its heap collection")

    @staticmethod
    def values(raw, dtype, shape):
        if dtype == np.dtype(bool):
            return (np.frombuffer(raw, np.int8) != 0).reshape(shape)
        return np.frombuffer(raw, dtype).reshape(shape).copy()


lite = types.SimpleNamespace(File=File, Group=Group, Dataset=Dataset)

try:
    import h5py  # noqa: F401
except ImportError:  # the numpy-only subset above
    h5py = lite
