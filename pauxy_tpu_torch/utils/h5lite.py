"""A small HDF5 reader and writer in numpy, for machines without h5py.

The port's files (QMCPACK integrals, trial wavefunctions, estimates,
walker checkpoints) are HDF5. Where ``h5py`` imports, ``utils.h5.File`` is
``h5py.File``; where it does not, it is :class:`File` below, which covers
what those files use:

* groups, and datasets of integers, floats, complex numbers (the
  compound ``{r, i}`` h5py writes), fixed-length byte strings and
  variable-length strings (read only), scalar or n-dimensional, stored
  contiguous or compact, or chunked without filters (the version 3 layout
  message and its version 1 B-tree of chunks, what the HDF5 library
  writes by default); ``create_dataset(..., chunks=, maxshape=)``,
  ``ds[...] = x`` and ``ds.resize(shape)`` on a file open for writing (the
  dataset is held in memory until ``close()``);
* reading the layouts the HDF5 library writes by default (superblock 0,
  version 1 object headers, symbol-table groups) and with
  ``libver="latest"`` (superblock 2 or 3, version 2 object headers,
  compact link groups);
* writing superblock 2, datasets with version 2 object headers and
  groups as version 1 object headers of compact links, which HDF5 1.8
  and later (and so h5py) read.

Filtered (compressed) datasets, chunked datasets with the version 4 layout
message (``libver="latest"``), dense link storage, attributes and
references are not read; a file that needs them raises
``NotImplementedError``.

:func:`open_file` is the port's way in: ``h5py.File`` where h5py imports,
else :class:`File`. A file opened for writing is held in memory and
written out on ``close()``. Datasets keep their place in the file: reopening a file
with ``"a"`` appends the new datasets and rewrites only the group headers
and the superblock, so pushing one dataset a block stays cheap.
"""

from __future__ import annotations

import itertools
import mmap
import os
import struct

import numpy as np

def open_file(filename, mode: str = "r"):
    """``h5py.File(filename, mode)`` where h5py imports, else
    ``File(filename, mode)``."""
    try:
        import h5py
    except ImportError:
        return File(filename, mode)
    return h5py.File(filename, mode)


_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of HDF5's
    version 2 metadata."""

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & _M32

    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    i = 0
    while n > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= rot(b, 4); b = (b + a) & _M32
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = data[i:i + n] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - rot(b, 14)) & _M32
    a ^= c; a = (a - rot(c, 11)) & _M32
    b ^= a; b = (b - rot(a, 25)) & _M32
    c ^= b; c = (c - rot(b, 16)) & _M32
    a ^= c; a = (a - rot(c, 4)) & _M32
    b ^= a; b = (b - rot(a, 14)) & _M32
    c ^= b; c = (c - rot(b, 24)) & _M32
    return c


# ---------------------------------------------------------------------------
# Datatypes
# ---------------------------------------------------------------------------

class _VlenStr:
    """Marker for a variable-length string datatype."""


def _parse_dtype(buf, off: int):
    """(numpy dtype or _VlenStr, bytes used) of a datatype message."""
    cv = buf[off]
    cls, version = cv & 0x0F, cv >> 4
    bits = buf[off + 1] | (buf[off + 2] << 8) | (buf[off + 3] << 16)
    size = struct.unpack_from("<I", buf, off + 4)[0]
    p = off + 8
    order = ">" if bits & 1 else "<"
    if cls == 0:        # fixed point
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}"), 8 + 4
    if cls == 1:        # floating point
        return np.dtype(f"{order}f{size}"), 8 + 12
    if cls == 3:        # fixed-length string
        return np.dtype(f"S{size}"), 8
    if cls == 9:        # variable length
        if bits & 0x0F != 1:
            raise NotImplementedError("variable-length sequences")
        _, used = _parse_dtype(buf, p)
        return _VlenStr, 8 + used
    if cls == 6:        # compound
        nmemb = bits & 0xFFFF
        fields = []
        for _ in range(nmemb):
            end = bytes(buf[p:p + 1024]).index(b"\0")
            name = bytes(buf[p:p + end]).decode()
            if version >= 3:
                p += end + 1
                nb = 1 if size < 2 ** 8 else 2 if size < 2 ** 16 else \
                    3 if size < 2 ** 24 else 4
                moff = int.from_bytes(buf[p:p + nb], "little")
                p += nb
            else:
                p += -(-(end + 1) // 8) * 8
                moff = struct.unpack_from("<I", buf, p)[0]
                p += 4
                if version == 1:
                    p += 1 + 3 + 4 + 4 + 16
            mdt, used = _parse_dtype(buf, p)
            p += used
            fields.append((name, mdt, moff))
        (r, rdt, roff), (i, idt, ioff) = fields if nmemb == 2 else [(
            None,) * 3] * 2
        if (r, i) != ("r", "i") or rdt != idt or rdt.kind != "f" or (
                roff, ioff) != (0, rdt.itemsize):
            raise NotImplementedError("compound types other than h5py's "
                                      "complex {r, i}")
        return np.dtype(f"{rdt.byteorder.replace('=', '<')}"
                        f"c{2 * rdt.itemsize}"), p - off
    raise NotImplementedError(f"HDF5 datatype class {cls}")


def _float_props(size: int) -> bytes:
    if size == 8:
        return struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
    if size == 4:
        return struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
    if size == 2:
        return struct.pack("<HHBBBBI", 0, 16, 10, 5, 0, 10, 15)
    raise NotImplementedError(f"float{8 * size}")


def _encode_dtype(dt: np.dtype) -> bytes:
    """A datatype message for ``dt`` (little endian)."""
    if dt.kind in "iu":
        signed = 0x08 if dt.kind == "i" else 0
        return (struct.pack("<BBBBI", 0x10, signed, 0, 0, dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f":
        sign = 8 * dt.itemsize - 1
        return (struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dt.itemsize)
                + _float_props(dt.itemsize))
    if dt.kind == "c":
        half = np.dtype(f"f{dt.itemsize // 2}")
        member = _encode_dtype(half)
        return (struct.pack("<BBBBI", 0x36, 2, 0, 0, dt.itemsize)
                + b"r\0" + bytes([0]) + member
                + b"i\0" + bytes([half.itemsize]) + member)
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, max(dt.itemsize, 1))
    raise NotImplementedError(f"cannot store dtype {dt}")


def _to_storable(value) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode()
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    if arr.dtype.kind == "O":
        raise NotImplementedError("object arrays")
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
        arr = arr.astype("S1")
    return np.array(arr, dtype=arr.dtype.newbyteorder("<"), order="C")


# ---------------------------------------------------------------------------
# In-memory tree
# ---------------------------------------------------------------------------

def _read_span(path: str, offset: int, nbytes: int) -> bytes:
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = fh.read(nbytes)
    if len(data) != nbytes:
        raise OSError(f"{path}: truncated dataset at byte {offset}")
    return data


class _GroupNode:
    def __init__(self):
        self.children: dict = {}
        self.addr = None
        self.encoded: dict = {}     # name -> (child address, link message)


class _DatasetNode:
    """A dataset held in memory (``array``) or in a file (``span`` =
    (path, data offset, bytes), or for a chunked one ``chunk_index`` =
    (path, [(offsets, address, bytes)])); ``addr`` is its object header's
    address once it has one. ``chunks`` (the chunk shape) and ``maxshape``
    (None entries unlimited) are set on a chunked dataset."""

    def __init__(self, *, shape, dtype, array=None, span=None, addr=None,
                 chunks=None, maxshape=None, chunk_index=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.array = array
        self.span = span
        self.addr = addr
        self.chunks = None if chunks is None else tuple(chunks)
        self.maxshape = None if maxshape is None else tuple(maxshape)
        self.chunk_index = chunk_index

    def read(self) -> np.ndarray:
        if self.array is not None:
            return self.array
        if self.chunk_index is not None:
            return _assemble_chunks(self)
        count = int(np.prod(self.shape)) if self.shape else 1
        if self.span is None or count == 0:
            return np.zeros(self.shape, self.dtype)
        arr = np.frombuffer(_read_span(*self.span), dtype=self.dtype,
                            count=count)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        return arr.reshape(self.shape)


def _assemble_chunks(node: _DatasetNode) -> np.ndarray:
    """The array of a chunked dataset from its chunks in the file; a chunk
    the index does not list reads as zeros (the fill value)."""
    path, chunks = node.chunk_index
    out = np.zeros(node.shape, node.dtype)
    count = int(np.prod(node.chunks))
    for offsets, addr, nbytes in chunks:
        raw = np.frombuffer(_read_span(path, addr, nbytes), node.dtype,
                            count=count).reshape(node.chunks)
        dst = tuple(slice(o, min(o + c, n)) for o, c, n in
                    zip(offsets, node.chunks, node.shape))
        out[dst] = raw[tuple(slice(0, d.stop - d.start) for d in dst)]
    if out.dtype.byteorder == ">":
        out = out.astype(out.dtype.newbyteorder("<"))
    return out


class Dataset:
    """A dataset: ``ds[()]``, ``ds[:]``, ``ds[i]`` or ``np.asarray(ds)``
    read it; in a file open for writing ``ds[key] = x`` writes it and a
    chunked one can ``resize``."""

    def __init__(self, node: _DatasetNode, file: "File | None" = None):
        self._node = node
        self._file = file

    @property
    def shape(self):
        return self._node.shape

    @property
    def dtype(self):
        return self._node.dtype

    @property
    def chunks(self):
        return self._node.chunks

    @property
    def maxshape(self):
        node = self._node
        return node.maxshape if node.chunks is not None else node.shape

    def __getitem__(self, key):
        out = self._node.read()[key]
        return np.array(out) if isinstance(out, np.ndarray) else out

    def __array__(self, dtype=None, copy=None):
        arr = np.array(self._node.read())
        return arr if dtype is None else arr.astype(dtype)

    def _held(self) -> np.ndarray:
        """The array, held in memory from now on: it is written anew (at
        the end of the file) on ``close()``."""
        if self._file is None:
            raise ValueError("dataset of no file")
        self._file._writable()
        node = self._node
        if node.array is None or node.addr is not None:
            node.array = np.array(node.read())
            node.span = node.chunk_index = node.addr = None
        return node.array

    def __setitem__(self, key, value):
        self._held()[key] = value

    def resize(self, size):
        """A chunked dataset's new shape, within its maxshape: rows past
        the old shape read as zeros, rows past the new one are dropped."""
        node = self._node
        if node.chunks is None:
            raise TypeError("only chunked datasets can be resized")
        size = (size,) if isinstance(size, int) else tuple(size)
        if len(size) != len(node.shape) or any(
                m is not None and n > m for n, m in zip(size, node.maxshape)):
            raise ValueError(f"new shape {size} beyond maxshape "
                             f"{node.maxshape}")
        old = self._held()
        new = np.zeros(size, node.dtype)
        keep = tuple(slice(0, min(a, b)) for a, b in zip(size, old.shape))
        new[keep] = old[keep]
        node.array, node.shape = new, size


class Group:
    """A group: ``g["a/b"]``, ``g["a/b"] = array``, ``"a" in g``,
    ``del g["a"]``, ``g.create_group``, ``g.keys()`` (sorted, as h5py's)."""

    def __init__(self, node: _GroupNode, file: "File"):
        self._node = node
        self._file = file

    def _walk(self, path: str, create: bool = False):
        if path.startswith("/"):
            return self._file._walk(path.lstrip("/"), create)
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError(path)
        node = self._node
        for p in parts[:-1]:
            nxt = node.children.get(p)
            if nxt is None:
                if not create:
                    raise KeyError(path)
                nxt = node.children[p] = _GroupNode()
            if not isinstance(nxt, _GroupNode):
                raise KeyError(f"{p!r} in {path!r} is not a group")
            node = nxt
        return node, parts[-1]

    def _wrap(self, node):
        if isinstance(node, _GroupNode):
            return Group(node, self._file)
        return Dataset(node, self._file)

    def __getitem__(self, path: str):
        if not path.strip("/"):
            return self._file if path.startswith("/") else self
        parent, name = self._walk(path)
        if name not in parent.children:
            raise KeyError(path)
        return self._wrap(parent.children[name])

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __setitem__(self, path: str, value):
        self._file._writable()
        parent, name = self._walk(path, create=True)
        if name in parent.children:
            raise ValueError(f"{path!r} already exists")
        arr = _to_storable(value)
        parent.children[name] = _DatasetNode(shape=arr.shape,
                                             dtype=arr.dtype, array=arr)

    def __delitem__(self, path: str):
        self._file._writable()
        parent, name = self._walk(path)
        del parent.children[name]
        self._file._rewrite = True

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       chunks=None, maxshape=None) -> Dataset:
        """A new dataset (zeros of ``shape``/``dtype``, or ``data``).
        ``chunks`` (a shape, or True for the whole shape) stores it chunked;
        ``maxshape`` (None entries unlimited; chunked, and by default the
        shape) bounds ``resize``."""
        self._file._writable()
        parent, name = self._walk(path, create=True)
        if name in parent.children:
            raise ValueError(f"{path!r} already exists")
        arr = (_to_storable(data) if data is not None
               else np.zeros(shape, dtype or np.float64))
        if shape is not None and tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(shape)
        if dtype is not None:
            arr = arr.astype(dtype)
        if maxshape is not None and chunks is None:
            chunks = True
        if chunks is True:
            chunks = tuple(max(n, 1) for n in arr.shape)
        if chunks is not None and not arr.shape:
            raise ValueError("a scalar dataset cannot be chunked")
        node = parent.children[name] = _DatasetNode(
            shape=arr.shape, dtype=arr.dtype, array=arr, chunks=chunks,
            maxshape=(arr.shape if maxshape is None and chunks is not None
                      else maxshape))
        return Dataset(node, self._file)

    def create_group(self, path: str) -> "Group":
        self._file._writable()
        parent, name = self._walk(path, create=True)
        if name in parent.children:
            raise ValueError(f"{path!r} already exists")
        node = parent.children[name] = _GroupNode()
        return Group(node, self._file)

    def keys(self):
        return sorted(self._node.children)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._node.children)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class _Reader:
    """Parses the metadata of the file at ``path`` (mapped as ``buf``);
    datasets are read from the file when asked for."""

    def __init__(self, buf, path: str):
        self.buf = buf
        self.path = path
        if bytes(buf[:8]) != _SIGNATURE:
            raise OSError(f"{path}: not an HDF5 file")
        self.version = version = buf[8]
        if version in (0, 1):
            if (buf[13], buf[14]) != (8, 8):
                raise NotImplementedError("offsets/lengths other than 8")
            p = 24 + (4 if version == 1 else 0) + 8 * 4
            self.root = struct.unpack_from("<Q", buf, p + 8)[0]
        elif version in (2, 3):
            if (buf[9], buf[10]) != (8, 8):
                raise NotImplementedError("offsets/lengths other than 8")
            self.root = struct.unpack_from("<Q", buf, 36)[0]
        else:
            raise NotImplementedError(f"superblock version {version}")

    def messages(self, addr: int):
        """[(type, data offset, size)] of an object header's messages,
        continuation blocks followed."""
        buf = self.buf
        out = []
        if bytes(buf[addr:addr + 4]) == b"OHDR":
            flags = buf[addr + 5]
            p = addr + 6 + (16 if flags & 0x20 else 0) + (
                4 if flags & 0x10 else 0)
            nb = 1 << (flags & 3)
            blocks = [(p + nb, int.from_bytes(buf[p:p + nb], "little"))]
            hdr = 4 + (2 if flags & 0x04 else 0)
            while blocks:
                q, end = blocks.pop(0)
                end += q
                while q + hdr <= end:
                    mtype = buf[q]
                    msize = struct.unpack_from("<H", buf, q + 1)[0]
                    q += hdr
                    if mtype == 0x10:
                        caddr, clen = struct.unpack_from("<QQ", buf, q)
                        blocks.append((caddr + 4, clen - 8))  # OCHK .. sum
                    else:
                        out.append((mtype, q, msize))
                    q += msize
            return out
        if buf[addr] != 1:
            raise NotImplementedError(f"object header version {buf[addr]}")
        nmsg = struct.unpack_from("<H", buf, addr + 2)[0]
        blocks = [(addr + 16, struct.unpack_from("<I", buf, addr + 8)[0])]
        count = 0
        while blocks and count < nmsg:
            q, end = blocks.pop(0)
            end += q
            while q + 8 <= end and count < nmsg:
                mtype, msize = struct.unpack_from("<HH", buf, q)
                q += 8
                count += 1
                if mtype == 0x10:
                    blocks.append(struct.unpack_from("<QQ", buf, q))
                else:
                    out.append((mtype, q, msize))
                q += msize
        return out

    def node(self, addr: int):
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        if types & {0x01, 0x03, 0x08} and not types & {0x02, 0x06, 0x11}:
            node = self.dataset(msgs)
        else:
            node = _GroupNode()
            for name, child in self.links(msgs):
                node.children[name] = self.node(child)
        node.addr = addr
        return node

    def links(self, msgs):
        buf = self.buf
        out = []
        for mtype, off, _ in msgs:
            if mtype == 0x11:       # symbol table: v1 B-tree + local heap
                btree, heap = struct.unpack_from("<QQ", buf, off)
                heap_data = struct.unpack_from("<Q", buf, heap + 24)[0]
                out.extend(self._btree_links(btree, heap_data))
            elif mtype == 0x02:     # link info
                q = off + 2 + (8 if buf[off + 1] & 1 else 0)
                if struct.unpack_from("<Q", buf, q)[0] != _UNDEF:
                    raise NotImplementedError("dense link storage")
            elif mtype == 0x06:     # link
                flags = buf[off + 1]
                q = off + 2
                ltype = 0
                if flags & 0x08:
                    ltype = buf[q]
                    q += 1
                q += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
                nb = 1 << (flags & 3)
                nlen = int.from_bytes(buf[q:q + nb], "little")
                q += nb
                name = bytes(buf[q:q + nlen]).decode()
                if ltype == 0:      # soft and external links: not followed
                    out.append((name, struct.unpack_from(
                        "<Q", buf, q + nlen)[0]))
        return out

    def _btree_links(self, addr: int, heap_data: int):
        buf = self.buf
        if bytes(buf[addr:addr + 4]) != b"TREE":
            raise OSError("bad group B-tree")
        level = buf[addr + 5]
        used = struct.unpack_from("<H", buf, addr + 6)[0]
        out = []
        for i in range(used):
            child = struct.unpack_from("<Q", buf, addr + 32 + 16 * i)[0]
            if level > 0:
                out.extend(self._btree_links(child, heap_data))
                continue
            if bytes(buf[child:child + 4]) != b"SNOD":
                raise OSError("bad symbol table node")
            for k in range(struct.unpack_from("<H", buf, child + 6)[0]):
                noff, ohdr = struct.unpack_from("<QQ", buf, child + 8 + 40 * k)
                s = heap_data + noff
                end = bytes(buf[s:s + 1024]).index(b"\0")
                out.append((bytes(buf[s:s + end]).decode(), ohdr))
        return out

    def dataset(self, msgs) -> _DatasetNode:
        buf = self.buf
        shape = dtype = layout = None
        maxshape = None
        for mtype, off, _ in msgs:
            if mtype == 0x01:
                version, ndim = buf[off], buf[off + 1]
                stype = (1 if ndim else 0) if version == 1 else buf[off + 3]
                p = off + (8 if version == 1 else 4)
                shape = (() if stype == 0 else (0,) if stype == 2 else
                         tuple(struct.unpack_from(f"<{ndim}Q", buf, p)))
                if buf[off + 2] & 1 and stype == 1:
                    maxshape = tuple(
                        None if m == _UNDEF else m for m in
                        struct.unpack_from(f"<{ndim}Q", buf, p + 8 * ndim))
            elif mtype == 0x03:
                dtype, _ = _parse_dtype(buf, off)
            elif mtype == 0x08:
                layout = off
            elif mtype == 0x0B:
                raise NotImplementedError("filtered (compressed) datasets")
        if shape is None or dtype is None or layout is None:
            raise OSError("dataset without dataspace, datatype or layout")
        if buf[layout] not in (3, 4):
            raise NotImplementedError(
                f"layout message version {buf[layout]}")
        lclass = buf[layout + 1]
        if lclass == 0:
            n = struct.unpack_from("<H", buf, layout + 2)[0]
            raw, span = bytes(buf[layout + 4:layout + 4 + n]), None
        elif lclass == 1:
            daddr, n = struct.unpack_from("<QQ", buf, layout + 2)
            raw = None
            span = None if daddr == _UNDEF else (self.path, daddr, n)
        elif buf[layout] == 3 and lclass == 2:
            ndims = buf[layout + 2]             # the dataset's + 1
            btree = struct.unpack_from("<Q", buf, layout + 3)[0]
            dims = struct.unpack_from(f"<{ndims}I", buf, layout + 11)
            index = [] if btree == _UNDEF else self._chunk_btree(btree,
                                                                 ndims)
            return _DatasetNode(
                shape=shape, dtype=dtype, chunks=dims[:-1],
                maxshape=maxshape or shape,
                chunk_index=(self.path, index))
        else:
            raise NotImplementedError(
                "chunked datasets with layout message version 4")
        if dtype is _VlenStr:
            data = raw if raw is not None else (
                _read_span(*span) if span else b"")
            count = int(np.prod(shape)) if shape else 1
            vals = np.empty(count, dtype=object)
            for k in range(count):
                n_, caddr, idx = struct.unpack_from("<IQI", data, 16 * k)
                vals[k] = self._global_heap(caddr, idx)[:n_]
            return _DatasetNode(shape=shape, dtype=np.dtype(object),
                                array=vals.reshape(shape))
        if raw is not None:
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            return _DatasetNode(shape=shape, dtype=dtype, array=arr)
        return _DatasetNode(shape=shape, dtype=dtype, span=span)

    def _chunk_btree(self, addr: int, ndims: int):
        """[(offsets, address, bytes)] of the chunks below the version 1
        B-tree node (type 1) at ``addr``."""
        buf = self.buf
        if bytes(buf[addr:addr + 4]) != b"TREE" or buf[addr + 4] != 1:
            raise OSError("bad chunk B-tree")
        level = buf[addr + 5]
        used = struct.unpack_from("<H", buf, addr + 6)[0]
        ksize = 8 + 8 * ndims
        out = []
        p = addr + 24
        for _ in range(used):
            nbytes, mask = struct.unpack_from("<II", buf, p)
            offsets = struct.unpack_from(f"<{ndims}Q", buf, p + 8)
            child = struct.unpack_from("<Q", buf, p + ksize)[0]
            if level > 0:
                out.extend(self._chunk_btree(child, ndims))
            elif mask:
                raise NotImplementedError("filtered (compressed) chunks")
            else:
                out.append((offsets[:-1], child, nbytes))
            p += ksize + 8
        return out

    def _global_heap(self, addr: int, index: int) -> bytes:
        buf = self.buf
        if bytes(buf[addr:addr + 4]) != b"GCOL":
            raise OSError("bad global heap collection")
        size = struct.unpack_from("<Q", buf, addr + 8)[0]
        p = addr + 16
        while p + 16 <= addr + size:
            idx, _, _, osize = struct.unpack_from("<HHIQ", buf, p)
            if idx == index:
                return bytes(buf[p + 16:p + 16 + osize])
            if idx == 0:
                break
            p += 16 + -(-osize // 8) * 8
        raise OSError("global heap object not found")


def _parse(path: str):
    """(root, end of the datasets or None) of the file at ``path``. The
    second is the start of the group headers when the file has this
    module's layout (superblock 2, every dataset before every group
    header), so that new datasets can go there."""
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0,
                                           access=mmap.ACCESS_READ) as mm:
        buf = memoryview(mm)
        try:
            reader = _Reader(buf, path)
            root = reader.node(reader.root)
            version = reader.version
        finally:
            buf.release()
    groups, datasets = [], []

    def visit(node):
        groups.append(node.addr)
        for child in node.children.values():
            if isinstance(child, _GroupNode):
                visit(child)
            else:
                datasets.append(child.addr)
    visit(root)
    start = min(groups)
    if version != 2 or any(a >= start for a in datasets):
        return root, None
    return root, start


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _ohdr(messages) -> bytes:
    """A version 2 object header holding ``messages`` [(type, data)]."""
    body = b"".join(struct.pack("<BHB", t, len(d), 0) + d
                    for t, d in messages)
    raw = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body)) + body
    return raw + struct.pack("<I", lookup3(raw))


def _dataset_blob(arr: np.ndarray, addr: int):
    """(object header then data of ``arr`` placed at ``addr``, data
    offset)."""
    if arr.shape:
        space = struct.pack("<BBBB", 2, arr.ndim, 0, 1) + struct.pack(
            f"<{arr.ndim}Q", *arr.shape)
    else:
        space = struct.pack("<BBBB", 2, 0, 0, 0)
    dtype = _encode_dtype(arr.dtype)
    fill = bytes([3, 0x0A])     # allocated late, filled if set, no value
    data = arr.tobytes()

    def header(daddr):
        layout = struct.pack("<BBQQ", 3, 1, daddr, len(data))
        return _ohdr([(0x01, space), (0x03, dtype), (0x05, fill),
                      (0x08, layout)])

    daddr = addr + len(header(0)) if data else _UNDEF
    return header(daddr) + data, daddr


# Entries of a chunk B-tree node: 2 K with the library's default K = 32
# for chunk indexes (superblock 2 stores no K).
_CHUNK_NODE = 64


def _chunked_blob(node: _DatasetNode, arr: np.ndarray, addr: int):
    """(object header, the chunk B-tree nodes and the chunks of ``arr``
    placed at ``addr``, [(offsets, address, bytes)] of the chunks).

    A version 3 layout message (class 2) indexes the chunks by a version 1
    B-tree of type 1; its keys are the chunks' offsets in C order, a last
    key one chunk past the last one, as the HDF5 library keys them, and its
    nodes hold up to 64 entries (levels are added above as needed)."""
    nd = arr.ndim
    chunks = node.chunks
    maxshape = tuple(_UNDEF if m is None else m for m in node.maxshape)
    space = struct.pack("<BBBB", 2, nd, 1, 1) + struct.pack(
        f"<{2 * nd}Q", *arr.shape, *maxshape)
    dtype = _encode_dtype(arr.dtype)
    fill = bytes([3, 0x0A])
    esize = arr.dtype.itemsize
    grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
    offsets = list(itertools.product(*grid)) if all(arr.shape) else []
    cbytes = int(np.prod(chunks)) * esize
    ksize = 8 + 8 * (nd + 1)
    nsize = 24 + _CHUNK_NODE * (ksize + 8) + ksize

    def key(nbytes, offs):
        return struct.pack("<II", nbytes, 0) + struct.pack(
            f"<{nd + 1}Q", *offs)

    # The tree, leaves first: each level a list of nodes, each node a list
    # of (left key, child index) over the level below.
    levels = []
    entries = [(tuple(o) + (0,), i) for i, o in enumerate(offsets)]
    while True:
        nodes = [entries[i:i + _CHUNK_NODE]
                 for i in range(0, max(len(entries), 1), _CHUNK_NODE)]
        levels.append(nodes)
        if len(nodes) == 1:
            break
        entries = [(n[0][0], j) for j, n in enumerate(nodes)]
    last = ((tuple(o + c for o, c in zip(offsets[-1], chunks)) + (esize,))
            if offsets else (0,) * (nd + 1))

    def header(btree):
        layout = struct.pack("<BBBQ", 3, 2, nd + 1, btree) + struct.pack(
            f"<{nd + 1}I", *chunks, esize)
        return _ohdr([(0x01, space), (0x03, dtype), (0x05, fill),
                      (0x08, layout)])

    hlen = len(header(0))
    nnodes = sum(len(n) for n in levels) if offsets else 0
    tree_at = addr + hlen
    data_at = tree_at + nnodes * nsize
    caddr = [data_at + i * cbytes for i in range(len(offsets))]
    # Node addresses: the root first, then each level below in order.
    naddr, p = [], tree_at
    for nodes in reversed(levels):
        naddr.insert(0, [p + j * nsize for j in range(len(nodes))])
        p += len(nodes) * nsize
    blobs = []
    for lv in reversed(range(len(levels)) if offsets else ()):
        nodes = levels[lv]
        for j, ents in enumerate(nodes):
            if j + 1 < len(nodes):
                right_key = nodes[j + 1][0][0]
            else:
                right_key = last
            body = struct.pack("<4sBBH", b"TREE", 1, lv, len(ents))
            body += struct.pack("<QQ", naddr[lv][j - 1] if j else _UNDEF,
                                naddr[lv][j + 1] if j + 1 < len(nodes)
                                else _UNDEF)
            for k, child in ents:
                body += key(cbytes, k)
                body += struct.pack("<Q", caddr[child] if lv == 0
                                    else naddr[lv - 1][child])
            body += key(0, right_key)
            blobs.append(body + bytes(nsize - len(body)))
    data = b""
    index = []
    for o, a in zip(offsets, caddr):
        c = np.zeros(chunks, arr.dtype)
        src = tuple(slice(x, min(x + n, s)) for x, n, s in
                    zip(o, chunks, arr.shape))
        c[tuple(slice(0, d.stop - d.start) for d in src)] = arr[src]
        data += c.tobytes()
        index.append((o, a, cbytes))
    root = naddr[-1][0] if offsets else _UNDEF
    return header(root) + b"".join(blobs) + data, index


def _v1_message(mtype: int, data: bytes) -> bytes:
    return (struct.pack("<HHB3x", mtype, -(-len(data) // 8) * 8, 0) + data
            + bytes(-len(data) % 8))


def _group_header(node: _GroupNode) -> bytes:
    """A version 1 object header (no checksum) of a compact-storage group:
    link info, group info (its compact limit raised to the most, so that
    the HDF5 library, appending, keeps it compact), then one hard link
    message (UTF-8 name) a child, kept encoded on the node while the
    child stays where it is."""
    cache = node.encoded
    msgs = [_v1_message(0x02, bytes([0, 0]) + struct.pack("<QQ", _UNDEF,
                                                           _UNDEF)),
            _v1_message(0x0A, bytes([0, 1]) + struct.pack("<HH", 0xFFFF,
                                                           0xFFFF))]
    for name, child in node.children.items():
        hit = cache.get(name)
        if hit is None or hit[0] != child.addr:
            enc = name.encode()
            code = 0 if len(enc) < 256 else 1
            hit = cache[name] = (child.addr, _v1_message(
                0x06, bytes([1, 0x10 | code, 1])
                + len(enc).to_bytes(1 << code, "little") + enc
                + struct.pack("<Q", child.addr)))
        msgs.append(hit[1])
    body = b"".join(msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


_SUPER_LEN = 48


def _superblock(eof: int, root: int) -> bytes:
    raw = _SIGNATURE + bytes([2, 8, 8, 0]) + struct.pack(
        "<QQQQ", 0, _UNDEF, eof, root)
    return raw + struct.pack("<I", lookup3(raw))


def _stat_key(path: str):
    st = os.stat(path)
    return st.st_size, st.st_mtime_ns, st.st_ino


# path -> (stat key, root, end of datasets): the trees this process last
# read or wrote, reused while the file is unchanged on disk; the oldest
# entries go past _TREES_MAX.
_TREES: dict = {}
_TREES_MAX = 64


def _keep_tree(path: str, entry) -> None:
    _TREES[path] = entry
    while len(_TREES) > _TREES_MAX:
        del _TREES[next(iter(_TREES))]


class File(Group):
    """An HDF5 file: mode ``"r"``, ``"r+"``, ``"w"`` (truncate) or ``"a"``
    (read/write, created if missing)."""

    def __init__(self, filename, mode: str = "r"):
        if mode not in ("r", "r+", "w", "a"):
            raise ValueError(f"mode {mode!r}")
        self.filename = os.fspath(filename)
        self._path = os.path.abspath(self.filename)
        self.mode = mode
        self._rewrite = True
        self._data_end = None
        self._opened_key = None
        exists = os.path.exists(self._path)
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(self.filename)
        if mode == "w" or (mode == "a" and (
                not exists or os.path.getsize(self._path) == 0)):
            root = _GroupNode()
        else:
            key = self._opened_key = _stat_key(self._path)
            cached = _TREES.pop(self._path, None)
            if cached is not None and cached[0] == key:
                _, root, self._data_end = cached
            else:
                root, self._data_end = _parse(self._path)
            self._rewrite = self._data_end is None
            if mode == "r":
                _keep_tree(self._path, (key, root, self._data_end))
        super().__init__(root, self)

    def _writable(self):
        if self.mode == "r":
            raise ValueError("file opened read-only")

    def close(self):
        """Write the file (a writable one); a file another writer changed
        since it was opened here raises instead, as the two trees would
        overwrite each other."""
        if self.mode == "r":
            return
        self.mode = "r"
        if self._opened_key is not None and (
                not os.path.exists(self._path)
                or _stat_key(self._path) != self._opened_key):
            raise OSError(f"{self.filename} changed on disk while open for "
                          "writing; nothing was written")
        self._write()
        _keep_tree(self._path, (_stat_key(self._path), self._node,
                                self._data_end))

    def _write(self):
        """Write the new datasets after the old ones, then every group
        header, then the superblock; or, after a deletion or for a file of
        another layout, the whole tree."""
        datasets, groups = [], []

        def visit(node):
            for child in node.children.values():
                if isinstance(child, _GroupNode):
                    visit(child)
                else:
                    datasets.append(child)
            groups.append(node)
        visit(self._node)
        if self._rewrite:
            for d in datasets:
                d.array, d.addr = d.read(), None
            self._data_end = _SUPER_LEN
        end = self._data_end
        with open(self._path, "wb" if self._rewrite else "r+b") as fh:
            for d in datasets:
                if d.addr is not None:
                    continue
                if d.chunks is not None:
                    blob, index = _chunked_blob(d, d.read(), end)
                    d.chunk_index = (self._path, index)
                else:
                    blob, daddr = _dataset_blob(d.read(), end)
                    d.span = (self._path, daddr, d.read().nbytes)
                    if daddr == _UNDEF:
                        d.span = None
                fh.seek(end)
                fh.write(blob)
                d.addr = end
                d.array = None
                end += len(blob)
            self._data_end = end
            for g in groups:            # children before parents
                blob = _group_header(g)
                g.addr = end
                fh.seek(end)
                fh.write(blob)
                end += len(blob)
            fh.truncate(end)
            fh.seek(0)
            fh.write(_superblock(end, self._node.addr))
        self._rewrite = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
