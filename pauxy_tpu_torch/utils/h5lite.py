"""A small HDF5 reader and writer in numpy, for machines without h5py.

The port's files (QMCPACK integrals, trial wavefunctions, estimates,
walker checkpoints, the out-of-core Cholesky's vectors) are HDF5. Where
``h5py`` imports, :func:`open_file` gives ``h5py.File``; where it does
not, it gives :class:`File` below.

What is read, whoever wrote the file:

* superblocks 0 to 3; version 1 and 2 object headers; groups as symbol
  tables, as compact links or in dense link storage (the link info
  message, the fractal heap and its name-index version 2 B-tree), whose
  ``keys()`` come in h5py's order;
* datasets of integers, floats, complex numbers (the compound ``{r, i}``
  h5py writes), fixed-length byte strings and variable-length strings,
  scalar or n-dimensional, stored compact, contiguous or chunked: the
  version 3 layout message and its version 1 chunk B-tree, and the version
  4 layout message with each of its chunk indexes (single chunk, implicit,
  fixed array, extensible array, version 2 B-tree);
* filtered chunks: deflate, shuffle and fletcher32 (a checksum mismatch
  raises ``OSError``), each skipped where the chunk's filter mask says so.

``ds[key]`` with integers and slices reads only what the key touches: the
chunks that intersect it, or the byte range of a contiguous dataset's rows;
``ds[()]`` and ``np.asarray(ds)`` read it all. The index and heap formats
are in ``utils/h5lite_index.py``.

What is written: superblock 2, groups as version 1 object headers of
compact links (any number of them), datasets with version 2 object
headers, contiguous (written when created) or chunked (``chunks=``,
``maxshape=``; ``ds[key] = x`` reads, patches and writes at once only the
chunks the key touches, in place where the chunk already has a place this
session, else at the end of the file; ``resize`` drops the chunks past the
new shape and copies no data; ``close()`` writes the version 1 chunk
B-trees, the group headers and the superblock). Only the chunk index stays
in memory. Filters are never written.

Still raising ``NotImplementedError``: any other filter (h5py's lzf, id
32000, szip, n-bit, scale-offset; the message names the id), huge fractal
heap objects, virtual datasets, attributes and references (no module of
the JAX package reads either). Writing into a filtered dataset raises too.

Reopening with ``"a"`` or ``"r+"`` writes the session's data past the end
of the file; ``close()`` then lays its data over the old group headers
when it fits there, and writes the headers anew, so pushing one dataset a
block stays cheap. After a deletion, or for a file of another layout,
``close()`` streams every kept dataset, chunk by chunk or in bounded byte
ranges, into a temporary file beside it and replaces the file with it. A
file another writer changed while it was open here is refused, at the next
write or on ``close()``, with ``OSError``.
"""

from __future__ import annotations

import itertools
import mmap
import operator
import os
import struct
import tempfile

import numpy as np

from pauxy_tpu_torch.utils import h5lite_index as hix


def open_file(filename, mode: str = "r"):
    """``h5py.File(filename, mode)`` where h5py imports, else
    ``File(filename, mode)``."""
    try:
        import h5py
    except ImportError:
        return File(filename, mode)
    return h5py.File(filename, mode)


_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = hix.UNDEF
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
# File I/O
# ---------------------------------------------------------------------------

# Bytes a copy moves at a time where the kernel cannot copy file to file.
_COPY_PIECE = 1 << 16


def _bytes_of(arr: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _pread_into(fd: int, offset: int, out: np.ndarray) -> None:
    """Fill the C-contiguous ``out`` from the file at ``offset``."""
    view = memoryview(out.reshape(-1).view(np.uint8))
    done = 0
    while done < len(view):
        n = os.preadv(fd, [view[done:]], offset + done)
        if n <= 0:
            raise OSError(f"truncated HDF5 file at byte {offset + done}")
        done += n


def _pread(fd: int, offset: int, nbytes: int) -> bytes:
    data = os.pread(fd, nbytes, offset)
    if len(data) != nbytes:
        raise OSError(f"truncated HDF5 file at byte {offset}")
    return data


def _pwrite(fd: int, offset: int, data) -> None:
    view = memoryview(data).cast("B")
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], offset + done)


def _copy_range(src: int, src_off: int, dst: int, dst_off: int,
                nbytes: int, swap: np.dtype | None = None) -> None:
    """Copy ``nbytes`` between two files (or two ranges of one file that
    do not overlap) in the kernel where it can, else ``_COPY_PIECE`` bytes
    at a time; ``swap`` (a big-endian dtype) turns the values little
    endian on the way."""
    if swap is None and hasattr(os, "copy_file_range"):
        try:
            done = 0
            while done < nbytes:
                n = os.copy_file_range(src, dst, nbytes - done,
                                       src_off + done, dst_off + done)
                if n <= 0:
                    break
                done += n
            if done == nbytes:
                return
            src_off, dst_off, nbytes = (src_off + done, dst_off + done,
                                        nbytes - done)
        except OSError:
            pass
    piece = _COPY_PIECE
    if swap is not None:
        piece -= piece % swap.itemsize
    for s in range(0, nbytes, piece):
        data = _pread(src, src_off + s, min(piece, nbytes - s))
        if swap is not None:
            data = np.frombuffer(data, swap).astype(
                swap.newbyteorder("<")).tobytes()
        _pwrite(dst, dst_off + s, data)


class _Reading:
    """A read-only descriptor of ``path`` for one read."""

    def __init__(self, path: str):
        self.fd = os.open(path, os.O_RDONLY)

    def __enter__(self):
        return self.fd

    def __exit__(self, *exc):
        os.close(self.fd)


def _little(dtype: np.dtype) -> np.dtype:
    return dtype.newbyteorder("<") if dtype.byteorder == ">" else dtype


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def _box(key, shape):
    """(lo, hi, residual key) of a key of integers and slices: the box of
    the dataset it touches and the key into that box; None for any other
    key (lists, arrays, masks, new axes), which reads the whole dataset."""
    if not isinstance(key, tuple):
        key = (key,)
    if sum(k is Ellipsis for k in key) > 1:
        return None
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) \
            + key[i + 1:]
    if len(key) > len(shape):
        return None
    key = key + (slice(None),) * (len(shape) - len(key))
    lo, hi, res = [], [], []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            r = range(*k.indices(n))
            if not r:
                lo.append(0)
                hi.append(0)
                res.append(slice(0, 0))
                continue
            a, b = (r.start, r[-1] + 1) if r.step > 0 else (r[-1],
                                                             r.start + 1)
            lo.append(a)
            hi.append(b)
            stop = r.stop - a
            res.append(slice(r.start - a, stop if stop >= 0 else None,
                             r.step))
        elif isinstance(k, (int, np.integer)) and not isinstance(
                k, (bool, np.bool_)):
            i = operator.index(k)
            if not -n <= i < n:
                raise IndexError(f"index {i} out of range for axis of "
                                 f"size {n}")
            i %= n
            lo.append(i)
            hi.append(i + 1)
            res.append(0)
        else:
            return None
    return tuple(lo), tuple(hi), tuple(res)


def _covers(res, lo, hi) -> bool:
    """Whether the residual key selects every element of its box."""
    for k, a, b in zip(res, lo, hi):
        if isinstance(k, slice):
            if len(range(*k.indices(b - a))) != b - a:
                return False
        elif b - a != 1:
            return False
    return True


def _grid(lo, hi, chunks):
    """The offsets of the chunks that intersect the box [lo, hi)."""
    if any(b <= a for a, b in zip(lo, hi)):
        return []
    return itertools.product(*(range(a - a % c, b, c)
                               for a, b, c in zip(lo, hi, chunks)))


# ---------------------------------------------------------------------------
# In-memory tree
# ---------------------------------------------------------------------------

class _GroupNode:
    def __init__(self):
        self.children: dict = {}
        self.addr = None
        self.encoded: dict = {}     # name -> (child address, link message)


class _DatasetNode:
    """A dataset of the file at ``path``, by its layout:

    * held in memory (``array``: compact or variable-length data, or one
      patched in memory);
    * contiguous: ``span`` = (data address, bytes), None when there is no
      data;
    * chunked: ``chunks`` (the chunk shape), ``maxshape`` (None entries
      unlimited) and ``index`` {chunk offsets: (address, bytes, filter
      mask)}, with the ``filters`` [(id, flags, client data)] of its
      pipeline and ``edge_raw`` (partial edge chunks stored unfiltered).

    ``addr`` is its object header's address once it has one; ``dtype`` is
    the file's (``read_box`` gives little-endian values)."""

    def __init__(self, *, shape, dtype, path=None, array=None, span=None,
                 addr=None, chunks=None, maxshape=None, index=None,
                 filters=(), edge_raw=False):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.path = path
        self.array = array
        self.span = span
        self.addr = addr
        self.chunks = None if chunks is None else tuple(chunks)
        self.maxshape = None if maxshape is None else tuple(maxshape)
        self.index = index
        self.filters = tuple(filters)
        self.edge_raw = edge_raw

    @property
    def chunk_bytes(self) -> int:
        return int(np.prod(self.chunks, dtype=np.int64)) * self.dtype.itemsize

    def read(self) -> np.ndarray:
        if self.array is not None:
            return self.array
        return self.read_box((0,) * len(self.shape), self.shape)

    def read_box(self, lo, hi, little: bool = True) -> np.ndarray:
        """The values in the box [lo, hi), read from the file: the rows of
        a contiguous dataset, or the chunks that intersect the box."""
        box = tuple(b - a for a, b in zip(lo, hi))
        if self.array is not None:
            return np.array(self.array[tuple(map(slice, lo, hi))])
        if self.chunks is not None:
            out = self._read_chunked(lo, hi, box)
        elif self.span is None or 0 in box:
            out = np.zeros(box, self.dtype)
        elif not box:
            out = np.empty((), self.dtype)
            with _Reading(self.path) as fd:
                _pread_into(fd, self.span[0], out)
        else:
            row = self.dtype.itemsize * int(np.prod(self.shape[1:],
                                                    dtype=np.int64))
            out = np.empty((hi[0] - lo[0],) + self.shape[1:], self.dtype)
            with _Reading(self.path) as fd:
                _pread_into(fd, self.span[0] + lo[0] * row, out)
            if box[1:] != self.shape[1:]:
                out = np.array(out[(slice(None),) + tuple(
                    map(slice, lo[1:], hi[1:]))])
        if little and out.dtype.byteorder == ">":
            out = out.astype(_little(out.dtype))
        return out

    def _read_chunked(self, lo, hi, box) -> np.ndarray:
        chunks = self.chunks
        offsets = list(_grid(lo, hi, chunks))
        whole = all(off in self.index for off in offsets)
        out = (np.empty if whole else np.zeros)(box, self.dtype)
        crow = self.chunk_bytes // chunks[0]
        with _Reading(self.path) as fd:
            for off in offsets:
                entry = self.index.get(off)
                if entry is None:           # never written: the fill value
                    continue
                a = [max(x, o) - o for x, o in zip(lo, off)]
                b = [min(y, o + c) - o for y, o, c in zip(hi, off, chunks)]
                dst = tuple(slice(o + s - x, o + e - x)
                            for o, s, e, x in zip(off, a, b, lo))
                if self._filtered(off):
                    raw = _pread(fd, entry[0], entry[1])
                    data = hix.decode_chunk(raw, self.filters, entry[2])
                    arr = np.frombuffer(data, self.dtype,
                                        count=self.chunk_bytes
                                        // self.dtype.itemsize)
                    out[dst] = arr.reshape(chunks)[tuple(map(slice, a, b))]
                    continue
                # Unfiltered: read only the chunk's rows [a0, b0), into
                # the output where they land there whole.
                rows = (b[0] - a[0],) + chunks[1:]
                at = entry[0] + a[0] * crow
                target = out[dst]
                if rows == target.shape and target.flags.c_contiguous:
                    _pread_into(fd, at, target)
                else:
                    tmp = np.empty(rows, self.dtype)
                    _pread_into(fd, at, tmp)
                    out[dst] = tmp[(slice(None),) + tuple(
                        map(slice, a[1:], b[1:]))]
        return out

    def _filtered(self, off) -> bool:
        """Whether the chunk at ``off`` went through the pipeline."""
        if not self.filters:
            return False
        if self.edge_raw and any(o + c > n for o, c, n in
                                 zip(off, self.chunks, self.shape)):
            return False
        return True


class Dataset:
    """A dataset: ``ds[()]``, ``ds[:]``, ``ds[i]``, ``ds[s:e]`` or
    ``np.asarray(ds)`` read it (a key of integers and slices only what it
    touches); in a file open for writing ``ds[key] = x`` writes it and a
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
        node = self._node
        box = None if node.array is not None else _box(key, node.shape)
        if box is None:
            out = node.read()[key]
            return np.array(out) if isinstance(out, np.ndarray) else out
        lo, hi, res = box
        block = node.read_box(lo, hi)
        out = block[res]
        if not isinstance(out, np.ndarray):
            return out
        return (np.ascontiguousarray(out) if out.size == block.size
                else np.array(out))

    def __array__(self, dtype=None, copy=None):
        node = self._node
        arr = np.array(node.array) if node.array is not None else node.read()
        return arr if dtype is None else arr.astype(dtype)

    def __setitem__(self, key, value):
        if self._file is None:
            raise ValueError("dataset of no file")
        self._file._writable()
        node = self._node
        if node.array is not None:
            node.array[key] = value
            node.addr = None            # written anew on close()
            return
        box = _box(key, node.shape)
        if box is None:
            lo, hi = (0,) * len(node.shape), node.shape
            block = node.read_box(lo, hi, little=False)
            block[key] = value
        else:
            lo, hi, res = box
            if _covers(res, lo, hi):
                block = np.empty(tuple(b - a for a, b in zip(lo, hi)),
                                 node.dtype)
            else:
                block = node.read_box(lo, hi, little=False)
            block[res] = value
        self._file._write_box(node, lo, hi, block)

    def resize(self, size):
        """A chunked dataset's new shape, within its maxshape: rows past
        the old shape read as zeros, rows past the new one are dropped (a
        chunk wholly past it leaves the index, the part past it of a chunk
        it cuts is zeroed, as HDF5 does)."""
        node = self._node
        if node.chunks is None:
            raise TypeError("only chunked datasets can be resized")
        size = (size,) if isinstance(size, int) else tuple(size)
        if len(size) != len(node.shape) or any(
                m is not None and n > m for n, m in zip(size, node.maxshape)):
            raise ValueError(f"new shape {size} beyond maxshape "
                             f"{node.maxshape}")
        if self._file is None:
            raise ValueError("dataset of no file")
        self._file._writable()
        old = node.shape
        for off in sorted(node.index):
            if any(o >= n for o, n in zip(off, size)):
                del node.index[off]
                continue
            ends = [min(o + c, n) for o, c, n in zip(off, node.chunks, old)]
            for d, n in enumerate(size):
                if n < ends[d]:
                    lo = off[:d] + (n,) + off[d + 1:]
                    self._file._write_box(node, lo, tuple(ends), np.zeros(
                        tuple(e - a for a, e in zip(lo, ends)), node.dtype))
        node.shape = size


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
        self.create_dataset(path, data=value)

    def __delitem__(self, path: str):
        self._file._writable()
        parent, name = self._walk(path)
        del parent.children[name]
        self._file._rewrite = True

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       chunks=None, maxshape=None) -> Dataset:
        """A new dataset (zeros of ``shape``/``dtype``, or ``data``),
        written to the file now. ``chunks`` (a shape, or True for the whole
        shape) stores it chunked, with no chunk written until one is
        assigned; ``maxshape`` (None entries unlimited; chunked, and by
        default the shape) bounds ``resize``."""
        file = self._file
        file._writable()
        parent, name = self._walk(path, create=True)
        if name in parent.children:
            raise ValueError(f"{path!r} already exists")
        arr = None
        if data is not None:
            arr = _to_storable(data)
            if shape is not None and tuple(arr.shape) != tuple(shape):
                arr = arr.reshape(shape)
            if dtype is not None:
                arr = _to_storable(arr.astype(dtype))
            shape, dt = arr.shape, arr.dtype
        else:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            dt = _little(np.dtype(dtype or np.float64))
        if maxshape is not None and chunks is None:
            chunks = True
        if chunks is True:
            chunks = tuple(max(n, 1) for n in shape)
        if chunks is not None and not shape:
            raise ValueError("a scalar dataset cannot be chunked")
        if chunks is None:
            node = file._new_contiguous(shape, dt, arr)
        else:
            node = _DatasetNode(
                shape=shape, dtype=dt, path=file._path, chunks=chunks,
                maxshape=shape if maxshape is None else maxshape, index={})
            if arr is not None and arr.size:
                file._write_box(node, (0,) * arr.ndim, arr.shape, arr)
        parent.children[name] = node
        return Dataset(node, file)

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

def _parse_link(buf, off: int):
    """(name, object header address) of the hard link message at ``off``;
    None for a soft or external link (not followed)."""
    flags = buf[off + 1]
    q = off + 2
    ltype = 0
    if flags & 0x08:
        ltype = buf[q]
        q += 1
    q += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
    nb = 1 << (flags & 3)
    nlen = int.from_bytes(bytes(buf[q:q + nb]), "little")
    q += nb
    name = bytes(buf[q:q + nlen]).decode()
    if ltype != 0:
        return None
    return name, struct.unpack_from("<Q", buf, q + nlen)[0]


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
            elif mtype == 0x02:     # link info: dense storage if a heap
                q = off + 2 + (8 if buf[off + 1] & 1 else 0)
                heap, names = struct.unpack_from("<QQ", buf, q)
                if heap != _UNDEF:
                    for msg in hix.dense_link_messages(buf, heap, names):
                        link = _parse_link(msg, 0)
                        if link is not None:
                            out.append(link)
            elif mtype == 0x06:     # link
                link = _parse_link(buf, off)
                if link is not None:
                    out.append(link)
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
        filters = ()
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
                filters = hix.parse_filters(buf, off)
        if shape is None or dtype is None or layout is None:
            raise OSError("dataset without dataspace, datatype or layout")
        version, lclass = buf[layout], buf[layout + 1]
        if version not in (3, 4):
            raise NotImplementedError(f"layout message version {version}")
        node = dict(shape=shape, dtype=dtype, path=self.path)
        if lclass == 2:
            if dtype is _VlenStr:
                raise NotImplementedError("chunked variable-length strings")
            maxshape = maxshape or shape
            if version == 3:
                ndims = buf[layout + 2]             # the dataset's + 1
                btree = struct.unpack_from("<Q", buf, layout + 3)[0]
                chunks = struct.unpack_from(f"<{ndims}I", buf,
                                            layout + 11)[:-1]
                index = {} if btree == _UNDEF else self._chunk_btree(
                    btree, ndims)
                edge_raw = False
            else:
                chunks, index, edge_raw = hix.chunk_index_v4(
                    buf, layout, shape, maxshape, dtype.itemsize)
            return _DatasetNode(chunks=chunks, maxshape=maxshape,
                                index=index, filters=filters,
                                edge_raw=edge_raw, **node)
        if lclass == 0:
            n = struct.unpack_from("<H", buf, layout + 2)[0]
            raw, span = bytes(buf[layout + 4:layout + 4 + n]), None
        elif lclass == 1:
            daddr, n = struct.unpack_from("<QQ", buf, layout + 2)
            raw = None
            span = None if daddr == _UNDEF else (daddr, n)
        else:
            raise NotImplementedError(f"layout class {lclass} (virtual)")
        if dtype is _VlenStr:
            data = raw if raw is not None else (
                bytes(buf[span[0]:span[0] + span[1]]) if span else b"")
            count = int(np.prod(shape)) if shape else 1
            vals = np.empty(count, dtype=object)
            for k in range(count):
                n_, caddr, idx = struct.unpack_from("<IQI", data, 16 * k)
                vals[k] = self._global_heap(caddr, idx)[:n_]
            node.update(dtype=np.dtype(object), array=vals.reshape(shape))
            return _DatasetNode(**node)
        if raw is not None:
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
            return _DatasetNode(array=arr.astype(_little(dtype)), **node)
        return _DatasetNode(span=span, **node)

    def _chunk_btree(self, addr: int, ndims: int):
        """{offsets: (address, bytes, filter mask)} of the chunks below the
        version 1 B-tree node (type 1) at ``addr``."""
        buf = self.buf
        if bytes(buf[addr:addr + 4]) != b"TREE" or buf[addr + 4] != 1:
            raise OSError("bad chunk B-tree")
        level = buf[addr + 5]
        used = struct.unpack_from("<H", buf, addr + 6)[0]
        ksize = 8 + 8 * ndims
        out = {}
        p = addr + 24
        for _ in range(used):
            nbytes, mask = struct.unpack_from("<II", buf, p)
            offsets = struct.unpack_from(f"<{ndims}Q", buf, p + 8)
            child = struct.unpack_from("<Q", buf, p + ksize)[0]
            if level > 0:
                out.update(self._chunk_btree(child, ndims))
            else:
                out[offsets[:-1]] = (child, nbytes, mask)
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


def _tree_nodes(root):
    """(groups, datasets) below ``root``, children before parents."""
    groups, datasets = [], []

    def visit(node):
        for child in node.children.values():
            if isinstance(child, _GroupNode):
                visit(child)
            else:
                datasets.append(child)
        groups.append(node)
    visit(root)
    return groups, datasets


def _append_at(root, version: int):
    """Where this module's next data can go in a file of its own layout
    (superblock 2; every contiguous or compact dataset's header and data
    and every chunk before the chunked datasets' headers and the group
    headers, which ``close()`` writes anew): the first of those headers.
    None for any other layout, or a chunked dataset it could not write
    back as it is (filtered, big endian)."""
    groups, datasets = _tree_nodes(root)
    if version != 2:
        return None
    start = min([g.addr for g in groups]
                + [d.addr for d in datasets if d.chunks is not None])
    for d in datasets:
        if d.chunks is None:
            if d.addr >= start or (d.span is not None
                                   and d.span[0] + d.span[1] > start):
                return None
        elif d.filters or d.dtype.byteorder == ">" or any(
                a + n > start for a, n, _ in d.index.values()):
            return None
    return start


def _parse(path: str):
    """(root, end of the data or None) of the file at ``path`` (see
    ``_append_at``)."""
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0,
                                           access=mmap.ACCESS_READ) as mm:
        buf = memoryview(mm)
        try:
            reader = _Reader(buf, path)
            root = reader.node(reader.root)
            version = reader.version
        finally:
            buf.release()
    return root, _append_at(root, version)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _ohdr(messages) -> bytes:
    """A version 2 object header holding ``messages`` [(type, data)]."""
    body = b"".join(struct.pack("<BHB", t, len(d), 0) + d
                    for t, d in messages)
    raw = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body)) + body
    return raw + struct.pack("<I", lookup3(raw))


_FILL = bytes([3, 0x0A])        # allocated late, filled if set, no value


def _contiguous_header(shape, dtype, daddr: int, nbytes: int) -> bytes:
    """The object header of a contiguous dataset whose data is at
    ``daddr`` (``_UNDEF`` for none); its length does not depend on the
    address."""
    if shape:
        space = struct.pack("<BBBB", 2, len(shape), 0, 1) + struct.pack(
            f"<{len(shape)}Q", *shape)
    else:
        space = struct.pack("<BBBB", 2, 0, 0, 0)
    layout = struct.pack("<BBQQ", 3, 1, daddr, nbytes)
    return _ohdr([(0x01, space), (0x03, _encode_dtype(dtype)),
                  (0x05, _FILL), (0x08, layout)])


def _dataset_blob(arr: np.ndarray, addr: int):
    """(object header then data of ``arr`` placed at ``addr``, data
    offset)."""
    data = arr.tobytes()
    hlen = len(_contiguous_header(arr.shape, arr.dtype, 0, len(data)))
    daddr = addr + hlen if data else _UNDEF
    return (_contiguous_header(arr.shape, arr.dtype, daddr, len(data))
            + data, daddr)


# Entries of a chunk B-tree node: 2 K with the library's default K = 32
# for chunk indexes (superblock 2 stores no K).
_CHUNK_NODE = 64


def _chunked_meta(node: _DatasetNode, addr: int) -> bytes:
    """The object header and chunk B-tree nodes of the chunked dataset
    ``node``, placed at ``addr``.

    A version 3 layout message (class 2) indexes the chunks by a version 1
    B-tree of type 1; its keys are the chunks' offsets in C order, a last
    key one chunk past the last one, as the HDF5 library keys them, and its
    nodes hold up to 64 entries (levels are added above as needed)."""
    nd = len(node.shape)
    chunks = node.chunks
    maxshape = tuple(_UNDEF if m is None else m for m in node.maxshape)
    space = struct.pack("<BBBB", 2, nd, 1, 1) + struct.pack(
        f"<{2 * nd}Q", *node.shape, *maxshape)
    dtype = _encode_dtype(node.dtype)
    esize = node.dtype.itemsize
    chunk_list = sorted(node.index.items())
    offsets = [o for o, _ in chunk_list]
    ksize = 8 + 8 * (nd + 1)
    nsize = 24 + _CHUNK_NODE * (ksize + 8) + ksize

    def key(nbytes, mask, offs):
        return struct.pack("<II", nbytes, mask) + struct.pack(
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
        return _ohdr([(0x01, space), (0x03, dtype), (0x05, _FILL),
                      (0x08, layout)])

    tree_at = addr + len(header(0))
    # Node addresses: the root first, then each level below in order.
    naddr, p = [], tree_at
    for nodes in reversed(levels):
        naddr.insert(0, [p + j * nsize for j in range(len(nodes))])
        p += len(nodes) * nsize
    blobs = []
    for lv in reversed(range(len(levels)) if offsets else ()):
        nodes = levels[lv]
        for j, ents in enumerate(nodes):
            right_key = nodes[j + 1][0][0] if j + 1 < len(nodes) else last
            body = struct.pack("<4sBBH", b"TREE", 1, lv, len(ents))
            body += struct.pack("<QQ", naddr[lv][j - 1] if j else _UNDEF,
                                naddr[lv][j + 1] if j + 1 < len(nodes)
                                else _UNDEF)
            for k, child in ents:
                if lv == 0:
                    caddr, nbytes, mask = chunk_list[child][1]
                    body += key(nbytes, mask, k)
                    body += struct.pack("<Q", caddr)
                else:
                    body += key(node.chunk_bytes, 0, k)
                    body += struct.pack("<Q", naddr[lv - 1][child])
            body += key(0, 0, right_key)
            blobs.append(body + bytes(nsize - len(body)))
    root = naddr[-1][0] if offsets else _UNDEF
    return header(root) + b"".join(blobs)


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


# path -> (stat key, root, end of data): the trees this process last
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
        self._fd = None
        self._key = None
        exists = os.path.exists(self._path)
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(self.filename)
        if mode == "w" or (mode == "a" and (
                not exists or os.path.getsize(self._path) == 0)):
            _TREES.pop(self._path, None)
            self._fd = os.open(self._path,
                               os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
            root = _GroupNode()
            self._data_end = self._session = _SUPER_LEN
            self._rewrite = False
        else:
            key = _stat_key(self._path)
            cached = _TREES.pop(self._path, None)
            if cached is not None and cached[0] == key:
                _, root, self._data_end = cached
            else:
                root, self._data_end = _parse(self._path)
            if mode == "r":
                _keep_tree(self._path, (key, root, self._data_end))
            else:
                self._fd = os.open(self._path, os.O_RDWR)
                # This session's data goes past the end of the file, so
                # that the file stays whole until close().
                self._session = max(os.fstat(self._fd).st_size, _SUPER_LEN)
                self._rewrite = self._data_end is None
        if self._fd is not None:
            self._key = _stat_key(self._path)
            self._end = self._session
        super().__init__(root, self)

    def _writable(self):
        if self.mode == "r":
            raise ValueError("file opened read-only")

    # -- writing data as it comes ------------------------------------------

    def _changed(self) -> OSError | None:
        if os.path.exists(self._path) and _stat_key(self._path) == self._key:
            return None
        return OSError(f"{self.filename} changed on disk while open for "
                       "writing; nothing was written")

    def _put(self, offset: int, data) -> None:
        """Write ``data`` at ``offset``: refused if another writer changed
        the file since this one last wrote."""
        err = self._changed()
        if err is not None:
            raise err
        _pwrite(self._fd, offset, data)
        self._key = _stat_key(self._path)

    def _alloc(self, nbytes: int) -> int:
        addr = self._end
        self._end += nbytes
        return addr

    def _new_contiguous(self, shape, dtype, arr) -> _DatasetNode:
        """A contiguous dataset, its header and data written now (zeros
        where ``arr`` is None)."""
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        hlen = len(_contiguous_header(shape, dtype, 0, nbytes))
        addr = self._alloc(hlen + nbytes)
        daddr = addr + hlen if nbytes else _UNDEF
        self._put(addr, _contiguous_header(shape, dtype, daddr, nbytes))
        if arr is not None and nbytes:
            self._put(daddr, _bytes_of(arr))
        elif nbytes:
            os.ftruncate(self._fd, max(self._end,
                                       os.fstat(self._fd).st_size))
            self._key = _stat_key(self._path)
        return _DatasetNode(shape=shape, dtype=dtype, path=self._path,
                            addr=addr, span=(daddr, nbytes) if nbytes
                            else None)

    def _own_contiguous(self, node: _DatasetNode) -> None:
        """Move a contiguous dataset from before this session to its end
        (header and data), so that writing it leaves the file as it was
        until close()."""
        if node.addr is not None and node.addr >= self._session:
            return
        fresh = self._new_contiguous(node.shape, _little(node.dtype), None)
        if node.span is not None:
            swap = node.dtype if node.dtype.byteorder == ">" else None
            _copy_range(self._fd, node.span[0], self._fd, fresh.span[0],
                        node.span[1], swap)
            self._key = _stat_key(self._path)
        node.addr, node.span, node.dtype = fresh.addr, fresh.span, \
            fresh.dtype

    def _write_box(self, node: _DatasetNode, lo, hi, block) -> None:
        """Write ``block``, the values of the box [lo, hi), to the file:
        the rows of a contiguous dataset, or each chunk the box touches."""
        if node.chunks is None:
            self._own_contiguous(node)
            block = np.asarray(block, node.dtype)
            if node.span is None:
                return
            if not node.shape:
                self._put(node.span[0], _bytes_of(block))
                return
            row = node.dtype.itemsize * int(np.prod(node.shape[1:],
                                                    dtype=np.int64))
            at = node.span[0] + lo[0] * row
            if tuple(hi[1:]) != node.shape[1:] or any(lo[1:]):
                rows = node.read_box((lo[0],) + (0,) * (len(lo) - 1),
                                     (hi[0],) + node.shape[1:], little=False)
                rows[(slice(None),) + tuple(map(slice, lo[1:], hi[1:]))] = \
                    block
                block = rows
            self._put(at, _bytes_of(block))
            return
        if node.filters:
            raise NotImplementedError("h5lite writes no filters: cannot "
                                      "write into a filtered dataset")
        block = np.asarray(block, node.dtype)
        chunks = node.chunks
        cbytes = node.chunk_bytes
        crow = cbytes // chunks[0]
        for off in _grid(lo, hi, chunks):
            a = [max(x, o) - o for x, o in zip(lo, off)]
            b = [min(y, o + c) - o for y, o, c in zip(hi, off, chunks)]
            src = block[tuple(slice(o + s - x, o + e - x)
                              for o, s, e, x in zip(off, a, b, lo))]
            entry = node.index.get(off)
            if (entry is not None and entry[0] >= self._session
                    and entry[1] == cbytes and not entry[2]):
                # A chunk of this session: patch its rows [a0, b0) in place.
                at = entry[0] + a[0] * crow
                if list(b[1:]) != list(chunks[1:]) or any(a[1:]):
                    rows = np.empty((b[0] - a[0],) + chunks[1:], node.dtype)
                    with _Reading(self._path) as fd:
                        _pread_into(fd, at, rows)
                    rows[(slice(None),) + tuple(map(slice, a[1:], b[1:]))] \
                        = src
                    src = rows
                self._put(at, _bytes_of(src))
                continue
            # Else the whole chunk (zeros where it has no address yet),
            # patched and written at the end of the file.
            if entry is None:
                full = np.zeros(chunks, node.dtype)
            else:
                full = np.empty(chunks, node.dtype)
                with _Reading(node.path) as fd:
                    _pread_into(fd, entry[0], full)
            full[tuple(map(slice, a, b))] = src
            addr = self._alloc(cbytes)
            self._put(addr, _bytes_of(full))
            node.index[off] = (addr, cbytes, 0)

    # -- closing -------------------------------------------------------------

    def close(self):
        """Finish the file (a writable one): its chunked datasets' indexes,
        the group headers and the superblock, after streaming the kept data
        into a new file where a deletion or another layout needs it. A file
        another writer changed since it was opened here raises instead, as
        the two trees would overwrite each other."""
        if self.mode == "r":
            return
        self.mode = "r"
        fd, self._fd = self._fd, None
        try:
            err = self._changed()
            if err is not None:
                raise err
            if self._rewrite:
                self._write_anew(fd)
            else:
                self._write_tail(fd)
        finally:
            os.close(fd)
        _keep_tree(self._path, (_stat_key(self._path), self._node,
                                self._data_end))

    def _write_meta(self, fd: int, end: int, datasets, groups) -> None:
        """Write, from ``end``, the chunked datasets' headers and B-trees
        and every group header (children before parents); then cut the
        file there and write the superblock."""
        self._data_end = end
        meta = []
        for d in datasets:
            if d.chunks is not None:
                blob = _chunked_meta(d, end)
                d.addr = end
                meta.append(blob)
                end += len(blob)
        for g in groups:
            blob = _group_header(g)
            g.addr = end
            meta.append(blob)
            end += len(blob)
        _pwrite(fd, self._data_end, b"".join(meta))
        os.ftruncate(fd, end)
        _pwrite(fd, 0, _superblock(end, self._node.addr))

    def _write_tail(self, fd: int) -> None:
        """Close a session on a file of this module's layout: datasets held
        in memory are written, the session's data moves down over the old
        headers when it fits there, and the headers follow it."""
        groups, datasets = _tree_nodes(self._node)
        for d in datasets:
            if d.array is not None and d.addr is None:
                self._end = self._flush_array(d, fd, self._end)
        start, end = self._session, self._end
        shift = start - self._data_end
        if 0 < end - start <= shift:
            _copy_range(fd, start, fd, self._data_end, end - start)
            for d in datasets:
                if d.chunks is not None:
                    d.index = {o: (a - shift if a >= start else a, n, m)
                               for o, (a, n, m) in d.index.items()}
                elif d.addr is not None and d.addr >= start:
                    d.addr -= shift
                    if d.span is not None:
                        d.span = (d.span[0] - shift, d.span[1])
                    # Its header holds its data's address.
                    _pwrite(fd, d.addr, _contiguous_header(
                        d.shape, d.dtype,
                        d.span[0] if d.span else _UNDEF,
                        d.span[1] if d.span else 0))
            end -= shift
        self._write_meta(fd, end, datasets, groups)

    def _write_anew(self, old: int) -> None:
        """Stream every kept dataset into a temporary file beside this one
        (a contiguous one in bounded byte ranges, a chunked one chunk by
        chunk, filters undone and values turned little endian), write the
        headers after them and replace the file with it."""
        groups, datasets = _tree_nodes(self._node)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._path),
                                   prefix=".h5lite-", suffix=".tmp")
        try:
            end = _SUPER_LEN
            for d in datasets:
                if d.array is not None:
                    end = self._flush_array(d, fd, end)
                elif d.chunks is None:
                    n = d.span[1] if d.span is not None else 0
                    dt = _little(d.dtype)
                    head = _contiguous_header(d.shape, dt, 0, n)
                    daddr = end + len(head) if n else _UNDEF
                    _pwrite(fd, end, _contiguous_header(d.shape, dt, daddr,
                                                        n))
                    if n:
                        with _Reading(d.path) as src:
                            _copy_range(src, d.span[0], fd, daddr, n,
                                        d.dtype if dt != d.dtype else None)
                    d.addr, d.dtype = end, dt
                    d.span = (daddr, n) if n else None
                    end += len(head) + n
                else:
                    end = self._copy_chunks(d, fd, end)
                d.path = self._path
            self._write_meta(fd, end, datasets, groups)
        except BaseException:
            os.close(fd)
            os.unlink(tmp)
            raise
        os.close(fd)
        os.replace(tmp, self._path)
        self._rewrite = False

    def _flush_array(self, d: _DatasetNode, fd: int, end: int) -> int:
        """Write a dataset held in memory to ``fd`` at ``end`` as a
        contiguous one; the end of what was written."""
        blob, daddr = _dataset_blob(d.array, end)
        _pwrite(fd, end, blob)
        d.span = (daddr, d.array.nbytes) if daddr != _UNDEF else None
        d.addr, d.path, d.array = end, self._path, None
        return end + len(blob)

    @staticmethod
    def _copy_chunks(d: _DatasetNode, fd: int, end: int) -> int:
        """Copy the chunks of ``d`` to ``fd`` from ``end`` on, unfiltered
        and little endian; its index then points there."""
        dt = _little(d.dtype)
        cbytes = d.chunk_bytes
        index = {}
        with _Reading(d.path) as src:
            for off, entry in sorted(d.index.items()):
                if d._filtered(off):
                    data = hix.decode_chunk(_pread(src, entry[0], entry[1]),
                                            d.filters, entry[2])
                    if dt != d.dtype:
                        data = np.frombuffer(data, d.dtype).astype(
                            dt).tobytes()
                    _pwrite(fd, end, data)
                else:
                    _copy_range(src, entry[0], fd, end, cbytes,
                                d.dtype if dt != d.dtype else None)
                index[off] = (end, cbytes, 0)
                end += cbytes
        d.index, d.dtype, d.filters, d.edge_raw = index, dt, (), False
        return end

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # A writable file never closed: its descriptor goes, nothing more
        # is written.
        fd = getattr(self, "_fd", None)
        if fd is not None:
            os.close(fd)
