"""The HDF5 index and heap formats that ``utils/h5lite`` reads: chunk
filters, the version 4 layout message's chunk indexes, and dense link
storage.

* Filters: the filter pipeline message (versions 1 and 2) and the decoding
  of deflate (id 1, ``zlib``), shuffle (id 2) and fletcher32 (id 3, a
  mismatch raises ``OSError``), skipping a filter whose bit is set in the
  chunk's filter mask. Any other filter raises ``NotImplementedError``
  naming its id.
* Chunk indexes of the version 4 layout message, as ``libver="latest"``
  writes them: single chunk, implicit, fixed array (paged or not),
  extensible array (index, secondary and data blocks, paged or not) and
  the version 2 B-tree (records of types 10 and 11).
* Dense link storage: the fractal heap (direct and indirect blocks,
  managed and tiny objects) and the name-index version 2 B-tree (type 5),
  whose records give the heap ids of the encoded link messages.

Each reader takes the file mapped as ``buf`` (anything ``struct`` and
slicing read: bytes, mmap or memoryview) and returns plain Python values;
nothing here writes. The HDF5 file format specification (version 3.0) is
the reference for every layout below.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF


def _uint(buf, off: int, n: int) -> int:
    return int.from_bytes(bytes(buf[off:off + n]), "little")


def _log2(n: int) -> int:
    """floor(log2(n)) for n >= 1, HDF5's ``H5VM_log2_gen``."""
    return n.bit_length() - 1


def _limit_enc_size(n: int) -> int:
    """Bytes that encode values up to ``n``, ``H5VM_limit_enc_size``."""
    return _log2(n) // 8 + 1 if n else 1


def _signature(buf, addr: int, sig: bytes) -> None:
    if bytes(buf[addr:addr + 4]) != sig:
        raise OSError(f"bad {sig.decode()} block at byte {addr}")


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 32000: "lzf"}
_READ_FILTERS = (1, 2, 3)


def parse_filters(buf, off: int):
    """[(id, flags, client data)] of the filter pipeline message at
    ``off`` (versions 1 and 2), in the order the writer applied them."""
    version, nfilters = buf[off], buf[off + 1]
    if version not in (1, 2):
        raise NotImplementedError(f"filter pipeline message version "
                                  f"{version}")
    p = off + (8 if version == 1 else 2)
    out = []
    for _ in range(nfilters):
        fid = struct.unpack_from("<H", buf, p)[0]
        p += 2
        nlen = 0
        if version == 1 or fid >= 256:
            nlen = struct.unpack_from("<H", buf, p)[0]
            p += 2
        flags, nvals = struct.unpack_from("<HH", buf, p)
        p += 4
        if version == 1:
            nlen = -(-nlen // 8) * 8
        p += nlen
        cdata = struct.unpack_from(f"<{nvals}I", buf, p)
        p += 4 * nvals
        if version == 1 and nvals % 2:
            p += 4
        out.append((fid, flags, tuple(cdata)))
    return out


def fletcher32(data) -> int:
    """HDF5's ``H5_checksum_fletcher32`` of ``data`` (16-bit big-endian
    words, sums folded every 360 words)."""
    data = bytes(data)
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], dtype=">u2").astype(np.int64)
    sum1 = sum2 = 0
    for s in range(0, len(words), 360):
        block = words[s:s + 360]
        csum = np.cumsum(block)
        sum2 = (sum2 + len(block) * sum1 + int(csum.sum())) & 0xFFFFFFFF
        sum1 = (sum1 + int(csum[-1])) & 0xFFFFFFFF
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if n % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def decode_chunk(raw, filters, mask: int) -> bytes:
    """The chunk's bytes before the writer's filters: each filter undone in
    reverse order, unless bit i of ``mask`` says filter i was skipped. A
    filter this module cannot undo raises ``NotImplementedError`` naming
    its id."""
    data = raw
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid, _, cdata = filters[i]
        if fid not in _READ_FILTERS:
            raise NotImplementedError(
                f"HDF5 filter id {fid} ({FILTER_NAMES.get(fid, 'unknown')})"
                " is not read")
        if fid == 1:
            data = zlib.decompress(bytes(data))
        elif fid == 2:
            size = cdata[0] if cdata else 1
            data = bytes(data)
            nelem = len(data) // size
            body = np.frombuffer(data, np.uint8, count=nelem * size)
            data = body.reshape(size, nelem).T.tobytes() + data[nelem * size:]
        elif fid == 3:
            data = bytes(data)
            body, stored = data[:-4], struct.unpack("<I", data[-4:])[0]
            want = fletcher32(body)
            # Libraries before 1.6.3 stored it with each half's bytes
            # swapped; HDF5 accepts either.
            swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
            if stored not in (want, swapped):
                raise OSError("fletcher32 checksum mismatch in a chunk")
            data = body
    return bytes(data)


# ---------------------------------------------------------------------------
# Version 2 B-trees
# ---------------------------------------------------------------------------

def btree2_records(buf, addr: int):
    """(type, [record bytes]) of every record of the version 2 B-tree whose
    header is at ``addr``, in key order."""
    _signature(buf, addr, b"BTHD")
    btype = buf[addr + 5]
    node_size, rsize, depth = struct.unpack_from("<IHH", buf, addr + 6)
    root, root_nrec = struct.unpack_from("<QH", buf, addr + 16)
    if root == UNDEF:
        return btype, []
    # Per depth: max records of a node and of its whole subtree, and the
    # bytes of their counts (H5B2__hdr_init).
    prefix = 10
    max_nrec = [(node_size - prefix) // rsize]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _limit_enc_size(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - (prefix + ptr)) // (rsize + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_limit_enc_size(cum[d]))
    out = []

    def visit(naddr, nrec, d):
        if d == 0:
            _signature(buf, naddr, b"BTLF")
            p = naddr + 6
            out.extend(bytes(buf[p + i * rsize:p + (i + 1) * rsize])
                       for i in range(nrec))
            return
        _signature(buf, naddr, b"BTIN")
        p = naddr + 6
        recs = [bytes(buf[p + i * rsize:p + (i + 1) * rsize])
                for i in range(nrec)]
        p += nrec * rsize
        csize = cum_size[d - 1] if d > 1 else 0
        for i in range(nrec + 1):
            child = struct.unpack_from("<Q", buf, p)[0]
            cn = _uint(buf, p + 8, nrec_size)
            p += 8 + nrec_size + csize
            visit(child, cn, d - 1)
            if i < nrec:
                out.append(recs[i])

    visit(root, root_nrec, depth)
    return btype, out


# ---------------------------------------------------------------------------
# Version 4 chunk indexes
# ---------------------------------------------------------------------------

def _unravel(idx: int, dims):
    """Row-major coordinates of linear index ``idx`` over ``dims``."""
    out = []
    for d in reversed(dims[1:]):
        out.append(idx % d)
        idx //= d
    out.append(idx)
    return tuple(reversed(out))


def _chunk_element(raw, filtered: bool, size_len: int, cbytes: int):
    """(address, bytes, filter mask) of a fixed or extensible array
    element."""
    addr = struct.unpack_from("<Q", raw, 0)[0]
    if not filtered:
        return addr, cbytes, 0
    nbytes = _uint(raw, 8, size_len)
    mask = struct.unpack_from("<I", raw, 8 + size_len)[0]
    return addr, nbytes, mask


def _page_bit(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _fixed_array(buf, addr: int, cbytes: int):
    """[(linear chunk index, (address, bytes, mask))] of a fixed array."""
    _signature(buf, addr, b"FAHD")
    client, esize, page_bits = buf[addr + 5], buf[addr + 6], buf[addr + 7]
    nelmts, dblk = struct.unpack_from("<QQ", buf, addr + 8)
    if dblk == UNDEF:
        return []
    _signature(buf, dblk, b"FADB")
    filtered = client == 1
    size_len = esize - 12
    page = 1 << page_bits
    p = dblk + 6 + 8
    out = []
    if nelmts > page:
        npages = -(-nelmts // page)
        bitmap = bytes(buf[p:p + (npages + 7) // 8])
        p += (npages + 7) // 8 + 4
        for pg in range(npages):
            q = p + pg * (page * esize + 4)
            if not _page_bit(bitmap, pg):
                continue
            for i in range(min(page, nelmts - pg * page)):
                e = bytes(buf[q + i * esize:q + (i + 1) * esize])
                out.append((pg * page + i,
                            _chunk_element(e, filtered, size_len, cbytes)))
        return out
    for i in range(nelmts):
        e = bytes(buf[p + i * esize:p + (i + 1) * esize])
        out.append((i, _chunk_element(e, filtered, size_len, cbytes)))
    return out


def _extensible_array(buf, addr: int, cbytes: int):
    """[(linear chunk index, (address, bytes, mask))] of an extensible
    array: the index block's own elements, its data blocks, then the
    secondary blocks' data blocks (H5EA__lookup_elmt's walk)."""
    _signature(buf, addr, b"EAHD")
    (client, esize, max_bits, iblk_elmts, dblk_min, sblk_min_ptrs,
     page_bits) = buf[addr + 5:addr + 12]
    max_idx = struct.unpack_from("<Q", buf, addr + 12 + 32)[0]
    iblock = struct.unpack_from("<Q", buf, addr + 12 + 48)[0]
    if iblock == UNDEF:
        return []
    filtered = client == 1
    size_len = esize - 12
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    nsblks = 1 + max_bits - _log2(dblk_min)
    info, start_idx, start_dblk = [], 0, 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        info.append((ndblks, nelmts, start_idx, start_dblk))
        start_idx += ndblks * nelmts
        start_dblk += ndblks
    iblk_sblks = 2 * _log2(sblk_min_ptrs)
    n_dblk_addrs = 2 * (sblk_min_ptrs - 1)
    _signature(buf, iblock, b"EAIB")
    p = iblock + 6 + 8
    out = []

    def element(base, i):
        e = bytes(buf[base + i * esize:base + (i + 1) * esize])
        return _chunk_element(e, filtered, size_len, cbytes)

    for i in range(min(iblk_elmts, max_idx)):
        out.append((i, element(p, i)))
    p += iblk_elmts * esize
    dblk_addrs = struct.unpack_from(f"<{n_dblk_addrs}Q", buf, p)
    p += 8 * n_dblk_addrs
    sblk_addrs = struct.unpack_from(f"<{nsblks - iblk_sblks}Q", buf, p)
    dprefix = 6 + 8 + off_size + 4       # a data block's header and sum

    def data_block(daddr, first, nelmts, bitmap=None, npages=0):
        if daddr == UNDEF:
            return
        _signature(buf, daddr, b"EADB")
        if not npages:
            base = daddr + dprefix - 4
            for i in range(nelmts):
                if first + i < max_idx:
                    out.append((first + i, element(base, i)))
            return
        for pg in range(npages):
            if not bitmap(pg):
                continue
            base = daddr + dprefix + pg * (page * esize + 4)
            for i in range(page):
                if first + pg * page + i < max_idx:
                    out.append((first + pg * page + i, element(base, i)))

    for u in range(nsblks):
        ndblks, nelmts, sidx, sdblk = info[u]
        first = iblk_elmts + sidx
        if first >= max_idx:
            break
        if u < iblk_sblks:
            for d in range(ndblks):
                data_block(dblk_addrs[sdblk + d], first + d * nelmts, nelmts)
            continue
        saddr = sblk_addrs[u - iblk_sblks]
        if saddr == UNDEF:
            continue
        _signature(buf, saddr, b"EASB")
        q = saddr + 6 + 8 + off_size
        npages = nelmts // page if nelmts > page else 0
        init_size = (npages + 7) // 8
        bitmaps = bytes(buf[q:q + ndblks * init_size])
        q += ndblks * init_size
        addrs = struct.unpack_from(f"<{ndblks}Q", buf, q)
        for d in range(ndblks):
            bits = bitmaps[d * init_size:(d + 1) * init_size]
            data_block(addrs[d], first + d * nelmts, nelmts,
                       lambda pg, bits=bits: _page_bit(bits, pg), npages)
    return out


def chunk_index_v4(buf, layout: int, shape, maxshape, esize: int):
    """(chunk shape, {chunk offsets: (address, bytes, filter mask)},
    partial edge chunks unfiltered) of the version 4 layout message
    (class 2) at ``layout``; ``maxshape`` holds None where unlimited."""
    flags, ndims, enc = buf[layout + 2], buf[layout + 3], buf[layout + 4]
    p = layout + 5
    dims = [_uint(buf, p + i * enc, enc) for i in range(ndims)]
    p += ndims * enc
    chunks = tuple(dims[:-1])
    itype = buf[p]
    p += 1
    rank = len(chunks)
    cbytes = int(np.prod(chunks, dtype=np.int64)) * esize
    max_chunks = [-(-(n if m is None else m) // c)
                  for n, m, c in zip(shape, maxshape, chunks)]
    entries = {}

    def put(scaled, entry):
        if entry[0] != UNDEF:
            entries[tuple(s * c for s, c in zip(scaled, chunks))] = entry

    if itype == 1:              # single chunk
        nbytes, mask = cbytes, 0
        if flags & 2:
            nbytes, mask = struct.unpack_from("<QI", buf, p)
            p += 12
        put((0,) * rank, (struct.unpack_from("<Q", buf, p)[0], nbytes, mask))
    elif itype == 2:            # implicit: every chunk allocated in order
        base = struct.unpack_from("<Q", buf, p)[0]
        if base != UNDEF:
            for i in range(int(np.prod(max_chunks, dtype=np.int64))):
                put(_unravel(i, max_chunks), (base + i * cbytes, cbytes, 0))
    elif itype == 3:            # fixed array
        addr = struct.unpack_from("<Q", buf, p + 1)[0]
        if addr != UNDEF:
            for i, entry in _fixed_array(buf, addr, cbytes):
                put(_unravel(i, max_chunks), entry)
    elif itype == 4:            # extensible array, one unlimited dimension
        addr = struct.unpack_from("<Q", buf, p + 5)[0]
        unlim = [d for d, m in enumerate(maxshape) if m is None]
        if len(unlim) != 1:
            raise OSError("extensible array index without one unlimited "
                          "dimension")
        u = unlim[0]
        swizzled = [0] + [m for d, m in enumerate(max_chunks) if d != u]
        if addr != UNDEF:
            for i, entry in _extensible_array(buf, addr, cbytes):
                sc = _unravel(i, swizzled)
                put(sc[1:u + 1] + (sc[0],) + sc[u + 1:], entry)
    elif itype == 5:            # version 2 B-tree
        addr = struct.unpack_from("<Q", buf, p + 6)[0]
        if addr != UNDEF:
            btype, recs = btree2_records(buf, addr)
            for r in recs:
                caddr = struct.unpack_from("<Q", r, 0)[0]
                if btype == 10:
                    nbytes, mask, q = cbytes, 0, 8
                elif btype == 11:
                    size_len = len(r) - 8 - 4 - 8 * rank
                    nbytes = _uint(r, 8, size_len)
                    mask = struct.unpack_from("<I", r, 8 + size_len)[0]
                    q = 12 + size_len
                else:
                    raise OSError(f"chunk B-tree record type {btype}")
                put(struct.unpack_from(f"<{rank}Q", r, q),
                    (caddr, nbytes, mask))
    else:
        raise NotImplementedError(f"chunk index type {itype}")
    return chunks, entries, bool(flags & 1)


# ---------------------------------------------------------------------------
# Dense link storage
# ---------------------------------------------------------------------------

class FractalHeap:
    """A fractal heap's managed and tiny objects by heap id."""

    def __init__(self, buf, addr: int):
        _signature(buf, addr, b"FRHP")
        self.buf = buf
        self.id_len, filt_len = struct.unpack_from("<HH", buf, addr + 5)
        if filt_len:
            raise NotImplementedError("filtered fractal heaps")
        self.max_man = struct.unpack_from("<I", buf, addr + 10)[0]
        p = addr + 14 + 8 * 12
        self.width = struct.unpack_from("<H", buf, p)[0]
        self.start, self.max_direct = struct.unpack_from("<QQ", buf, p + 2)
        self.max_bits, _ = struct.unpack_from("<HH", buf, p + 18)
        self.root, self.root_rows = struct.unpack_from("<QH", buf, p + 22)
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min(
            (_log2(self.max_direct) + 7) // 8 if self.max_direct else 1,
            _limit_enc_size(self.max_man))
        self.max_direct_rows = (_log2(self.max_direct)
                                - _log2(self.start) + 2)
        self.blocks = []            # (heap offset, size, block address)
        if self.root != UNDEF:
            if self.root_rows == 0:
                self.blocks.append((0, self.start, self.root))
            else:
                self._indirect(self.root, self.root_rows)

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _indirect(self, addr: int, nrows: int):
        buf = self.buf
        _signature(buf, addr, b"FHIB")
        p = addr + 5 + 8
        block_off = _uint(buf, p, self.off_size)
        p += self.off_size
        off = block_off
        for r in range(nrows):
            size = self._row_size(r)
            for _ in range(self.width):
                child = struct.unpack_from("<Q", buf, p)[0]
                p += 8
                if r < self.max_direct_rows:
                    if child != UNDEF:
                        self.blocks.append((off, size, child))
                elif child != UNDEF:
                    rows = (_log2(size) - _log2(self.start * self.width)
                            + 1)
                    self._indirect(child, rows)
                off += size

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:               # tiny: the object is in the id
            n = (heap_id[0] & 0x0F) + 1
            return bytes(heap_id[1:1 + n])
        if kind != 0:
            raise NotImplementedError("huge fractal heap objects")
        off = _uint(heap_id, 1, self.off_size)
        n = _uint(heap_id, 1 + self.off_size, self.len_size)
        for start, size, addr in self.blocks:
            if start <= off < start + size:
                _signature(self.buf, addr, b"FHDB")
                p = addr + (off - start)
                return bytes(self.buf[p:p + n])
        raise OSError(f"fractal heap offset {off} in no direct block")


def dense_link_messages(buf, heap_addr: int, name_btree: int):
    """The encoded link messages of a group in dense storage, one a link,
    from its fractal heap through its name-index B-tree."""
    heap = FractalHeap(buf, heap_addr)
    btype, recs = btree2_records(buf, name_btree)
    if btype != 5:
        raise OSError(f"link name index B-tree of type {btype}")
    return [heap.get(r[4:4 + heap.id_len]) for r in recs]
