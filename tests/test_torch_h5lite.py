"""The port's HDF5 reader and writer (``utils/h5lite``) against h5py, on
the CPU.

* Filters: deflate, shuffle + deflate, fletcher32 (a damaged chunk raises
  ``OSError``, as in h5py) and a chunk whose filters its mask skipped, for
  float64, complex128 and int64.
* The version 4 layout message's chunk indexes, as h5py writes them under
  ``libver="latest"``: single chunk (plain and filtered), implicit, fixed
  array (plain, filtered and paged), extensible array (into its secondary
  blocks; plain and filtered) and version 2 B-tree (two levels; plain and
  filtered).
* Dense link storage: a ``libver="latest"`` group of 300 links, and one
  whose fractal heap has indirect blocks below its root.
* Reads touch only what the key asks for: the chunks a key intersects, the
  byte range of a contiguous dataset's rows.
* Writes go to disk as they come: a chunked dataset written in row slabs
  that do not line up with its chunks, resized, reopened with "a" and
  grown, read back by h5py; a file another writer changed is refused at
  the next write.
* The out-of-core Cholesky through h5lite (h5py hidden) keeps its traced
  host memory to a few chunks, also when it deletes its earlier dataset
  and when the file is h5py's, and equals JAX's h5py run to 1e-12.
* ``tests/data/h5lite_latest_gzip.h5`` (deflate, an extensible-array
  index, dense links; written once by ``write_latest_gzip``) reads as
  h5py reads it.
"""

import os
import sys
import tracemalloc

import h5py
import numpy as np
import pytest

from pauxy_tpu_torch.utils import h5lite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATEST_GZIP = os.path.join(ROOT, "tests", "data", "h5lite_latest_gzip.h5")


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "c16":
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if dtype == "i8":
        return rng.integers(-1000, 1000, size=shape)
    return rng.normal(size=shape)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


KEYS = [(), Ellipsis, slice(None), slice(3, 17), slice(-5, None),
        slice(None, None, -3), 4, -1, (slice(2, 9), 1),
        (slice(1, 19, 4), slice(None, None, 2)), (7, slice(1, 3)),
        (Ellipsis, 0), slice(30, 40)]


def assert_reads_as_h5py(fn, name, keys=KEYS):
    """h5lite's reads of ``name`` equal h5py's: the whole dataset, and
    each key against numpy's indexing of h5py's read (h5py takes no
    negative steps), an IndexError where numpy raises one."""
    with h5py.File(fn, "r") as fp, h5lite.File(fn, "r") as fl:
        whole, ds = fp[name][()], fl[name]
        assert ds.shape == fp[name].shape and ds.dtype == fp[name].dtype
        _same(np.asarray(ds), whole)
        for key in keys:
            try:
                want = whole[key]
            except IndexError:
                with pytest.raises(IndexError):
                    ds[key]
                continue
            _same(ds[key], want)


FILTERS = {"gzip": dict(compression="gzip"),
           "shuffle_gzip": dict(compression="gzip", shuffle=True),
           "fletcher32": dict(fletcher32=True),
           "all": dict(compression="gzip", compression_opts=9, shuffle=True,
                       fletcher32=True)}


@pytest.mark.parametrize("dtype", ["f8", "c16", "i8"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_filtered_chunks_read_as_h5py(tmp_path, filt, dtype):
    fn = str(tmp_path / "f.h5")
    with h5py.File(fn, "w") as f:
        f.create_dataset("x", data=_data((23, 7), dtype), chunks=(6, 3),
                         **FILTERS[filt])
    assert_reads_as_h5py(fn, "x")


def test_chunk_skipped_by_its_filter_mask(tmp_path):
    """A chunk written raw with both filters masked off, beside deflated
    and shuffled ones: the mask says which to undo."""
    fn = str(tmp_path / "m.h5")
    a = _data((18, 7), "f8")
    raw = np.full((6, 7), 3.25)
    with h5py.File(fn, "w") as f:
        d = f.create_dataset("x", data=a, chunks=(6, 7), compression="gzip",
                             shuffle=True)
        d.id.write_direct_chunk((6, 0), raw.tobytes(), filter_mask=0b11)
        d2 = f.create_dataset("y", data=a, chunks=(6, 7), compression="gzip")
        d2.id.write_direct_chunk((12, 0), raw.tobytes(), filter_mask=0b1)
    assert_reads_as_h5py(fn, "x")
    assert_reads_as_h5py(fn, "y")
    with h5lite.File(fn, "r") as f:
        _same(f["x"][6:12], raw)
        _same(f["y"][12:], raw)


def test_fletcher32_mismatch_raises(tmp_path):
    fn = str(tmp_path / "bad.h5")
    with h5py.File(fn, "w") as f:
        f.create_dataset("x", data=np.arange(64.0), chunks=(16,),
                         fletcher32=True)
        at = f["x"].id.get_chunk_info(1).byte_offset
    with open(fn, "r+b") as fh:
        fh.seek(at + 3)
        b = fh.read(1)
        fh.seek(at + 3)
        fh.write(bytes([b[0] ^ 0xFF]))
    with h5py.File(fn, "r") as f, pytest.raises(OSError):
        f["x"][16:32]
    with h5lite.File(fn, "r") as f:
        _same(f["x"][:16], np.arange(16.0))
        with pytest.raises(OSError, match="fletcher32"):
            f["x"][16:32]


def _implicit_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


# name -> (chunk index type of the version 4 layout message, shape,
# dataset options)
V4_CASES = {
    "single": (1, (5, 7), dict(chunks=(5, 7))),
    "single_gzip": (1, (5, 7), dict(chunks=(5, 7), compression="gzip")),
    "implicit": (2, (10, 6), dict(chunks=(3, 4), dcpl="implicit")),
    "fixed": (3, (23, 7), dict(chunks=(6, 3))),
    "fixed_gzip": (3, (23, 7), dict(chunks=(6, 3), compression="gzip",
                                    shuffle=True)),
    "fixed_max": (3, (5, 6), dict(chunks=(2, 4), maxshape=(9, 6))),
    "fixed_paged": (3, (1100,), dict(chunks=(1,))),
    "extensible": (4, (300, 2), dict(chunks=(1, 2), maxshape=(None, 2))),
    "extensible_gzip": (4, (300, 2), dict(chunks=(1, 2), maxshape=(None, 2),
                                          compression="gzip",
                                          fletcher32=True)),
    "extensible_last": (4, (3, 260), dict(chunks=(1, 1),
                                          maxshape=(3, None))),
    "btree": (5, (20, 20), dict(chunks=(1, 1), maxshape=(None, None))),
    "btree_gzip": (5, (20, 20), dict(chunks=(1, 1), maxshape=(None, None),
                                     compression="gzip")),
    "btree_deep": (5, (90, 90), dict(chunks=(1, 1),
                                     maxshape=(None, None))),
}


def index_types(monkeypatch):
    """The chunk index type of each version 4 layout message h5lite
    parses from now on."""
    seen = []
    real = h5lite.hix.chunk_index_v4

    def spy(buf, layout, *a):
        seen.append(buf[layout + 5 + buf[layout + 3] * buf[layout + 4]])
        return real(buf, layout, *a)

    monkeypatch.setattr(h5lite.hix, "chunk_index_v4", spy)
    return seen


@pytest.mark.parametrize("case", list(V4_CASES))
def test_version4_chunk_indexes_read_as_h5py(tmp_path, monkeypatch, case):
    itype, shape, opts = V4_CASES[case]
    opts = dict(opts)
    if opts.get("dcpl") == "implicit":
        opts["dcpl"] = _implicit_dcpl()
    fn = str(tmp_path / "v4.h5")
    dtype = "c16" if "gzip" in case else "f8"
    with h5py.File(fn, "w", libver="latest") as f:
        f.create_dataset("x", data=_data(shape, dtype), **opts)
    seen = index_types(monkeypatch)
    assert_reads_as_h5py(fn, "x")
    assert seen and set(seen) == {itype}


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_contiguous_and_compact_layouts_read_as_h5py(tmp_path, libver):
    fn = str(tmp_path / "c.h5")
    with h5py.File(fn, "w", libver=libver) as f:
        f["contig"] = _data((40, 3), "c16")
        f.create_dataset("compact", data=np.arange(6), dtype="i8")
    assert_reads_as_h5py(fn, "contig")
    assert_reads_as_h5py(fn, "compact", keys=[(), slice(2, 4), -1])


def test_dense_links_read_in_h5py_order(tmp_path):
    """A libver="latest" group of 300 links goes to dense storage (a
    fractal heap indexed by a version 2 B-tree of names); keys() comes in
    h5py's order and every link reaches its dataset."""
    fn = str(tmp_path / "d.h5")
    with h5py.File(fn, "w", libver="latest") as f:
        for i in range(300):
            f[f"many/n{(i * 7919) % 300}"] = np.full(2, i)
        f["few/a"] = np.arange(2)
    with h5py.File(fn, "r") as fp, h5lite.File(fn, "r") as fl:
        assert fl["many"].keys() == list(fp["many"].keys())
        assert len(fl["many"]) == 300
        for k in fl["many"].keys()[::17]:
            _same(fl[f"many/{k}"][()], fp[f"many/{k}"][()])
        assert fl.keys() == ["few", "many"]


def test_dense_links_through_indirect_blocks(tmp_path):
    """Long link names overflow the fractal heap's root indirect block's
    direct blocks, so that child indirect blocks hold the rest."""
    fn = str(tmp_path / "deep.h5")
    with h5py.File(fn, "w", libver="latest") as f:
        target = f.create_dataset("target", data=np.arange(3))
        for i in range(3000):
            f[f"g/{'x' * 200}{i:05d}"] = target
    with h5py.File(fn, "r") as fp, h5lite.File(fn, "r") as fl:
        keys = fl["g"].keys()
        assert keys == list(fp["g"].keys()) and len(keys) == 3000
        _same(fl[f"g/{keys[2345]}"][()], np.arange(3))


@pytest.fixture
def reads(monkeypatch):
    """The (offset, bytes) of every data read h5lite makes."""
    log = []
    into, plain = h5lite._pread_into, h5lite._pread

    def spy_into(fd, offset, out):
        log.append((offset, out.nbytes))
        into(fd, offset, out)

    def spy(fd, offset, nbytes):
        log.append((offset, nbytes))
        return plain(fd, offset, nbytes)

    monkeypatch.setattr(h5lite, "_pread_into", spy_into)
    monkeypatch.setattr(h5lite, "_pread", spy)
    return log


@pytest.mark.parametrize("filt", [None, "gzip"])
def test_slices_read_only_the_chunks_they_touch(tmp_path, reads, filt):
    fn = str(tmp_path / "s.h5")
    a = _data((100, 12), "f8")
    with h5py.File(fn, "w") as f:
        f.create_dataset("x", data=a, chunks=(8, 4), compression=filt)
        chunks = {f["x"].id.get_chunk_info(i).byte_offset:
                  f["x"].id.get_chunk_info(i).size for i in range(13 * 3)}
    with h5lite.File(fn, "r") as f:
        reads.clear()
        _same(f["x"][10:20], a[10:20])      # chunk rows 8 and 16, 3 wide
        assert len(reads) == 6
        assert all(next(o for o in chunks if o <= off < o + chunks[o])
                   for off, _ in reads)
        if filt is None:                    # rows 10..15 and 16..19 only
            assert sum(n for _, n in reads) == 10 * 12 * 8
        reads.clear()
        _same(f["x"][50, 5:7], a[50, 5:7])
        assert len(reads) == 1
        reads.clear()
        _same(f["x"][[1, 3]], a[[1, 3]])    # a list: the whole dataset
        assert len(reads) == 13 * 3


def test_contiguous_slices_read_only_their_rows(tmp_path, reads):
    fn = str(tmp_path / "c.h5")
    a = _data((50, 9), "c16")
    with h5py.File(fn, "w") as f:
        f["x"] = a
        start = f["x"].id.get_offset()
    with h5lite.File(fn, "r") as f:
        reads.clear()
        _same(f["x"][20:23, 4], a[20:23, 4])
        assert reads == [(start + 20 * 9 * 16, 3 * 9 * 16)]
        reads.clear()
        _same(f["x"][-1], a[-1])
        assert reads == [(start + 49 * 9 * 16, 9 * 16)]


def test_chunked_writes_stream_and_cross_h5py(tmp_path):
    """Row slabs that do not line up with the chunks, a shrinking resize,
    reopening with "a" to grow and write past the old shape, then h5py
    reading and growing it; each chunk is written as its rows come."""
    fn = str(tmp_path / "w.h5")
    a = _data((45, 10), "c16")
    with h5lite.File(fn, "w") as f:
        ds = f.create_dataset("x", (45, 10), "c16", chunks=(8, 4),
                              maxshape=(None, 10))
        assert os.path.getsize(fn) < 1000
        for s in range(0, 45, 7):
            ds[s:s + 7] = a[s:s + 7]
        size = os.path.getsize(fn)
        assert size >= 45 * 10 * 16         # on disk before close()
        ds[3, 2:9] = 0
        a[3, 2:9] = 0
        _same(ds[()], a)
        ds.resize((30, 10))
        f["flat"] = np.arange(5.0)
    with h5py.File(fn, "r") as f:
        assert f["x"].shape == (30, 10) and f["x"].maxshape == (None, 10)
        assert f["x"].chunks == (8, 4)
        _same(f["x"][()], a[:30])
    with h5lite.File(fn, "a") as f:
        ds = f["x"]
        ds.resize((50, 10))
        _same(ds[30:], np.zeros((20, 10), complex))
        ds[44:50] = a[39:45]
        ds[0] = -1
    with h5py.File(fn, "a") as f:
        got = f["x"][()]
        f["x"].resize((60, 10))
        f["x"][55] = 7
    want = np.zeros((50, 10), complex)
    want[:30] = a[:30]
    want[44:] = a[39:]
    want[0] = -1
    _same(got, want)
    with h5lite.File(fn, "r") as f:
        got = f["x"][()]
        _same(f["flat"][()], np.arange(5.0))
    _same(got[:50], want)
    assert (got[55] == 7).all() and not got[50:55].any()


def test_contiguous_write_and_append_cross_h5py(tmp_path):
    """A contiguous dataset is written when created; patching its rows in
    a later session moves it past the old end of the file, which h5py
    reads."""
    fn = str(tmp_path / "c.h5")
    with h5lite.File(fn, "w") as f:
        f.create_dataset("z", (6, 4), "f8")
        f["x"] = np.arange(12.0).reshape(3, 4)
        assert os.path.getsize(fn) > 12 * 8 + 6 * 4 * 8
    with h5lite.File(fn, "a") as f:
        f["x"][1, 1:3] = -1
        f["z"][5] = 2
    with h5py.File(fn, "r") as f:
        want = np.arange(12.0).reshape(3, 4)
        want[1, 1:3] = -1
        _same(f["x"][()], want)
        assert f["z"][5].tolist() == [2.0] * 4 and not f["z"][:5].any()


def test_another_writer_is_refused_at_the_next_write(tmp_path):
    fn = str(tmp_path / "x.h5")
    with h5lite.File(fn, "w") as f:
        f.create_dataset("c", (20, 3), "f8", chunks=(4, 3))
    first = h5lite.File(fn, "a")
    first["c"][0] = 1
    with h5lite.File(fn, "a") as second:
        second["c"][1] = 2
    with pytest.raises(OSError, match="changed on disk"):
        first["c"][2] = 3
    with pytest.raises(OSError, match="changed on disk"):
        first.close()
    with h5py.File(fn, "r") as f:
        assert f["c"][:3, 0].tolist() == [0.0, 2.0, 0.0]


class LowRank:
    """(pq|rs) = sum_r F[pq, r] F[rs, r] with F symmetric in p, q, served
    a column at a time, never as the M^4 tensor."""

    def __init__(self, nao, rank, seed=0):
        f = np.random.default_rng(seed).normal(size=(nao, nao, rank))
        self.f = (f + f.transpose(1, 0, 2)).reshape(nao * nao, rank)
        self.nao = nao

    def diagonal(self):
        return np.einsum("ir,ir->i", self.f, self.f)

    def column(self, j, l):
        return self.f @ self.f[j * self.nao + l]


def test_outcore_cholesky_memory_bound(tmp_path, monkeypatch):
    """With h5py hidden, the out-of-core Cholesky writes through h5lite:
    its traced peak stays below four chunks plus eight nao^2 vectors, and
    at least 8 times below the whole [cmax nao, nao^2] dataset (40 chunks
    here), on a new file, again into it (deleting the first dataset) and
    into a file h5py wrote with other datasets; its vectors equal JAX's
    h5py run to 1e-12 and h5py reads each result."""
    from pauxy_tpu.utils import from_pyscf as jfp
    from pauxy_tpu_torch.utils import from_pyscf as tfp

    nao, rank, cmax, rows = 32, 64, 10, 8
    prov = LowRank(nao, rank)
    chunk = rows * nao * nao * 8
    dataset = cmax * nao * nao * nao * 8
    jf = str(tmp_path / "jax.h5")
    nj = jfp.chunked_cholesky_outcore(prov, jf, max_error=1e-8, cmax=cmax,
                                      chunk_rows=rows)
    with h5py.File(jf, "r") as f:
        want = f["chol_outcore"][()]
    mine, theirs = str(tmp_path / "mine.h5"), str(tmp_path / "theirs.h5")
    with h5py.File(theirs, "w") as f:
        f["other"] = np.arange(5000.0)
        f.create_dataset("chunky", data=np.ones((50, 30)), chunks=(7, 30))
    monkeypatch.setitem(sys.modules, "h5py", None)
    peaks = []
    for fn in (mine, mine, theirs):
        tracemalloc.start()
        try:
            n = tfp.chunked_cholesky_outcore(prov, fn, max_error=1e-8,
                                             cmax=cmax, chunk_rows=rows)
            peaks.append(tracemalloc.get_traced_memory()[1])
        finally:
            tracemalloc.stop()
        assert n == nj == rank
    monkeypatch.undo()
    for peak in peaks:
        assert peak < 4 * chunk + 8 * nao * nao * 8, (peaks, chunk)
        assert 8 * peak <= dataset, (peaks, dataset)
    for fn in (mine, theirs):
        with h5py.File(fn, "r") as f:
            assert f["chol_outcore"].shape == (rank, nao * nao)
            np.testing.assert_allclose(f["chol_outcore"][()], want, rtol=0,
                                       atol=1e-12)
    with h5py.File(theirs, "r") as f:
        assert sorted(f.keys()) == ["chol_outcore", "chunky", "other"]
        _same(f["other"][()], np.arange(5000.0))
        _same(f["chunky"][()], np.ones((50, 30)))


def latest_gzip_values():
    """The values of ``tests/data/h5lite_latest_gzip.h5``."""
    ea = np.sin(np.arange(40 * 6)).reshape(40, 6)
    links = {f"n{i:02d}": np.arange(i, i + 3) for i in range(12)}
    return ea, links


def write_latest_gzip(path):
    """Write ``tests/data/h5lite_latest_gzip.h5`` (run once; the file is
    checked in): a deflated and shuffled float64 dataset with an
    extensible-array chunk index, and a group of 12 links in dense
    storage."""
    ea, links = latest_gzip_values()
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("ea", data=ea, chunks=(4, 6), maxshape=(None, 6),
                         compression="gzip", shuffle=True)
        for name, v in links.items():
            f[f"links/{name}"] = v


def test_checked_in_latest_gzip_file(tmp_path, monkeypatch):
    """The checked-in file reads in h5lite as in h5py, holds the values
    ``latest_gzip_values`` gives (chip_smoke.py holds h5lite's read to
    them on the card's machine, which has no h5py) and uses what it was
    written to cover."""
    ea, links = latest_gzip_values()
    assert os.path.getsize(LATEST_GZIP) < 16 * 1024
    seen = index_types(monkeypatch)
    dense = []
    monkeypatch.setattr(h5lite.hix, "dense_link_messages",
                        lambda *a, _f=h5lite.hix.dense_link_messages:
                        dense.append(a) or _f(*a))
    with h5py.File(LATEST_GZIP, "r") as fp, h5lite.File(LATEST_GZIP) as fl:
        _same(fl["ea"][()], fp["ea"][()])
        _same(fl["ea"][()], ea)
        assert fl["links"].keys() == list(fp["links"].keys()) == list(links)
        for name, v in links.items():
            _same(fl[f"links/{name}"][()], v)
        assert fp["ea"].compression == "gzip" and fp["ea"].shuffle
        assert fl["ea"].maxshape == (None, 6)
    assert seen == [4] and len(dense) == 1
    fresh = str(tmp_path / "fresh.h5")
    write_latest_gzip(fresh)
    with h5lite.File(fresh) as a, h5lite.File(LATEST_GZIP) as b:
        _same(a["ea"][()], b["ea"][()])
