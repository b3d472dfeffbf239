"""The port's loaders against the JAX package's, float64 on the CPU.

* ``utils/h5lite`` (the port's HDF5 reader and writer where h5py is
  missing): files crossed with h5py both ways, appends and deletions;
* QMCPACK integral files (dense real, dense complex, sparse factorised):
  the port reads what the JAX package writes and the reverse, through h5py
  and through h5lite, and both readers agree;
* ``modified_cholesky``; the FCIDUMP parsers (the port's native build, its
  Python oracle and JAX's ``read_fcidump``) agree exactly, real and
  complex; the malformed-body warning; ``PAUXY_TPU_NO_NATIVE``;
* ``fcidump_to_system`` and ``from_qmcpack_file`` against JAX's
  ``Generic`` at 1e-12;
* ``sgto``: integrals, RHF and UHF for H2-H4, and the AFQMC arrays;
* ``from_pyscf`` through a duck-typed mol (the shell provider, the
  generate_integrals path, freeze_core, the multi-determinant files);
* the k-point file round trip, ``kpoint_to_supercell`` and ``kpoint_eri``;
* wavefunction files (the simple layout and QMCPACK's NOMSD group).
"""

import importlib
import os

import h5py
import numpy as np
import pytest
import torch

from pauxy_tpu.models import generic as jgeneric
from pauxy_tpu.utils import from_pyscf as jfp
from pauxy_tpu.utils import hamiltonian_converter as jhc
from pauxy_tpu.utils import qmcpack as jq
from pauxy_tpu.utils import sgto as jsgto
from pauxy_tpu.utils import wavefunction as jwfn
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu_torch import native
from pauxy_tpu_torch.models import generic as tgeneric
from pauxy_tpu_torch.models.multi_slater import MultiSlaterTrial
from pauxy_tpu_torch.utils import from_pyscf as tfp
from pauxy_tpu_torch.utils import h5lite
from pauxy_tpu_torch.utils import hamiltonian_converter as thc
from pauxy_tpu_torch.utils import qmcpack as tq
from pauxy_tpu_torch.utils import sgto as tsgto
from pauxy_tpu_torch.utils import wavefunction as twfn

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")


@pytest.fixture(params=["h5py", "h5lite"])
def backend(request, monkeypatch):
    """The port's HDF5 access through h5py, or through h5lite as on a
    machine without h5py."""
    if request.param == "h5lite":
        monkeypatch.setattr(h5lite, "open_file", h5lite.File)
    return request.param


# ---------------------------------------------------------------------------
# h5lite
# ---------------------------------------------------------------------------

VALUES = {
    "a/b": np.arange(3.0), "c": np.array([1 + 2j, 3 - 4j]),
    "h": np.array([b"ab", b"cde"]), "i": np.int64(5), "f": 2.5,
    "big": np.random.default_rng(0).normal(size=(7, 5, 3)),
    "c64": (np.ones((4, 4)) + 1j).astype(np.complex64),
    "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
    "u8": np.arange(4, dtype=np.uint8), "empty": np.zeros((0, 3)),
    "f32": np.float32(1.5), "deep/x/y/z": np.ones(2),
}


def assert_values(get):
    for k, v in VALUES.items():
        got, want = np.asarray(get(k)), np.asarray(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_h5lite_reads_h5py_files(tmp_path, libver):
    fn = str(tmp_path / "p.h5")
    with h5py.File(fn, "w", libver=libver) as f:
        for j, (k, v) in enumerate(VALUES.items()):
            f[f"g{j % 3}/{k}"] = v
        f["s"] = "a variable-length string"
        # A group past one B-tree node (symbol table) or in dense link
        # storage (libver="latest", past 8 links).
        for i in range(300):
            f[f"many/{i:09d}"] = np.full(3, i + 0.5j)
        if libver == "earliest":
            # An object header past one chunk (attributes force a
            # continuation block).
            for j in range(20):
                f["many"].attrs[f"a{j}"] = np.arange(50)
    with h5lite.File(fn) as f:
        keys = f["many"].keys()
        assert keys == [f"{i:09d}" for i in range(300)]
        for k in keys[::37]:
            np.testing.assert_array_equal(f[f"many/{k}"][:],
                                          np.full(3, int(k) + 0.5j))
    with h5py.File(fn, "a") as f:
        del f["many"]
    with h5lite.File(fn) as f:
        assert_values(lambda k: next(f[f"g{j % 3}/{k}"][()]
                                     for j, kk in enumerate(VALUES)
                                     if kk == k))
        assert f["s"][()] == b"a variable-length string"
        assert f.keys() == ["g0", "g1", "g2", "s"]


def test_h5lite_files_read_by_h5py_and_appended(tmp_path):
    fn = str(tmp_path / "l.h5")
    with h5lite.File(fn, "w") as f:
        for k, v in VALUES.items():
            f[k] = v
        f["s"] = "text"
    with h5py.File(fn, "r") as f:
        assert_values(lambda k: f[k][()])
        assert f["s"][()] == b"text"
    for i in range(12):         # more than HDF5's default compact limit
        with h5lite.File(fn, "a") as f:
            f[f"blocks/{i:09d}"] = np.full(3, i + 0.5j)
    with h5py.File(fn, "a") as f:
        assert len(f["blocks"]) == 12
        f["blocks/by_h5py"] = np.arange(2)
    with h5lite.File(fn, "a") as f:
        np.testing.assert_array_equal(f["blocks/by_h5py"][:], np.arange(2))
        del f["big"]
        f["after"] = np.arange(4)
    with h5py.File(fn, "r") as f:
        assert "big" not in f and list(f["after"][:]) == [0, 1, 2, 3]
        np.testing.assert_array_equal(f["blocks/000000011"][:],
                                      np.full(3, 11 + 0.5j))
        assert_values(lambda k: f[k][()] if k != "big" else VALUES["big"])


# ---------------------------------------------------------------------------
# QMCPACK integral files
# ---------------------------------------------------------------------------

def ham_arrays(cplx, seed=1):
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=seed)
    if cplx:
        rng = np.random.default_rng(seed)
        chol = chol + 1e-2j * rng.normal(size=chol.shape)
        h1e = h1e + 0j
    return h1e, chol, enuc


def write_sparse(fn, h1e, chol, nelec, enuc, nblocks=3):
    """The QMCPACK sparse factorised layout (index_i / vals_i blocks of a
    CSR [M^2, X] matrix, complex values as trailing real pairs)."""
    m = h1e.shape[-1]
    flat = chol.reshape(m * m, -1).astype(np.complex128)
    rows, cols = np.nonzero(np.abs(flat) > 0)
    vals = flat[rows, cols]
    chunks = np.array_split(np.arange(len(vals)), nblocks)
    with h5py.File(fn, "w") as f:
        f["Hamiltonian/Energies"] = np.array([enuc, 0.0])
        f["Hamiltonian/hcore"] = np.stack([h1e.real, h1e.imag], -1)
        f["Hamiltonian/dims"] = np.array([0, 0, 0, m, nelec[0], nelec[1], 0,
                                          flat.shape[1]])
        f["Hamiltonian/Factorized/block_sizes"] = np.array(
            [len(c) for c in chunks])
        for i, c in enumerate(chunks):
            f[f"Hamiltonian/Factorized/index_{i}"] = np.stack(
                [rows[c], cols[c]], -1).ravel()
            f[f"Hamiltonian/Factorized/vals_{i}"] = np.stack(
                [vals[c].real, vals[c].imag], -1)


@pytest.mark.parametrize("cplx", [False, True])
def test_qmcpack_files_cross_between_packages(tmp_path, backend, cplx):
    h1e, chol, enuc = ham_arrays(cplx)
    jfn, tfn = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jq.write_hamiltonian(h1e, chol, (2, 2), ecore=enuc, filename=jfn)
    tq.write_hamiltonian(h1e, chol, (2, 2), ecore=enuc, filename=tfn)
    for fn in (jfn, tfn):
        for read in (jq.read_hamiltonian, tq.read_hamiltonian):
            h, c, e, nelec = read(fn)
            assert np.iscomplexobj(c) == cplx and nelec == (2, 2)
            np.testing.assert_array_equal(h, h1e)
            np.testing.assert_array_equal(c, chol)
            assert e == enuc


def test_qmcpack_sparse_layout(tmp_path, backend):
    h1e, chol, enuc = ham_arrays(True, seed=3)
    fn = str(tmp_path / "sparse.h5")
    write_sparse(fn, h1e, chol, (2, 2), enuc)
    jout, tout = jq.read_hamiltonian(fn), tq.read_hamiltonian(fn)
    for a, b in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tout[1], chol, atol=1e-15)
    assert tout[2:] == jout[2:] == (enuc, (2, 2))


def test_modified_cholesky_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, 9))
    mat = a @ a.T
    for tol in (1e-6, 1e-12):
        np.testing.assert_array_equal(tq.modified_cholesky(mat, tol=tol),
                                      jq.modified_cholesky(mat, tol=tol))
    chol = tq.modified_cholesky(mat, tol=1e-12)
    np.testing.assert_allclose(chol @ chol.T, mat, atol=1e-10)


def test_from_qmcpack_file_matches_jax(tmp_path, backend):
    h1e, chol, enuc = ham_arrays(False, seed=7)
    fn = str(tmp_path / "ham.h5")
    tq.write_hamiltonian(h1e, chol, (3, 2), ecore=enuc, filename=fn)
    jham = jgeneric.from_qmcpack_file(fn)
    tham = tgeneric.from_qmcpack_file(fn, **CPU)
    assert (tham.nup, tham.ndown, tham.ecore) == (3, 2, jham.ecore)
    for name in ("H1", "h1e_mod", "chol"):
        np.testing.assert_allclose(getattr(tham, name).numpy(),
                                   np.asarray(getattr(jham, name)),
                                   rtol=1e-12, atol=1e-12)
    assert tgeneric.from_qmcpack_file(fn, (2, 2), **CPU).nup == 2
    assert tgeneric.from_qmcpack_file(fn, dtype="single",
                                      device="cpu").chol.dtype \
        == torch.float32


# ---------------------------------------------------------------------------
# FCIDUMP
# ---------------------------------------------------------------------------

def write_fcidump(path, norb, nelec, entries, cplx):
    with open(path, "w") as f:
        f.write(f"&FCI NORB={norb},NELEC={nelec},MS2=0,\n")
        f.write("ORBSYM=" + "1," * norb + "\n&END\n")
        for v, i, j, k, l in entries:
            if cplx:
                f.write(f"({v.real:.16e}, {v.imag:.16e}) {i} {j} {k} {l}\n")
            else:
                f.write(f"{v:.16e} {i} {j} {k} {l}\n")


def fcidump_entries(norb, cplx, seed):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(1, norb + 1):
        for j in range(1, i + 1):
            v = rng.normal() + (1j * rng.normal() if cplx and i != j else 0)
            entries.append((v, i, j, 0, 0))
    for _ in range(4 * norb):
        i, j, k, l = rng.integers(1, norb + 1, size=4)
        entries.append((rng.normal() + 0j if cplx else rng.normal(),
                        int(i), int(j), int(k), int(l)))
    entries.append((0.7137 + 0j if cplx else 0.7137, 0, 0, 0, 0))
    return entries


@pytest.mark.parametrize("cplx", [False, True])
def test_fcidump_parsers_agree_exactly(tmp_path, monkeypatch, cplx):
    assert native.available(), native.load_error()
    path = str(tmp_path / "FCIDUMP")
    write_fcidump(path, 5, 6, fcidump_entries(5, cplx, 3), cplx)
    ref = jq.read_fcidump(path)
    calls = []
    fill = native.fcidump_fill
    monkeypatch.setattr(native, "fcidump_fill",
                        lambda *a: calls.append(1) or fill(*a))
    got = tq.read_fcidump(path)
    assert calls                    # the native parser ran
    monkeypatch.setattr(native, "fcidump_fill", lambda *a: None)
    oracle = tq.read_fcidump(path)
    for out in (got, oracle):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert out[2:] == ref[2:]
    assert np.iscomplexobj(got[0]) == cplx
    assert native.library_path().exists()


def test_fcidump_malformed_body_warns_and_falls_back(tmp_path):
    path = str(tmp_path / "FCIDUMP")
    with open(path, "w") as f:
        f.write("&FCI NORB=2,NELEC=2,MS2=0,\n&END\n"
                "0.5 1 1 1 1\nthis line is junk\n0.25 2 2 0 0\n")
    with pytest.warns(UserWarning, match="near byte"):
        h1e, eri, _, _, _ = tq.read_fcidump(path)
    assert eri[0, 0, 0, 0] == 0.5 and h1e[1, 1] == 0.25
    assert np.array_equal(h1e, jq.read_fcidump(path)[0])


def test_no_native_env_disables(monkeypatch):
    monkeypatch.setenv("PAUXY_TPU_NO_NATIVE", "1")
    mod = importlib.reload(native)
    try:
        assert not mod.available()
        assert "disabled" in mod.load_error()
        assert mod.fcidump_fill(b"", 1, False) is None
    finally:
        monkeypatch.delenv("PAUXY_TPU_NO_NATIVE")
        importlib.reload(native)


def test_fcidump_to_system_matches_jax(tmp_path, backend):
    """An FCIDUMP of a real 8-fold symmetric Hamiltonian -> Generic, and
    the fcidump-to-afqmc path (QMCPACK file) -> Generic."""
    h1e, chol, enuc, _ = generate_hamiltonian(4, (2, 2), seed=11)
    eri = np.einsum("ikx,jlx->ikjl", chol, chol)
    entries = [(eri[i, k, j, l], i + 1, k + 1, j + 1, l + 1)
               for i in range(4) for k in range(i + 1) for j in range(4)
               for l in range(j + 1) if i * 4 + k >= j * 4 + l]
    entries += [(h1e[i, j], i + 1, j + 1, 0, 0) for i in range(4)
                for j in range(i + 1)]
    entries.append((enuc, 0, 0, 0, 0))
    path = str(tmp_path / "FCIDUMP")
    write_fcidump(path, 4, 4, entries, False)
    jham = jq.fcidump_to_system(path, chol_tol=1e-12)
    tham = tq.fcidump_to_system(path, chol_tol=1e-12, **CPU)
    for name in ("H1", "h1e_mod", "chol"):
        np.testing.assert_allclose(getattr(tham, name).numpy(),
                                   np.asarray(getattr(jham, name)),
                                   rtol=1e-12, atol=1e-12)
    assert tham.ecore == jham.ecore and (tham.nup, tham.ndown) == (2, 2)


# ---------------------------------------------------------------------------
# sgto, from_pyscf, k-points, wavefunctions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_sgto_matches_jax(n):
    bas, charges, coords, enuc = tsgto.hydrogen_chain(n, 1.6)
    jbas = jsgto.hydrogen_chain(n, 1.6)[0]
    for a, b in zip(tsgto.build_integrals(bas, charges, coords),
                    jsgto.build_integrals(jbas, charges, coords)):
        np.testing.assert_array_equal(a, b)
    na = (n + 1) // 2
    assert tsgto.rhf(bas, charges, coords, na, enuc)[0] == \
        jsgto.rhf(jbas, charges, coords, na, enuc)[0]
    nelec = ((n + 1) // 2, n // 2)
    assert tsgto.uhf(bas, charges, coords, nelec, enuc)[0] == \
        jsgto.uhf(jbas, charges, coords, nelec, enuc)[0]
    tham, tpsi, te = tsgto.hydrogen_chain_afqmc(n, 1.6, **CPU)
    jham, jpsi, je = jsgto.hydrogen_chain_afqmc(n, 1.6)
    assert te == je
    np.testing.assert_array_equal(tpsi, jpsi)
    np.testing.assert_allclose(tham.chol.numpy(), np.asarray(jham.chol),
                               rtol=1e-12, atol=1e-12)


def test_sgto_dump_afqmc_files(tmp_path, backend):
    inp = tsgto.dump_afqmc(2, 1.4, prefix=str(tmp_path), nblocks=3)
    h1e, chol, enuc, nelec = jq.read_hamiltonian(str(tmp_path / "afqmc.h5"))
    jham, jpsi, _ = jsgto.hydrogen_chain_afqmc(2, 1.4)
    np.testing.assert_allclose(chol, np.asarray(jham.chol), atol=1e-12)
    psi, _ = jwfn.read_orbitals(str(tmp_path / "wfn.h5"))
    np.testing.assert_array_equal(psi, jpsi)
    assert os.path.exists(inp) and nelec == (1, 1)


class MockMol:
    """Duck-typed pyscf mol over a dense ERI: the shell surface the
    provider uses, and ``energy_nuc`` / ``nelec``."""

    def __init__(self, eri, sizes):
        self.eri, self.sizes = eri, list(sizes)
        self.offs = np.concatenate([[0], np.cumsum(self.sizes)])
        self.nelec = (2, 2)

    def nao_nr(self):
        return self.eri.shape[0]

    @property
    def nbas(self):
        return len(self.sizes)

    def bas_angular(self, i):
        return (self.sizes[i] - 1) // 2

    def bas_nctr(self, i):
        return 1

    def energy_nuc(self):
        return 1.5

    def intor(self, name, shls_slice=None):
        i0, i1, j0, j1, k0, k1, l0, l1 = shls_slice
        o = self.offs
        return np.ascontiguousarray(self.eri[o[i0]:o[i1], o[j0]:o[j1],
                                             o[k0]:o[k1], o[l0]:o[l1]])


def test_from_pyscf_with_duck_typed_mol(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    L = rng.normal(size=(6, 6, 12)) / 6
    L = 0.5 * (L + L.transpose(1, 0, 2))
    eri = np.einsum("pqx,rsx->pqrs", L, L)
    mol = MockMol(eri, [3, 1, 1, 1])
    for mod in (tfp, jfp):
        monkeypatch.setattr(mod, "HAVE_PYSCF", True)
    np.testing.assert_array_equal(tfp.chunked_cholesky(mol, 1e-10),
                                  jfp.chunked_cholesky(mol, 1e-10))
    np.testing.assert_array_equal(
        tfp.cholesky_from_eri(eri, 1e-10), jfp.cholesky_from_eri(eri, 1e-10))
    hcore = rng.normal(size=(6, 6))
    hcore = hcore + hcore.T
    x = tfp.get_ortho_ao(np.eye(6) + 0.1 * np.ones((6, 6)))
    np.testing.assert_array_equal(
        x, jfp.get_ortho_ao(np.eye(6) + 0.1 * np.ones((6, 6))))
    for cas in (None, (2, 4)):
        tout = tfp.generate_integrals(mol, hcore, x, 1e-10, cas=cas)
        jout = jfp.generate_integrals(mol, hcore, x, 1e-10, cas=cas)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tfp.gen_occ_lists(4, 2),
                                  jfp.gen_occ_lists(4, 2))
    n = str(tmp_path / "t.h5")
    tfp.chunked_cholesky_outcore(eri, n, max_error=1e-9, chunk_rows=3)
    with h5py.File(n, "r") as f:
        np.testing.assert_allclose(f["chol_outcore"][:],
                                   jfp.chunked_cholesky(eri, 1e-9),
                                   atol=1e-12)
    monkeypatch.setattr(tfp, "HAVE_PYSCF", False)
    with pytest.raises(ImportError, match="pyscf"):
        tfp.dump_pauxy(mol=mol)


class MockMC:
    def __init__(self, ncas, nelecas, ncore, ci):
        self.ncas, self.nelecas, self.ncore, self.ci = ncas, nelecas, \
            ncore, ci


def test_multi_det_files_and_write_wfn_mol(tmp_path, backend):
    rng = np.random.default_rng(2)
    ci = rng.normal(size=(6, 6))
    ci /= np.linalg.norm(ci)
    mc = MockMC(4, (2, 2), 1, ci)
    tf, jf = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    tfp.multi_det_wavefunction(mc, weight_cutoff=0.9, filename=tf)
    jfp.multi_det_wavefunction(mc, weight_cutoff=0.9, filename=jf)
    with open(tf) as a, open(jf) as b:
        assert a.read() == b.read()
    for x, y in zip(tfp.read_multi_det_file(tf), jfp.read_multi_det_file(jf)):
        np.testing.assert_array_equal(x, y)
    c = np.linalg.qr(rng.normal(size=(5, 5)))[0]
    scf = {"mo_coeff": c, "X": np.eye(5), "nelec": (2, 1), "isUHF": False}
    wfn = str(tmp_path / "wfn.h5")
    assert tfp.write_wfn_mol(scf, True, wfn) == (2, 1)
    jpsi, jc = jwfn.read_orbitals(wfn)
    tpsi, tc = twfn.read_orbitals(wfn)
    np.testing.assert_array_equal(tpsi, jpsi)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tpsi[0, :, :2], c[:, :2], atol=1e-14)


def test_kpoint_round_trip_and_supercell(tmp_path, backend):
    rng = np.random.default_rng(5)
    nkp, nmo, nchol = 3, 2, 4
    nmo_pk = np.full(nkp, nmo, dtype=np.int32)
    nchol_pk = np.full(nkp, nchol, dtype=np.int32)
    qk_k2 = np.array([[(k - q) % nkp for k in range(nkp)]
                      for q in range(nkp)], dtype=np.int32)
    minus_k = np.array([(-q) % nkp for q in range(nkp)], dtype=np.int32)
    hcore = []
    for _ in range(nkp):
        h = rng.normal(size=(nmo, nmo)) + 1j * rng.normal(size=(nmo, nmo))
        hcore.append(0.5 * (h + h.conj().T))
    chol = []
    for q in range(nkp):
        if minus_k[q] < q:
            chol.append([c.conj() for c in chol[minus_k[q]]])
            continue
        im = 0.0 if minus_k[q] == q else 1.0
        chol.append([rng.normal(size=(nmo * nmo, nchol))
                     + im * 1j * rng.normal(size=(nmo * nmo, nchol))
                     for _ in range(nkp)])
    tfn, jfn = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    args = dict(enuc=1.25, nelec=(3, 3), nmo_pk=nmo_pk, qk_k2=qk_k2,
                minus_k=minus_k, nchol_pk=nchol_pk)
    thc.write_qmcpack_cholesky_kpoint(tfn, hcore, chol, **args)
    jhc.write_qmcpack_cholesky_kpoint(jfn, hcore, chol, **args)
    for fn in (tfn, jfn):
        t, j = thc.read_qmcpack_cholesky_kpoint(fn), \
            jhc.read_qmcpack_cholesky_kpoint(tfn)
        for a, b in zip(t[0], j[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t[1], j[1]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert t[2:5] == j[2:5]
        for a, b in zip(t[5:], j[5:]):
            np.testing.assert_array_equal(a, b)
        for q in range(nkp):
            want = np.stack([np.asarray(c).reshape(-1) for c in chol[q]])
            np.testing.assert_array_equal(
                np.asarray(t[1][q]).reshape(want.shape), want)
    h, c = thc.kpoint_to_supercell(hcore, chol, nmo_pk, qk_k2, nchol_pk)
    jh, jc = jhc.kpoint_to_supercell(hcore, chol, nmo_pk, qk_k2, nchol_pk)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(
        thc.kpoint_eri(chol, nmo_pk, qk_k2, nchol_pk),
        jhc.kpoint_eri(chol, nmo_pk, qk_k2, nchol_pk))


def test_wavefunction_files(tmp_path, backend):
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=4)
    tham = tgeneric.make_generic((2, 2), h1e, chol, enuc, **CPU)
    rng = np.random.default_rng(8)
    psi = np.linalg.qr(rng.normal(size=(6, 6)) + 0j)[0][:, :4]
    for writer in (twfn.write_wavefunction, jwfn.write_wavefunction):
        fn = str(tmp_path / f"{writer.__module__}.h5")
        writer(psi, fn)
        for reader in (twfn.read_orbitals, jwfn.read_orbitals):
            got, coeffs = reader(fn)
            np.testing.assert_array_equal(got, psi)
            assert coeffs is None
        trial = twfn.read_wavefunction(tham, fn, **CPU)
        np.testing.assert_array_equal(trial.psia.numpy(), psi[:, :2])
        assert trial.name == "file"
    dets = np.stack([psi, np.linalg.qr(rng.normal(size=(6, 4)) + 0j)[0]])
    coeffs = np.array([0.8, 0.6 + 0.1j])
    for writer in (twfn.write_qmcpack_wfn, jwfn.write_qmcpack_wfn):
        fn = str(tmp_path / f"nomsd_{writer.__module__}.h5")
        writer(fn, coeffs, dets, (2, 2))
        for reader in (twfn.read_orbitals, jwfn.read_orbitals):
            got, c = reader(fn)
            np.testing.assert_array_equal(got, dets)
            np.testing.assert_array_equal(c, coeffs)
        trial = twfn.read_wavefunction(tham, fn, **CPU)
        assert isinstance(trial, MultiSlaterTrial)


def test_h5lite_refuses_a_file_changed_while_open(tmp_path):
    fn = str(tmp_path / "x.h5")
    with h5lite.File(fn, "w") as f:
        f["a"] = np.arange(3)
    first = h5lite.File(fn, "a")
    first["b"] = np.arange(2)
    with h5lite.File(fn, "a") as second:
        second["c"] = np.arange(4)
    with pytest.raises(OSError, match="changed on disk"):
        first.close()
    with h5py.File(fn, "r") as f:
        assert sorted(f.keys()) == ["a", "c"]
