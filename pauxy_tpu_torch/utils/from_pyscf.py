"""pyscf integration: dump molecular integrals + trial wavefunctions.

The port's copy of ``pauxy_tpu/utils/from_pyscf.py`` (numpy on the host;
HDF5 through ``utils.h5lite.open_file``, the out-of-core Cholesky's
resizable chunked dataset too). Counterpart of
``pauxy/utils/from_pyscf.py:22-651`` (dump_pauxy,
generate_integrals, chunked Cholesky, frozen core, ortho-AO) and
``tools/pyscf/pyscf_to_pauxy.py``. pyscf is an optional dependency — every
entry point degrades with a clear error when it is absent; the numpy
parts (the Cholesky providers, :func:`cholesky_from_eri`) run without it.
"""

from __future__ import annotations

import numpy as np

try:
    from pyscf import ao2mo, lib, scf  # noqa: F401

    HAVE_PYSCF = True
except ImportError:
    HAVE_PYSCF = False


def _require_pyscf():
    if not HAVE_PYSCF:
        raise ImportError(
            "pyscf is not installed in this environment; generate a QMCPACK "
            "integral file elsewhere (utils/qmcpack.write_hamiltonian) or "
            "use an FCIDUMP (utils/qmcpack.fcidump_to_system)."
        )


def cholesky_from_eri(eri: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Pivoted Cholesky of a dense (pq|rs) ERI tensor -> L[p, q, x].

    Pure numpy; the molecular analogue of the reference's chunked AO
    Cholesky (``from_pyscf.py:286-394``) for the incore case.
    """
    from pauxy_tpu_torch.utils.qmcpack import modified_cholesky

    m = eri.shape[0]
    chol = modified_cholesky(eri.reshape(m * m, m * m), tol=tol)
    return chol.reshape(m, m, -1)


# ---------------------------------------------------------------------------
# ERI column providers: the pivoted Cholesky below never materializes the
# M^4 ERI tensor — it only needs the diagonal (uv|uv) and single columns
# (uv|jl). The provider abstraction decouples the algorithm from pyscf
# (DenseERIProvider makes it testable without pyscf).
# ---------------------------------------------------------------------------


class DenseERIProvider:
    """Column provider backed by an in-memory (pq|rs) tensor (tests)."""

    def __init__(self, eri: np.ndarray):
        self.eri = np.asarray(eri)
        self.nao = self.eri.shape[0]

    def diagonal(self) -> np.ndarray:
        m = self.nao
        return self.eri.reshape(m * m, m * m).diagonal().copy()

    def column(self, j: int, l: int) -> np.ndarray:
        return self.eri[:, :, j, l].reshape(-1).astype(float)


class PyscfShellProvider:
    """Column provider evaluating AO integrals shell-block-wise via
    ``mol.intor('int2e_sph', shls_slice=...)`` — the reference's access
    pattern (``from_pyscf.py:286-394``) behind the provider interface.
    Nothing larger than one [nao, nao, di, dl] shell block is ever built.
    """

    def __init__(self, mol):
        self.mol = mol
        self.nao = mol.nao_nr()
        # Cumulative AO offset of each shell (ao index -> shell lookup).
        dims = [0]
        for i in range(mol.nbas):
            ll = mol.bas_angular(i)
            nc = mol.bas_nctr(i)
            dims.append(dims[-1] + (2 * ll + 1) * nc)
        self.dims = np.asarray(dims)

    def _shell_of(self, ao: int) -> int:
        return int(np.searchsorted(self.dims, ao, side="right") - 1)

    def diagonal(self) -> np.ndarray:
        nao = self.nao
        diag = np.zeros(nao * nao)
        off = 0
        for i in range(self.mol.nbas):
            shls = (i, i + 1, 0, self.mol.nbas, i, i + 1, 0, self.mol.nbas)
            buf = self.mol.intor("int2e_sph", shls_slice=shls)
            di = buf.shape[0]
            diag[off : off + di * nao] = buf.reshape(
                di * nao, di * nao
            ).diagonal()
            off += di * nao
        return diag

    def column(self, j: int, l: int) -> np.ndarray:
        sj, sl = self._shell_of(j), self._shell_of(l)
        shls = (0, self.mol.nbas, 0, self.mol.nbas, sj, sj + 1, sl, sl + 1)
        buf = self.mol.intor("int2e_sph", shls_slice=shls)
        cj = j - int(self.dims[sj])
        cl = l - int(self.dims[sl])
        return buf[:, :, cj, cl].reshape(-1)


def _as_provider(source):
    if hasattr(source, "column") and hasattr(source, "diagonal"):
        return source
    if hasattr(source, "intor"):
        return PyscfShellProvider(source)
    return DenseERIProvider(np.asarray(source))


def chunked_cholesky(source, max_error: float = 1e-6, verbose: bool = False,
                     cmax: int = 10) -> np.ndarray:
    """Pivoted Cholesky of the ERI supermatrix from on-demand columns.

    ``source`` is a pyscf ``mol``, a dense (pq|rs) tensor, or any provider
    with ``diagonal()``/``column(j, l)``. Never forms the M^4 tensor:
    per iteration it fetches one (uv|jl) column at the current pivot and
    subtracts the projection onto the vectors found so far. Counterpart of
    the reference's ``chunked_cholesky`` (``from_pyscf.py:286-394``).

    Returns ``chol [nchol, nao*nao]`` (AO basis, same layout as the
    reference so downstream ``ao2mo_chol``/``freeze_core`` carry over).
    """
    prov = _as_provider(source)
    nao = prov.nao
    nchol_max = cmax * nao
    diag = prov.diagonal().astype(float).copy()
    chol = np.zeros((nchol_max, nao * nao))
    resid = diag.copy()           # D_ii = M_ii - sum_x L_i^x L_i^x
    nchol = 0
    while nchol < nchol_max:
        nu = int(np.argmax(np.abs(resid)))
        delta_max = abs(resid[nu])
        if delta_max <= max_error:
            break
        col = prov.column(nu // nao, nu % nao).astype(float)
        # Projection onto existing vectors: R = L[:, nu]^T L.
        if nchol:
            col -= chol[:nchol, nu] @ chol[:nchol]
        v = col / np.sqrt(delta_max)
        chol[nchol] = v
        resid -= v * v
        resid = np.maximum(resid, 0.0)
        nchol += 1
        if verbose:
            print(f"# chunked_cholesky iteration {nchol:5d}: "
                  f"delta_max = {delta_max:13.8e}")
    return chol[:nchol]


def chunked_cholesky_outcore(source, filename: str, max_error: float = 1e-6,
                             verbose: bool = False, cmax: int = 10,
                             chunk_rows: int = 256) -> int:
    """Out-of-core variant (``from_pyscf.py:395-550``): the Cholesky
    vectors live in an HDF5 dataset ``chol_outcore [nchol_max, nao^2]``;
    host memory stays O(chunk_rows * nao^2). The projection at the pivot
    streams the stored vectors in row chunks.

    Returns the number of vectors written (the dataset is resized to
    [nchol, nao*nao] on exit; read it back with ``h5lite.open_file``).
    The file goes through ``utils.h5lite.open_file``: h5py where it
    imports, else the port's own writer, which writes each row to its
    chunk in the file as it comes and reads back only the chunks a block
    touches, so that host memory stays a few chunks there too.
    """
    from pauxy_tpu_torch.utils import h5lite

    prov = _as_provider(source)
    nao = prov.nao
    nchol_max = cmax * nao
    diag = prov.diagonal().astype(float).copy()
    resid = diag.copy()
    nchol = 0
    with h5lite.open_file(filename, "a") as fh5:
        if "chol_outcore" in fh5:
            del fh5["chol_outcore"]
        dset = fh5.create_dataset(
            "chol_outcore", (nchol_max, nao * nao), dtype="f8",
            chunks=(min(chunk_rows, nchol_max), nao * nao),
        )
        while nchol < nchol_max:
            nu = int(np.argmax(np.abs(resid)))
            delta_max = abs(resid[nu])
            if delta_max <= max_error:
                break
            col = prov.column(nu // nao, nu % nao).astype(float)
            for s in range(0, nchol, chunk_rows):
                e = min(s + chunk_rows, nchol)
                block = dset[s:e]
                col -= block[:, nu] @ block
            v = col / np.sqrt(delta_max)
            dset[nchol] = v
            resid -= v * v
            resid = np.maximum(resid, 0.0)
            nchol += 1
            if verbose:
                print(f"# chunked_cholesky_outcore iteration {nchol:5d}: "
                      f"delta_max = {delta_max:13.8e}")
        dset.resize((nchol, nao * nao))
    return nchol


def ao2mo_chol(chol: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Rotate AO-basis Cholesky vectors [nchol, nao^2] into the (ortho-AO
    or MO) basis C [nao, m] -> [nchol, m^2] (``from_pyscf.py:224-230``)."""
    nao = C.shape[0]
    m = C.shape[1]
    out = np.empty((chol.shape[0], m * m), dtype=np.result_type(chol, C))
    for i, cv in enumerate(chol):
        half = cv.reshape(nao, nao) @ C
        out[i] = (C.conj().T @ half).ravel()
    return out


def generate_integrals(mol, hcore, X, chol_cut: float = 1e-5,
                       verbose: bool = False, cas=None):
    """Basis-rotated h1e + Cholesky vectors from a pyscf molecule without
    ever materializing the dense ERI (``from_pyscf.py:154-193``):
    shell-block pivoted Cholesky in the AO basis, then a per-vector
    rotation into X. ``cas=(nelec_active, ncas)`` freezes the core.

    Returns (h1e [m, m], chol [m, m, nchol], nelec, ecore).
    """
    _require_pyscf()
    h1e = X.conj().T @ hcore @ X
    chol_ao = chunked_cholesky(mol, max_error=chol_cut, verbose=verbose)
    chol_flat = ao2mo_chol(chol_ao, X)
    m = h1e.shape[-1]
    chol = np.moveaxis(chol_flat.reshape(-1, m, m), 0, -1)  # [m, m, X]
    enuc = float(mol.energy_nuc())
    nelec = tuple(mol.nelec)
    if cas is not None:
        nfzc = (sum(nelec) - cas[0]) // 2
        ncas = cas[1]
        h1_act, chol, enuc = freeze_core(h1e, chol, enuc, nfzc, ncas,
                                         verbose=verbose)
        h1e = h1_act[0]
        nelec = (nelec[0] - nfzc, nelec[1] - nfzc)
    return h1e, chol, nelec, enuc


def dump_pauxy(
    chkfile: str | None = None,
    mol=None,
    mf=None,
    outfile: str = "afqmc.h5",
    chol_cut: float = 1e-5,
    ortho_ao: bool = False,
    wfn_file: str = "wfn.h5",
):
    """chkfile / SCF object -> QMCPACK integral file + trial wavefunction
    (``from_pyscf.py:22-152`` + ``tools/pyscf/pyscf_to_pauxy.py``)."""
    _require_pyscf()
    from pauxy_tpu_torch.utils import qmcpack, wavefunction

    if mf is None:
        assert chkfile is not None
        mol = lib.chkfile.load_mol(chkfile)
        mf = scf.RHF(mol)
        mf.__dict__.update(lib.chkfile.load(chkfile, "scf"))
    mol = mf.mol
    hcore = mf.get_hcore()
    if ortho_ao:
        s = mf.get_ovlp()
        x = get_ortho_ao(s)
    else:
        x = np.asarray(mf.mo_coeff)
    h1e, chol, nelec, ecore = generate_integrals(
        mol, hcore, x, chol_cut=chol_cut
    )
    qmcpack.write_hamiltonian(
        h1e, chol, nelec, ecore=ecore, filename=outfile
    )
    # RHF trial in the basis used for the integrals.
    nmo = h1e.shape[-1]
    psi = np.eye(nmo)[:, : nelec[0] + nelec[1]]
    if ortho_ao:
        c = np.linalg.inv(x) @ np.asarray(mf.mo_coeff)
        psi = np.hstack([c[:, : nelec[0]], c[:, : nelec[1]]])
    wavefunction.write_wavefunction(psi, wfn_file)
    return outfile, wfn_file


def get_ortho_ao(s: np.ndarray, lindep: float = 0.0) -> np.ndarray:
    """Symmetric (Loewdin) orthogonalization X = S^{-1/2}
    (``from_pyscf.py:632-651``). Pure numpy."""
    sdiag, u = np.linalg.eigh(s)
    keep = sdiag > lindep
    return (u[:, keep] / np.sqrt(sdiag[keep])) @ u[:, keep].conj().T


def core_contribution_cholesky(chol, g):
    """Per-spin core Fock contributions hc_s = J(G_s) - K(G_s)/2 from the
    Cholesky factors (``pauxy/estimators/generic.py:443-456``).

    chol: [M, M, X]; g: [2, M, M] core density matrices.
    """
    out = []
    for gs in np.asarray(g):
        x = np.einsum("pqx,pq->x", chol, gs, optimize=True)
        j = np.einsum("pqx,x->pq", chol, x, optimize=True)
        t = np.einsum("pqx,pm->qmx", chol, gs, optimize=True)
        k = np.einsum("qmx,qnx->mn", t, chol, optimize=True)
        out.append(j - 0.5 * k)
    return out[0], out[1]


def freeze_core(h1e, chol, ecore, nc: int, ncas: int, verbose: bool = False):
    """Fold ``nc`` doubly-occupied core orbitals into the one-body part and
    the core energy, keeping an ``ncas``-orbital active space
    (``pauxy/utils/from_pyscf.py:195-220``).

    h1e [M, M] (spin-restricted), chol [M, M, X].
    Returns (h1e_active [2, ncas, ncas], chol_active [ncas, ncas, X],
    ecore_frozen).
    """
    h1e = np.asarray(h1e)
    chol = np.asarray(chol)
    m = h1e.shape[-1]
    gcore = np.zeros((m, m))
    gcore[np.arange(nc), np.arange(nc)] = 1.0
    hc_a, hc_b = core_contribution_cholesky(chol, [gcore, gcore])
    # Core energy: 2 sum_c h_cc + sum_cc' [2 (cc|c'c') - (cc'|c'c)].
    e1 = 2.0 * np.trace(h1e[:nc, :nc])
    e2 = float(np.sum(gcore * (hc_a + hc_b)))
    ecore_frozen = ecore + e1 + e2
    h1_act = np.stack([h1e + 2 * hc_a, h1e + 2 * hc_b])[
        :, nc : nc + ncas, nc : nc + ncas
    ]
    chol_act = chol[nc : nc + ncas, nc : nc + ncas, :]
    if verbose:
        print(f" # Number of active orbitals: {ncas}")
        print(f" # Freezing {2 * nc} core electrons and "
              f"{m - nc - ncas} virtuals.")
        print(f" # Frozen core energy : {ecore_frozen:13.8e}")
    return h1_act, chol_act, float(ecore_frozen)


# ---------------------------------------------------------------------------
# CASSCF multi-determinant export + trial wavefunction writers
# (``from_pyscf.py:67-123`` write_wfn_mol, ``:552-610``
# multi_det_wavefunction). Implemented against duck-typed pyscf objects so
# the logic is testable without pyscf installed.
# ---------------------------------------------------------------------------


def gen_occ_lists(norb: int, nelec: int) -> np.ndarray:
    """Occupation lists of ``nelec`` electrons in ``norb`` orbitals in
    pyscf ``fci.cistring`` order: determinant bit-strings ascending as
    integers (bit i = orbital i), i.e. combinations in colexicographic
    order. E.g. norb=4, nelec=2 -> (0,1),(0,2),(1,2),(0,3),(1,3),(2,3)."""
    import itertools

    combs = sorted(itertools.combinations(range(norb), nelec),
                   key=lambda c: c[::-1])
    return np.asarray(combs, dtype=int).reshape(len(combs), nelec)


def multi_det_wavefunction(mc, weight_cutoff: float = 0.95,
                           verbose: bool = False, max_ndets: int = 100000,
                           norb: int | None = None,
                           filename: str = "multi_det.dat"):
    """Export a CASSCF/CASCI expansion as a QMCPACK-compatible
    particle-hole (occ-list) wavefunction file (``from_pyscf.py:552-610``).

    ``mc`` needs ``ci`` (CI coefficient array), ``ncas``, ``nelecas``,
    ``ncore`` — the pyscf CASSCF/CASCI attribute surface. Determinants are
    emitted by decreasing |coefficient| until the accumulated weight
    reaches ``weight_cutoff``. Orbital indices are 1-based; the down-spin
    block is shifted by ``norb`` (QMCPACK PHMSD convention).
    """
    occlists = gen_occ_lists(mc.ncas, mc.nelecas[0])
    occlists_b = gen_occ_lists(mc.ncas, mc.nelecas[1])
    ci = np.asarray(mc.ci).ravel()
    ix_sort = np.argsort(np.abs(ci))[::-1]
    # |c|^2 weights (ci**2 would make the cumsum complex for complex CI
    # coefficients and the searchsorted truncation point arbitrary).
    cweight = np.cumsum(np.abs(ci[ix_sort]) ** 2)
    max_det = int(min(np.searchsorted(cweight, weight_cutoff) + 1,
                      max_ndets, len(ci)))
    coeffs = ci[ix_sort]
    if verbose:
        print(f"# Number of dets in CAS space: "
              f"{len(occlists) * len(occlists_b)}")
        print(f"# Number of dets in CI expansion: {max_det}")
    if norb is None:
        norb = mc.ncas + mc.ncore
    nb = len(occlists_b)
    with open(filename, "w") as out:
        # NORB makes the up/down split exact on re-read; the reference
        # format omits it, so read_multi_det_file treats it as optional.
        out.write(f"&FCI\n UHF = 0\n NCI = {max_det}\n NORB = {norb}\n"
                  " TYPE = occ\n&END\n")
        out.write("Configurations:\n")
        core_up = " ".join(str(x + 1) for x in range(mc.ncore))
        core_dn = " ".join(str(x + 1 + norb) for x in range(mc.ncore))
        for idet in range(max_det):
            ia = occlists[ix_sort[idet] // nb]
            ib = occlists_b[ix_sort[idet] % nb]
            oup = " ".join(str(x + 1 + mc.ncore) for x in ia)
            odn = " ".join(str(x + norb + 1 + mc.ncore) for x in ib)
            out.write(f"{coeffs[idet]:.13f} {core_up} {oup} "
                      f"{core_dn} {odn}\n")
    return filename


def read_multi_det_file(filename: str, norb: int | None = None):
    """Parse an occ-list wavefunction file written by
    :func:`multi_det_wavefunction` (or the reference / QMCPACK tooling).

    Returns ``(coeffs [D], occa [D, na], occb [D, nb])`` with 0-based
    orbital indices (the down block un-shifted) — the direct input of
    ``models.multi_slater.phmsd_trial``.

    The up/down split needs ``norb`` (down indices live in
    ``[norb, 2 norb)``): taken from the explicit argument, else the NORB
    header key our writer emits, else inferred as ``(max_index+1)//2`` —
    the inference is ambiguous when the top orbitals are unoccupied in
    every kept determinant, so files from other tools should pass
    ``norb``.
    """
    with open(filename) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    nci = None
    start = None
    for i, ln in enumerate(lines):
        up = ln.upper().replace(" ", "")
        if up.startswith("NCI"):
            nci = int(ln.split("=")[1])
        if up.startswith("NORB") and norb is None:
            norb = int(ln.split("=")[1])
        if ln.lower().startswith("configurations"):
            start = i + 1
            break
    if start is None:
        raise ValueError(f"no 'Configurations:' section in {filename!r}")
    rows = lines[start : start + (nci or len(lines))]
    coeffs, occ_all = [], []
    for ln in rows:
        parts = ln.split()
        coeffs.append(float(parts[0]))
        occ_all.append([int(x) - 1 for x in parts[1:]])
    occ = np.asarray(occ_all, dtype=int)
    ne = occ.shape[1]
    if norb is None:
        norb = (occ.max() + 1) // 2 if occ.max() >= ne else ne
    # Down indices are >= norb in every determinant; all rows share (na, nb).
    na_per_row = (occ < norb).sum(axis=1)
    na = int(na_per_row[0])
    if not (na_per_row == na).all():
        raise ValueError(
            f"inconsistent up/down occupation split in {filename!r} "
            f"(norb={norb}); pass the correct norb"
        )
    occa = occ[:, :na]
    occb = occ[:, na:] - norb
    if (occb < 0).any() or (occa >= norb).any():
        raise ValueError(
            f"could not split up/down occupations in {filename!r} "
            f"(norb={norb}); pass the correct norb"
        )
    return np.asarray(coeffs), occa, occb


def write_wfn_mol(scf_data: dict, ortho_ao: bool, filename: str,
                  wfn=None, mode: str = "w"):
    """Write the molecular trial wavefunction from SCF data
    (``from_pyscf.py:67-123``): RHF/UHF orbitals, rotated by X^-1 when
    working in the ortho-AO basis, as a single-determinant NOMSD.

    ``scf_data`` needs ``mo_coeff``, ``X``, ``isUHF`` and ``nelec``
    (pyscf's mol.nelec, or an explicit (na, nb) tuple). Returns nelec.
    """
    from pauxy_tpu_torch.utils import wavefunction

    nelec = scf_data.get("nelec")
    if nelec is None:
        nelec = scf_data["mol"].nelec
    na, nb = nelec
    C = np.asarray(scf_data["mo_coeff"])
    X = np.asarray(scf_data["X"])
    uhf = bool(scf_data.get("isUHF", C.ndim == 3))
    norb = C[0].shape[0] if uhf else C.shape[0]
    if wfn is None:
        wfn = np.zeros((1, norb, na + nb), dtype=np.complex128)
        if ortho_ao:
            xinv = np.linalg.inv(X)
            if uhf:
                wfn[0, :, :na] = (xinv @ C[0])[:, :na]
                wfn[0, :, na:] = (xinv @ C[1])[:, :nb]
            else:
                wfn[0, :, :na] = (xinv @ C)[:, :na]
                wfn[0, :, na:] = (xinv @ C)[:, :nb]
        else:
            if uhf:
                raise ValueError(
                    "UHF trial export requires ortho_ao=True (the MO basis "
                    "differs per spin; reference from_pyscf.py:117-120)"
                )
            eye = np.eye(norb)
            wfn[0, :, :na] = eye[:, :na]
            wfn[0, :, na:] = eye[:, :nb]
    wavefunction.write_qmcpack_wfn(
        filename, np.array([1.0 + 0j]), wfn, (na, nb), mode=mode
    )
    return (na, nb)


def load_from_pyscf_chkfile(chkfile: str, base: str = "scf") -> dict:
    """Extract mol/hcore/X/mo_coeff from a pyscf checkpoint file
    (``from_pyscf.py:232-251``)."""
    _require_pyscf()
    from pauxy_tpu_torch.utils import h5lite

    mol = lib.chkfile.load_mol(chkfile)
    with h5lite.open_file(chkfile, "r") as fh5:
        if "/scf/hcore" in fh5:
            hcore = fh5["/scf/hcore"][:]
        else:
            hcore = mol.intor_symmetric("int1e_nuc")
            hcore = hcore + mol.intor_symmetric("int1e_kin")
        if "/scf/orthoAORot" in fh5:
            X = fh5["/scf/orthoAORot"][:]
        else:
            X = get_ortho_ao(mol.intor("int1e_ovlp_sph"))
    mo_occ = np.array(lib.chkfile.load(chkfile, base + "/mo_occ"))
    mo_coeff = np.array(lib.chkfile.load(chkfile, base + "/mo_coeff"))
    return {
        "mol": mol,
        "mo_occ": mo_occ,
        "hcore": hcore,
        "X": X,
        "mo_coeff": mo_coeff,
        "isUHF": mo_coeff.ndim == 3,
        "nelec": tuple(mol.nelec),
    }
