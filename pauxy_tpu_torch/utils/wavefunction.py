"""Trial wavefunction file I/O.

Counterpart of ``pauxy_tpu/utils/wavefunction.py`` (HDF5 through
``utils.h5lite.open_file``); ``read_wavefunction`` builds the port's trial.

Reads either this package's own simple layout (datasets ``psi`` (+optional
``coeffs``)) or the QMCPACK NOMSD HDF5 group the reference writes
(``pauxy/utils/io.py:325-460``).
"""

from __future__ import annotations

import numpy as np

from pauxy_tpu_torch.utils import h5lite


def read_orbitals(filename: str):
    """Return (psi [ndet, M, na+nb] or [M, na+nb], coeffs or None)."""
    with h5lite.open_file(filename, "r") as fh5:
        if "psi" in fh5:
            psi = fh5["psi"][:]
            coeffs = fh5["coeffs"][:] if "coeffs" in fh5 else None
            return psi, coeffs
        if "Wavefunction" in fh5:
            # Reference NOMSD layout (io.py:407-460): PsiT_{i}/<spin parts>.
            grp = fh5["Wavefunction/NOMSD"]
            coeffs = grp["ci_coeffs"][:].view(np.complex128).ravel()
            psis = []
            dets = sorted(
                (k for k in grp.keys() if k.startswith("PsiT_")),
                key=lambda k: int(k.split("_")[1]),
            )
            for k in dets:
                sub = grp[k]
                mats = []
                for part in sorted(sub.keys()):
                    data = sub[part][:]
                    if data.ndim == 3 and data.shape[-1] == 2:
                        data = data.view(np.complex128)[..., 0]
                    mats.append(data)
                psis.append(np.concatenate(mats, axis=1))
            return np.array(psis), coeffs
    raise ValueError(f"unrecognized wavefunction file {filename!r}")


def read_wavefunction(ham, filename: str, *, device=None, dtype=None):
    """The port's trial from a wavefunction file: one determinant gives a
    ``SingleDetTrial``, several a multi-Slater (NOMSD) trial."""
    from pauxy_tpu_torch.models.trial import trial_from_orbitals

    psi, coeffs = read_orbitals(filename)
    if psi.ndim == 3:
        if psi.shape[0] > 1:
            from pauxy_tpu_torch.models.multi_slater import multi_slater_trial

            return multi_slater_trial(ham, psi, coeffs, device=device,
                                      dtype=dtype)
        psi = psi[0]
    return trial_from_orbitals(ham, psi, name="file", device=device,
                               dtype=dtype)


def write_wavefunction(psi: np.ndarray, filename: str, coeffs=None):
    with h5lite.open_file(filename, "w") as fh5:
        fh5["psi"] = np.asarray(psi)
        if coeffs is not None:
            fh5["coeffs"] = np.asarray(coeffs)


def write_qmcpack_wfn(filename: str, coeffs: np.ndarray, wfn: np.ndarray,
                      nelec, mode: str = "w"):
    """Write a NOMSD trial in the QMCPACK HDF5 group layout this module's
    :func:`read_orbitals` parses (counterpart of the reference's
    ``write_qmcpack_wfn``, ``pauxy/utils/io.py:407-460``; determinant
    blocks are stored dense rather than CSR — a deliberate simplification,
    the reader accepts both shapes).

    coeffs [D] complex; wfn [D, M, na+nb]; nelec (na, nb).
    """
    na, nb = nelec
    coeffs = np.asarray(coeffs, dtype=np.complex128)
    wfn = np.asarray(wfn, dtype=np.complex128)

    def ri(x):
        return np.stack([x.real, x.imag], axis=-1)

    with h5lite.open_file(filename, mode) as fh5:
        if "Wavefunction" in fh5:
            del fh5["Wavefunction"]
        grp = fh5.create_group("Wavefunction/NOMSD")
        grp["ci_coeffs"] = ri(coeffs)
        grp["dims"] = np.array([wfn.shape[1], na, nb, len(coeffs)])
        for i, det in enumerate(wfn):
            sub = grp.create_group(f"PsiT_{i}")
            sub["alpha"] = ri(det[:, :na])
            sub["beta"] = ri(det[:, na:])
