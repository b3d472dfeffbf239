"""Single-determinant (UHF-style) trial wavefunctions for lattice models.

Counterpart of the lattice part of ``pauxy_tpu/models/trial.py``. Trials
are built host-side (numpy; setup, not the hot path) and hold their orbitals
as module buffers.

The trial's Green's function is G_s = conj(psi) (psi^T conj(psi))^{-1} psi^T.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import local_energy as le


class SingleDetTrial(nn.Module):
    """|psi_T> = |psi_a> x |psi_b>; ``inita``/``initb`` seed the walkers.

    ``G_host`` is the trial density matrix [2, M, M] as a numpy array
    (setup-only: the propagator's mean-field shift reads it).
    """

    def __init__(self, psia, psib, *, G_host: np.ndarray, etrial: float,
                 name: str = "single_det"):
        super().__init__()
        self.register_buffer("psia", psia)
        self.register_buffer("psib", psib)
        self.register_buffer("inita", psia.clone())
        self.register_buffer("initb", psib.clone())
        self.G_host = G_host
        self.etrial = float(etrial)
        self.name = name


def trial_density_matrix(psia: np.ndarray, psib: np.ndarray) -> np.ndarray:
    """G[2, M, M] with G_s = conj(psi_s) (psi_s^T conj(psi_s))^{-1} psi_s^T."""
    out = []
    for psi in (psia, psib):
        if psi.shape[1] == 0:
            out.append(np.zeros((psi.shape[0], psi.shape[0]), dtype=psi.dtype))
            continue
        ovlp = psi.T @ psi.conj()
        out.append(psi.conj() @ np.linalg.solve(ovlp.T, psi.T))
    return np.stack(out)


def _finalize(ham, psia, psib, prec, name: str, device) -> SingleDetTrial:
    psia = np.asarray(psia, dtype=prec.np_cplx)
    psib = np.asarray(psib, dtype=prec.np_cplx)
    g = trial_density_matrix(psia, psib)
    etrial = float(np.real(le.local_energy_G_host(ham, g)[0]))
    return SingleDetTrial(
        torch.from_numpy(np.ascontiguousarray(psia)).to(device),
        torch.from_numpy(np.ascontiguousarray(psib)).to(device),
        G_host=g.astype(prec.np_cplx), etrial=etrial, name=name,
    )


def trial_from_orbitals(ham, psi: np.ndarray, name: str = "file", *,
                        device=None, dtype=None) -> SingleDetTrial:
    """Trial from explicit orbitals psi [M, nup + ndown] (UHF layout)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    return _finalize(ham, psi[:, : ham.nup], psi[:, ham.nup:], prec, name,
                     device)


def free_electron_trial(ham, *, device=None, dtype=None) -> SingleDetTrial:
    """Occupy the lowest eigenvectors of the one-body Hamiltonian."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    h1 = ham.T.cpu().numpy()
    _, va = np.linalg.eigh(h1[0])
    _, vb = np.linalg.eigh(h1[1])
    return _finalize(ham, va[:, : ham.nup], vb[:, : ham.ndown], prec,
                     "free_electron", device)
