"""Hubbard local energies: walker-batched and host-side.

Counterpart of ``local_energy_hubbard`` and the Hubbard branch of
``local_energy_G_host`` in ``pauxy_tpu/estimators/local_energy.py``. The
lanes block of ``qmc/hubbard_fast.py`` keeps its own fused energy.
"""

from __future__ import annotations

import numpy as np
import torch


def local_energy_hubbard(ham, Ga: torch.Tensor, Gb: torch.Tensor):
    """(etot, e1b, e2b), each [w], from G [w, M, M] of both spins:
    ke = sum T_s * G_s; pe = U sum_i G_up[ii] G_dn[ii], or
    -U/2 (tr G_up + tr G_dn) in the symmetric form."""
    t = ham.T.to(Ga.dtype)
    ke = (torch.einsum("mn,wmn->w", t[0], Ga)
          + torch.einsum("mn,wmn->w", t[1], Gb))
    da = torch.diagonal(Ga, dim1=-2, dim2=-1)
    db = torch.diagonal(Gb, dim1=-2, dim2=-1)
    if ham.symmetric:
        pe = -0.5 * ham.U * (da.sum(-1) + db.sum(-1))
    else:
        pe = ham.U * torch.sum(da * db, dim=-1)
    return ke + pe, ke, pe


def local_energy_G_host(ham, G: np.ndarray):
    """(etot, e1b, e2b) of one Green's function G [2, M, M], host-side."""
    if ham.name != "Hubbard":
        raise NotImplementedError(f"no host local energy for {ham.name!r}")
    t = ham.T.cpu().numpy()
    ke = np.sum(t[0] * G[0] + t[1] * G[1])
    if ham.symmetric:
        pe = -0.5 * ham.U * (np.trace(G[0]) + np.trace(G[1]))
    else:
        pe = ham.U * np.dot(np.diagonal(G[0]), np.diagonal(G[1]))
    return ke + pe, ke, pe
