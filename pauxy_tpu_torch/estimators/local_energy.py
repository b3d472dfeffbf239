"""Host-side local energy for trial construction.

Counterpart of the Hubbard branch of
``pauxy_tpu/estimators/local_energy.local_energy_G_host``; the walker-batched
energy of the main path lives inside ``qmc/hubbard_fast.py``.
"""

from __future__ import annotations

import numpy as np


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
