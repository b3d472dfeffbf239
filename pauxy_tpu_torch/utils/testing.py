"""Test fixtures: random factorized Hamiltonians and wavefunctions.

Copied from ``pauxy_tpu/utils/testing.py`` (numpy only), so that the
port's tests and ``chip_smoke.py`` build the same seeded systems without
importing the JAX package. A random PSD super-matrix
M_{(ik),(jl)} is eigen-factorized into Cholesky-like vectors L[ik, x], which
by construction satisfy the (ik|jl) = sum_x L[ik,x] L[jl,x] structure the
propagator and energy kernels assume.
"""

from __future__ import annotations

import numpy as np


def generate_hamiltonian(nmo: int, nelec, seed: int = 7,
                         nchol: int | None = None):
    """Random real symmetric Hamiltonian in factorized form.

    Returns (h1e [nmo, nmo], chol [nmo, nmo, X], enuc, eri [nmo,nmo,nmo,nmo])
    with eri in the (ik|jl) convention used by the reference's dense kernel
    (``pauxy/estimators/generic.py:4-33`` contracts eri as 'prqs,pr,qs').
    """
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((nmo, nmo))
    h1e = 0.5 * (h1e + h1e.T)
    # Random PSD super-matrix with 8-fold-symmetric generator.
    a = rng.normal(scale=0.1, size=(nmo * nmo, max(1, nmo)))
    # Symmetrize in (i,k): L[ik] = L[ki] guarantees (ik|jl) 8-fold symmetry
    # for real integrals.
    a = a.reshape(nmo, nmo, -1)
    a = 0.5 * (a + a.transpose(1, 0, 2))
    a = a.reshape(nmo * nmo, -1)
    m = a @ a.T
    evals, evecs = np.linalg.eigh(m)
    keep = evals > 1e-10
    if nchol is not None:
        order = np.argsort(evals)[::-1][:nchol]
        keep = np.zeros_like(keep)
        keep[order] = True
    chol = (evecs[:, keep] * np.sqrt(evals[keep])[None, :])  # [nmo^2, X]
    eri = (chol @ chol.T).reshape(nmo, nmo, nmo, nmo)
    enuc = float(rng.random())
    return h1e, chol.reshape(nmo, nmo, -1), enuc, eri


def random_wavefunction(nmo: int, nelec, seed: int = 7) -> np.ndarray:
    """Random complex [nmo, na+nb] Slater matrix (testing.py:57-63)."""
    rng = np.random.default_rng(seed)
    na, nb = nelec
    return rng.standard_normal((nmo, na + nb)) + 1j * rng.standard_normal(
        (nmo, na + nb)
    )
