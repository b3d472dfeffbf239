"""Real-space correlation functions from QMC Green's functions.

Counterpart of ``pauxy/analysis/correlation.py:3-16`` (strip extraction for
Hubbard lattices) and ``pauxy/analysis/blocking.py:189-196``
(average_correlation: hole and spin densities from a G series).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def encode_basis(ix: int, iy: int, nx: int) -> int:
    """Map 2D lattice coordinates to a basis index (row-major in y)."""
    return ix + iy * nx


def get_strip(cfunc, cfunc_err, ix: int, nx: int, ny: int, stag: bool = False):
    """Column strip of a density profile, optionally staggered
    (``systems/hubbard.py:390-398``)."""
    iy = list(range(ny))
    idx = [encode_basis(ix, i, nx) for i in iy]
    if stag:
        c = [((-1) ** (ix + i)) * cfunc[ib] for i, ib in zip(iy, idx)]
    else:
        c = [cfunc[ib] for ib in idx]
    cerr = [cfunc_err[ib] for ib in idx]
    return np.asarray(c), np.asarray(cerr)


def average_correlation(gf: np.ndarray):
    """Hole / spin density profiles with errors from a Green's-function
    series gf [nblocks, 2, M, M] (``blocking.py:189-196``)."""
    gf = np.asarray(gf)
    ni = np.diagonal(gf, axis1=2, axis2=3).real  # [n, 2, M]
    hole = 1.0 - ni.sum(axis=1)                  # [n, M]
    spin = 0.5 * (ni[:, 0, :] - ni[:, 1, :])
    n = len(gf)
    return (
        hole.mean(axis=0),
        hole.std(axis=0, ddof=1) / n ** 0.5,
        spin.mean(axis=0),
        spin.std(axis=0, ddof=1) / n ** 0.5,
        gf,
    )


def correlation_function(filename: str, nx: int, ny: int, ix: int = 0,
                         skip: int = 1, est_type: str = "back_propagated",
                         ) -> pd.DataFrame:
    """Hole/spin strip profile from a stored RDM series
    (``correlation.py:3-16``; we derive it from the one_rdm datasets
    rather than a dedicated 'correlation' dataset)."""
    from pauxy_tpu_torch.analysis.extraction import extract_rdm

    rdm = np.asarray(extract_rdm(filename, est_type=est_type))[skip:]
    # extract_rdm returns P (density); diag already is <n_i sigma>.
    h, herr, s, serr, _ = average_correlation(rdm)
    hs, herrs = get_strip(h, herr, ix, nx, ny)
    ss, serrs = get_strip(s, serr, ix, nx, ny, stag=True)
    return pd.DataFrame({
        "hole": hs, "hole_err": herrs, "spin": ss, "spin_err": serrs,
    })
