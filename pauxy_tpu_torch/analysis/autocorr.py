"""Autocorrelation-time based error analysis (emcee-style).

Counterpart of ``pauxy/analysis/autocorr.py:1-70``: integrated
autocorrelation time via the Goodman & Weare (2010) automatic windowing,
then reblocking with the measured correlation length.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def autocorr_func_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation function via FFT."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    n = 1 << (2 * len(x) - 1).bit_length()
    xc = x - x.mean()
    f = np.fft.fft(xc, n=n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.ones_like(acf)
    return acf / acf[0]


def integrated_time(x: np.ndarray, c: float = 5.0) -> float:
    """Integrated autocorrelation time with automatic windowing
    (Sokal / Goodman-Weare)."""
    f = autocorr_func_1d(x)
    taus = 2.0 * np.cumsum(f) - 1.0
    window = np.arange(len(taus)) < c * taus
    if np.all(window):
        return float(taus[-1])
    return float(taus[np.argmin(window)])


def reblock_by_autocorr(y: np.ndarray, name: str = "ETotal",
                        verbose: bool = False) -> pd.DataFrame:
    """Block by the measured autocorrelation time (``autocorr.py:44-70``)."""
    y = np.asarray(y, dtype=float)
    nmax = max(int(np.log2(len(y))), 1)
    tacs = []
    for i in range(nmax):
        n = int(len(y) / 2 ** i)
        if n < 8:
            break
        tacs.append(integrated_time(y[:n]))
        if verbose:
            print(f"# nsamples, tac = {n}, {tacs[-1]}")
    block_size = max(1, int(np.round(np.max(tacs))))
    nblocks = len(y) // block_size
    yb = y[: nblocks * block_size].reshape(nblocks, block_size).mean(axis=1)
    yavg = yb.mean()
    ystd = yb.std() / np.sqrt(max(nblocks, 1))
    return pd.DataFrame(
        {
            f"{name}_ac": [yavg],
            f"{name}_error_ac": [ystd],
            f"{name}_nsamp_ac": [nblocks],
            "ac": [block_size],
        }
    )
