"""Finite-temperature post-processing.

Counterpart of ``pauxy/analysis/thermal.py:8-100``: average thermal
energies/particle numbers across a mu sweep and invert <N>(mu) for the
chemical potential hitting a target filling.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from pauxy_tpu_torch.analysis.blocking import reblock_summary
from pauxy_tpu_torch.analysis.extraction import extract_mixed_estimates, get_metadata


def analyse_energy(files, skip: int = 1) -> pd.DataFrame:
    """Per-file reblocked ETotal/Nav with the run's (beta, mu) attached
    (``thermal.py:8-44``)."""
    rows = []
    if isinstance(files, str):
        files = [files]
    for f in files:
        frame = extract_mixed_estimates(f)[skip:]
        md = get_metadata(f)
        row = {
            "beta": md["qmc"].get("beta"),
            "mu": md["qmc"].get("mu"),
        }
        for col in ("ETotal", "Nav"):
            if col in frame.columns:
                s = reblock_summary(np.asarray(frame[col].values, float))
                row[col] = s["mean"]
                row[f"{col}_error"] = s["standard error"]
        rows.append(row)
    return pd.DataFrame(rows).sort_values("mu")


def find_chem_pot(data: pd.DataFrame, target: float, vol: float = 1.0,
                  order: int = 3) -> float:
    """Invert <N>(mu) = target via a weighted polynomial fit + root find
    (``thermal.py:46-100``)."""
    import scipy.optimize

    nav = np.asarray(data["Nav"].values, float) / vol
    err = np.asarray(data.get("Nav_error", np.ones(len(nav))), float) / vol
    err[err == 0] = 1e-8
    mus = np.asarray(data["mu"].values, float)
    delta = nav - target
    fit = np.polyfit(mus, delta, min(order, len(mus) - 1), w=1.0 / err)
    return float(
        scipy.optimize.brentq(
            lambda m: np.polyval(fit, m), mus.min(), mus.max()
        )
    )
