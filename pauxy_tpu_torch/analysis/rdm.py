"""One-body RDM analysis utilities.

Counterpart of ``pauxy/analysis/rdm.py:1-32`` (analyse_one_body over
back-propagation splits) and ``pauxy/analysis/blocking.py:181-187``
(average_rdm).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from pauxy_tpu_torch.analysis.extraction import extract_rdm, get_param


def analyse_split(one_body: np.ndarray, rdms: np.ndarray):
    """Contract a one-body operator with an RDM series.

    one_body: [M, M] (spin-summed) or [2, M, M] (spin-resolved, applied
    per spin then summed); rdms: [nblocks, 2, M, M].
    """
    rdms = np.asarray(rdms)
    if np.asarray(one_body).ndim == 3:
        vals = np.einsum("sij,nsij->n", one_body, rdms).real
    else:
        vals = np.einsum("ij,nsij->n", one_body, rdms).real
    mean = vals.mean()
    err = vals.std(ddof=1) / len(vals) ** 0.5
    return mean, err


def analyse_one_body(filename: str, one_body: np.ndarray,
                     est_type: str = "back_propagated",
                     rdm_type: str = "one_rdm", skip: int = 1) -> pd.DataFrame:
    """<O_1> with error bars for each back-propagation split
    (``rdm.py:11-31``)."""
    splits = get_param(filename, ["estimators", "estimators",
                                  "back_prop", "splits"])
    dt = get_param(filename, ["qmc", "dt"])
    splits = np.atleast_1d(np.asarray(splits).ravel())
    res = []
    for s in splits:
        rdm = extract_rdm(filename, est_type=est_type, rdm_type=rdm_type,
                          ix=int(s))
        res.append(analyse_split(one_body, rdm[skip:]))
    es, errs = zip(*res)
    return pd.DataFrame({
        "tau": np.asarray(splits, dtype=float) * float(dt),
        "OneBody": es,
        "OneBody_error": errs,
    })


def average_rdm(filename: str, skip: int = 1,
                est_type: str = "back_propagated",
                rdm_type: str = "one_rdm", ix=None):
    """Mean and standard error of the RDM series (``blocking.py:181-187``)."""
    series = np.asarray(extract_rdm(filename, est_type=est_type,
                                    rdm_type=rdm_type, ix=ix))
    av = series[skip:].mean(axis=0)
    err = series[skip:].std(axis=0, ddof=1) / len(series[skip:]) ** 0.5
    return av, err
