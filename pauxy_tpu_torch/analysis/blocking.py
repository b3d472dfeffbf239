"""Statistical post-processing: reblocking of correlated QMC series.

Counterpart of ``pauxy/analysis/blocking.py:69-340``. The reference depends
on the external ``pyblock`` package; here the Flyvbjerg-Petersen reblocking
(J. Chem. Phys. 91, 461 (1989)) and the automatic block-size selection of
Wolff/Lee et al. are implemented directly in numpy.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def reblock_series(x: np.ndarray) -> pd.DataFrame:
    """Flyvbjerg-Petersen blocking analysis of one series.

    Returns a frame with one row per blocking level: block size, mean,
    standard error and the error on the error.
    """
    x = np.asarray(x, dtype=float)
    rows = []
    level = 0
    # A single sample still yields a level-0 row (se = 0) so downstream
    # summaries never see an empty frame.
    while len(x) >= 1:
        n = len(x)
        mean = x.mean()
        var = x.var(ddof=1) if n > 1 else 0.0
        se = np.sqrt(var / n)
        se_err = se / np.sqrt(2.0 * (n - 1)) if n > 1 else 0.0
        rows.append(
            {
                "level": level,
                "block_size": 2 ** level,
                "ndata": n,
                "mean": mean,
                "standard error": se,
                "standard error error": se_err,
            }
        )
        if n < 4:
            break
        x = 0.5 * (x[: 2 * (n // 2) : 2] + x[1 : 2 * (n // 2) : 2])
        level += 1
    return pd.DataFrame(rows)


def optimal_block(blocked: pd.DataFrame) -> int:
    """Automatic blocking-level choice: the first level where the error
    estimate plateaus (successive standard errors agree within their own
    error bars) — the usual Flyvbjerg-Petersen stopping rule."""
    ses = blocked["standard error"].values
    errs = blocked["standard error error"].values
    for i in range(len(ses) - 1):
        if abs(ses[i + 1] - ses[i]) <= errs[i + 1] + errs[i]:
            return i
    return max(len(ses) - 1, 0)


def reblock_summary(x: np.ndarray) -> dict:
    """Mean/standard error at the automatically chosen blocking level."""
    blocked = reblock_series(x)
    ix = optimal_block(blocked)
    row = blocked.iloc[ix]
    return {
        "mean": row["mean"],
        "standard error": row["standard error"],
        "standard error error": row["standard error error"],
        "block_size": int(row["block_size"]),
        "nsamples": int(row["ndata"]),
    }


def reblock_mixed(frame: pd.DataFrame, skip: int = 0,
                  columns=("ETotal", "E1Body", "E2Body", "EHybrid",
                           "Weight", "Nav")) -> pd.DataFrame:
    """Reblock the standard mixed-estimator columns
    (``blocking.py:98-137``)."""
    frame = frame[skip:]
    out = {}
    for col in columns:
        if col not in frame.columns:
            continue
        vals = np.asarray(frame[col].values, dtype=complex).real
        s = reblock_summary(vals)
        out[col] = s
    rows = []
    for col, s in out.items():
        rows.append({"estimator": col, **s})
    return pd.DataFrame(rows).set_index("estimator")


def average_ratio(num: np.ndarray, denom: np.ndarray) -> tuple[float, float]:
    """Mean and jackknife error of <num>/<denom> (correlated ratio;
    ``blocking.py:30-68`` average_ratio)."""
    num = np.asarray(num, dtype=complex).real
    denom = np.asarray(denom, dtype=complex).real
    n = len(num)
    full = num.sum() / denom.sum()
    if n < 2:
        return full, 0.0
    jack = np.array(
        [
            (num.sum() - num[i]) / (denom.sum() - denom[i])
            for i in range(n)
        ]
    )
    err = np.sqrt((n - 1) / n * np.sum((jack - jack.mean()) ** 2))
    return full, err


def average_fp(frame: pd.DataFrame, skip: int = 0) -> pd.DataFrame:
    """Free projection: ratio statistics of ENumer/EDenom
    (``blocking.py:69-97``)."""
    frame = frame[skip:]
    num = np.asarray(frame["ENumer"].values, dtype=complex)
    den = np.asarray(frame["EDenom"].values, dtype=complex)
    mean_r, err_r = average_ratio(num.real, den.real)
    return pd.DataFrame(
        [{"E": mean_r, "E_error": err_r, "nsamples": len(num)}]
    )


def analyse_energy(files_or_frame, skip: int = 0) -> pd.DataFrame:
    """One-shot mixed-energy analysis from file path(s) or a frame
    (``blocking.py:292-340`` analyse_estimates / thermal.py:8)."""
    if isinstance(files_or_frame, pd.DataFrame):
        frame = files_or_frame
    else:
        from pauxy_tpu_torch.analysis.extraction import extract_mixed_estimates

        if isinstance(files_or_frame, str):
            files_or_frame = [files_or_frame]
        frame = pd.concat(
            [extract_mixed_estimates(f) for f in files_or_frame]
        )
    return reblock_mixed(frame, skip=skip)


def average_rdm(filename, skip: int = 1, est_type: str = "back_propagated",
                rdm_type: str = "one_rdm", ix=None):
    """Block-averaged RDM + standard error (``blocking.py:181-186``)."""
    from pauxy_tpu_torch.analysis.extraction import extract_rdm

    series = extract_rdm(filename, est_type=est_type, rdm_type=rdm_type,
                         ix=ix)
    av = series[skip:].mean(axis=0)
    err = series[skip:].std(axis=0, ddof=1) / len(series[skip:]) ** 0.5
    return av, err


def analyse_estimates(files, start_time: float = 0.0,
                      verbose: bool = False) -> pd.DataFrame:
    """One-shot analysis writer (``blocking.py:292-340``): reblock the mixed
    estimates of each file (FP-aware), print the table, and write
    ``analysed_<basename>.h5`` with basic/estimates + headers + metadata.
    """
    import json
    import os

    from pauxy_tpu_torch.analysis.extraction import (extract_mixed_estimates,
                                               get_metadata, get_param)

    if isinstance(files, str):
        files = [files]
    mds, frames, fp_list = [], [], []
    for f in files:
        md = get_metadata(f)
        step = (md.get("qmc", {}) or {}).get("nsteps", 1)
        dt = (md.get("qmc", {}) or {}).get("dt", 1.0)
        fp_list.append(
            bool((md.get("propagators", {}) or {}).get("free_projection",
                                                       False))
        )
        skip = int(start_time / (step * dt)) + 1
        frames.append(extract_mixed_estimates(f, skip))
        mds.append(md)
    if len(set(fp_list)) > 1:
        raise ValueError(
            "cannot concatenate free-projection and phaseless output files "
            f"in one analysis: free_projection flags per file = {fp_list}"
        )
    fp = any(fp_list)
    frame = pd.concat(frames)
    if fp:
        out = average_fp(frame)
    else:
        out = reblock_mixed(frame.apply(np.real))
    if verbose:
        print(out.to_string(index=False,
                            float_format=lambda x: f"{x:13.8f}"))
    base = os.path.basename(files[0])
    outfile = "analysed_" + base
    from pauxy_tpu_torch.utils import h5lite

    with h5lite.open_file(outfile, "w") as fh5:
        fh5["metadata"] = np.array(
            [json.dumps(md) for md in mds]
        ).astype("S")
        fh5["basic/estimates"] = out.values.astype(float)
        fh5["basic/headers"] = np.array(out.columns.values).astype("S")
    return out


def get_ortho_ao_mod(s: np.ndarray, lindep_cutoff: float = 1e-14):
    """Canonical orthogonalization dropping near-null directions
    (``pauxy/utils/linalg.py:191-199``)."""
    sdiag, us = np.linalg.eigh(s)
    keep = sdiag > lindep_cutoff
    x = us[:, keep] / np.sqrt(sdiag[keep])
    smod = us[:, keep] @ np.diag(sdiag[keep]) @ us[:, keep].conj().T
    return smod, x


def analyse_ekt_ipea(filename, ix=None, cutoff: float = 1e-14,
                     screen_factor: float = 1.0):
    """EKT ionization potentials / electron affinities from the BP 1-RDM and
    the 1h/1p generalized Fock matrices (``blocking.py:342-362``):
    solve F^h c = e S c in the orthogonalized metric S = spin-summed RDM
    (IPs) and S = 2 - RDM^T (EAs)."""
    rdm, rdm_err = average_rdm(filename, rdm_type="one_rdm", ix=ix)
    f1h, f1h_err = average_rdm(filename, rdm_type="fock_1h", ix=ix)
    f1p, f1p_err = average_rdm(filename, rdm_type="fock_1p", ix=ix)
    rdm = np.where(np.abs(rdm) < screen_factor * rdm_err, 0.0, rdm)
    f1h = np.where(np.abs(f1h) < screen_factor * f1h_err, 0.0, f1h)
    f1p = np.where(np.abs(f1p) < screen_factor * f1p_err, 0.0, f1p)
    rdm = rdm[0] + rdm[1]
    rdm = 0.5 * np.real(rdm + rdm.conj().T)
    _, x = get_ortho_ao_mod(rdm, cutoff)
    eip, eip_vec = np.linalg.eigh(x.conj().T @ f1h @ x)
    norb = rdm.shape[-1]
    gamma = 2.0 * np.eye(norb) - rdm.T
    _, x = get_ortho_ao_mod(gamma, cutoff)
    eea, eea_vec = np.linalg.eigh(x.conj().T @ f1p @ x)
    return (eip, eip_vec), (eea, eea_vec)
