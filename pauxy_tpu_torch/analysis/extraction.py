"""HDF5 -> pandas extraction of estimator output.

The port's copy of ``pauxy_tpu/analysis/extraction.py`` (HDF5 through
``utils.h5lite.open_file``). API-compatible with
``pauxy/analysis/extraction.py:14-143`` — the file
layout is shared, so either package's tooling reads either's files.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd

from pauxy_tpu_torch.utils import h5lite


def get_metadata(filename: str) -> dict:
    with h5lite.open_file(filename, "r") as fh5:
        return json.loads(fh5["metadata"][()])


def get_param(filename: str, param: list):
    md = get_metadata(filename)
    for p in param:
        md = md[p]
    return md


def extract_data(filename: str, group: str, estimator: str, raw: bool = False):
    with h5lite.open_file(filename, "r") as fh5:
        dsets = sorted(fh5[group][estimator].keys())
        data = np.array([fh5[group][estimator][d][:] for d in dsets])
        if "rdm" in estimator or "greens_function" in estimator or raw:
            return data
        header = fh5[group]["headers"][:]
        header = np.array([h.decode("utf-8") for h in header])
        df = pd.DataFrame(data)
        df.columns = header
        try:
            fp = get_param(filename, ["propagators", "free_projection"])
        except KeyError:
            fp = False
        if not fp:
            df = df.apply(np.real)
        return df


def extract_mixed_estimates(filename: str, skip: int = 0) -> pd.DataFrame:
    return extract_data(filename, "basic", "energies")[skip:]


def extract_bp_estimates(filename: str, skip: int = 0) -> pd.DataFrame:
    return extract_data(filename, "back_propagated", "energies")[skip:]


def extract_rdm(filename: str, est_type: str = "back_propagated",
                rdm_type: str = "one_rdm", ix: int | None = None):
    """Weighted-averaged RDM series (``extraction.py:36-60``)."""
    if est_type == "back_propagated":
        if ix is None:
            splits = get_param(filename, ["estimators", "estimators",
                                          "back_prop", "splits"])
            ix = splits[0][-1]
        denom = extract_data(filename, est_type, f"denominator_{ix}", raw=True)
        rdm = extract_data(filename, est_type, f"{rdm_type}_{ix}", raw=True)
        # Blocks whose BP window did not complete are zero-filled (denom 0);
        # normalize them to NaN without the numpy divide warning so callers
        # can filter with isfinite.
        d = denom[:, None, None]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(np.abs(d) > 0, rdm / np.where(d == 0, 1, d),
                            np.nan)
    return extract_data(filename, est_type, rdm_type, raw=True)


def extract_itcf(filename: str, name: str = "real_space_greens_function"):
    """(spgf [nblocks, ntau+1, 2, 2, M, M], denominators). ``name`` also
    selects ``k_space_greens_function`` when the run wrote one."""
    spgf = extract_data(filename, "itcf", name, raw=True)
    denom = extract_data(filename, "itcf", "denominator", raw=True)
    return spgf, denom
