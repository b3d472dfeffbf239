"""HDF5 output and option lookup.

Counterpart of ``pauxy_tpu/utils/io.py``: the same file layout (one dataset
per block under ``<group>/<name>/NNNNNNNNN``, a ``basic/headers`` string
array and a ``metadata`` JSON blob), so the same extraction tooling reads
both packages' files. Files go through ``utils.h5lite.open_file``: h5py
where it imports, else the port's own HDF5 writer.
"""

from __future__ import annotations

import json

import numpy as np

from pauxy_tpu_torch.utils import h5lite


def get_input_value(inputs: dict, key: str, default=None, alias=None,
                    verbose=False):
    """Option lookup with aliases."""
    val = inputs.get(key)
    if val is None and alias is not None:
        for a in alias:
            val = inputs.get(a)
            if val is not None:
                break
    if val is None:
        val = default
        if verbose and default is not None:
            print(f"# Note: {key} not specified. Setting to default value "
                  f"{default}.")
    return val


class H5EstimatorHelper:
    """Push one dataset per block under ``base/name/<zero-padded index>``."""

    def __init__(self, filename: str, base: str):
        self.filename = filename
        self.base = base
        self.index = 0
        self.nzero = 9

    def push(self, data, name: str):
        padded = str(self.index).zfill(self.nzero)
        with h5lite.open_file(self.filename, "a") as fh5:
            fh5[f"{self.base}/{name}/{padded}"] = np.asarray(data)

    def increment(self):
        self.index += 1


def resolve_estimates_filename(eopts: dict) -> str:
    """The reference's output-file naming (``estimators/handler.py:60-69``):
    explicit ``filename`` wins; otherwise ``<basename>.<index>.h5`` with
    ``overwrite: false`` auto-incrementing the index past existing files
    (the scan workflows rely on this to keep one file per (beta, mu)
    point)."""
    import os

    filename = eopts.get("filename")
    if filename is not None:
        return filename
    basename = eopts.get("basename", "estimates")
    index = int(eopts.get("index", 0))
    filename = f"{basename}.{index}.h5"
    if not eopts.get("overwrite", True):
        while os.path.isfile(filename):
            index += 1
            filename = f"{basename}.{index}.h5"
    return filename


def create_estimates_file(filename: str, headers, metadata: dict):
    """Create the output file with headers + metadata JSON."""
    with h5lite.open_file(filename, "w") as fh5:
        fh5["basic/headers"] = np.array(headers).astype("S")
        fh5["metadata"] = json.dumps(metadata, default=_json_default)


def _json_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, complex):
        return [obj.real, obj.imag]
    return str(obj)


def format_fixed_width_floats(values) -> str:
    """Fixed width row formatting (``pauxy/utils/io.py:18-30`` analogue)."""
    return "".join(f"{float(np.real(v)): 16.8e} " for v in values)


def get_git_revision_hash():
    """(sha, branch) of the installed package tree, '-dirty' suffixed when
    the working tree has local changes (``pauxy/utils/misc.py:14-56``)."""
    import os
    import subprocess

    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=src,
            stderr=subprocess.DEVNULL).strip().decode()
        dirty = subprocess.check_output(
            ["git", "status", "--porcelain"], cwd=src,
            stderr=subprocess.DEVNULL).strip()
        branch = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"], cwd=src,
            stderr=subprocess.DEVNULL).strip().decode()
    except Exception:
        return "none", "none"
    return (sha + "-dirty" if dirty else sha), branch


def get_sys_info() -> dict:
    """Provenance blob for the output metadata: git sha/branch, host,
    python, numpy, torch and CUDA versions, the card's name
    (``pauxy/utils/misc.py`` serialise extras)."""
    import platform
    import sys

    import torch

    sha, branch = get_git_revision_hash()
    info = {
        "git_sha": sha,
        "git_branch": branch,
        "hostname": platform.node(),
        "python": sys.version.split()[0],
        "numpy": np.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    return info


def write_input(filename: str, hamil: str, wfn: str, bp: bool = False,
                options: dict | None = None):
    """Skeleton input JSON for a Generic/QMCPACK-format run
    (``pauxy/utils/io.py:566-606``). Reads particle counts from the
    wavefunction h5 when available."""
    nup = ndown = None
    try:
        with h5lite.open_file(wfn, "r") as fh5:
            for grp in ("Wavefunction/NOMSD", "Wavefunction/PHMSD"):
                if f"{grp}/dims" in fh5:
                    dims = fh5[f"{grp}/dims"][:]
                    nup, ndown = int(dims[1]), int(dims[2])
                    break
    except (OSError, KeyError):
        pass
    basic = {
        "system": {"name": "Generic", "integrals": hamil},
        "qmc": {"dt": 0.005, "nwalkers": 100, "blocks": 1000},
        "trial": {"filename": wfn},
        "estimators": {},
    }
    if nup is not None:
        basic["system"]["nup"] = nup
        basic["system"]["ndown"] = ndown
    if bp:
        basic["estimators"]["back_propagated"] = {"tau_bp": 2.0, "nsplit": 4}
    full = _merge_dicts(basic, options or {})
    with open(filename, "w") as f:
        json.dump(full, f, indent=4, separators=(",", ": "))


def _merge_dicts(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_dicts(out[k], v)
        else:
            out[k] = v
    return out
