"""HDF5 output and option lookup.

Counterpart of ``pauxy_tpu/utils/io.py``: the same file layout (one dataset
per block under ``<group>/<name>/NNNNNNNNN``, a ``basic/headers`` string
array and a ``metadata`` JSON blob), so the same extraction tooling reads
both packages' files. ``h5py`` is imported only when a file is written.
"""

from __future__ import annotations

import json

import numpy as np


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
        import h5py

        padded = str(self.index).zfill(self.nzero)
        with h5py.File(self.filename, "a") as fh5:
            fh5[f"{self.base}/{name}/{padded}"] = np.asarray(data)

    def increment(self):
        self.index += 1


def create_estimates_file(filename: str, headers, metadata: dict):
    """Create the output file with headers + metadata JSON."""
    import h5py

    with h5py.File(filename, "w") as fh5:
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
