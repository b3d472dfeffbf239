"""Walker checkpoint / restart.

Counterpart of the unsharded half of ``pauxy_tpu/utils/checkpoint.py``,
in its HDF5 layout: every tensor field of the walker dataclass under
``walkers/<field>`` (complex ones as ``<field>__re`` / ``<field>__im``
planes), ``state_class``, ``step`` and ``eshift``.

The random stream is the one thing the packages do not share. The port
saves its ``torch.Generator`` state under ``torch_rng_state``, so a port
restart continues the same stream. JAX's ``rng_key`` (a threefry key)
cannot seed a Philox generator: a file written by the JAX package restores
the walkers, ``step`` and ``eshift``, and the driver starts a fresh
stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pauxy_tpu_torch.utils import h5lite


def save_walkers(state, filename: str, *,
                 generator: torch.Generator | None = None, step: int = 0,
                 eshift: float = 0.0, extra: dict | None = None):
    """Dump a walker dataclass (zero-T or thermal), the driver's scalars
    and, with ``generator``, its state."""
    with h5lite.open_file(filename, "w") as fh5:
        grp = fh5.create_group("walkers")
        for field in dataclasses.fields(state):
            val = getattr(state, field.name)
            if val is None:
                continue
            arr = val.detach().cpu().numpy() if torch.is_tensor(val) \
                else np.asarray(val)
            if np.iscomplexobj(arr):
                grp[field.name + "__re"] = np.ascontiguousarray(arr.real)
                grp[field.name + "__im"] = np.ascontiguousarray(arr.imag)
            else:
                grp[field.name] = arr
        fh5["state_class"] = type(state).__name__
        fh5["step"] = int(step)
        fh5["eshift"] = complex(eshift).real
        if generator is not None:
            fh5["torch_rng_state"] = generator.get_state().numpy()
        if extra:
            for k, v in extra.items():
                fh5[f"extra/{k}"] = v


def load_walkers(template, filename: str):
    """Restore the fields ``template`` carries (the file's others are
    ignored), cast to the template's dtypes and device.

    Returns (state, info): info holds ``step``, ``eshift``, ``rng_state``
    (the port's generator state as a uint8 tensor, or None) and
    ``jax_rng_key`` (the key data a JAX-written file holds, or None).
    """
    updates = {}
    with h5lite.open_file(filename, "r") as fh5:
        grp = fh5["walkers"]
        for field in dataclasses.fields(template):
            name = field.name
            t = getattr(template, name)
            if t is None:
                continue
            if name in grp:
                arr = np.asarray(grp[name])
            elif name + "__re" in grp:
                arr = np.asarray(grp[name + "__re"]) + 1j * np.asarray(
                    grp[name + "__im"])
            else:
                continue
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"{filename}: walkers/{name} has shape {arr.shape}, "
                    f"the run's {tuple(t.shape)}")
            updates[name] = torch.from_numpy(np.array(arr)).to(
                device=t.device, dtype=t.dtype)
        info = {
            "step": int(fh5["step"][()]),
            "eshift": float(fh5["eshift"][()]),
            "rng_state": None,
            "jax_rng_key": None,
        }
        if "torch_rng_state" in fh5:
            info["rng_state"] = torch.from_numpy(
                np.asarray(fh5["torch_rng_state"], dtype=np.uint8))
        if "rng_key" in fh5:
            info["jax_rng_key"] = np.asarray(fh5["rng_key"])
    return dataclasses.replace(template, **updates), info
