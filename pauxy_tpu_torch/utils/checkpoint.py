"""Walker checkpoint / restart.

Counterpart of ``pauxy_tpu/utils/checkpoint.py``, in its HDF5 layouts.
The dense file: every tensor field of the walker dataclass under
``walkers/<field>`` (complex ones as ``<field>__re`` / ``<field>__im``
planes), ``state_class``, ``step`` and ``eshift``. The sharded directory
(:func:`save_walkers_sharded`): one ``shard_{start:08d}.h5`` a walker
shard, named by its global walker offset, holding the shard's rows of
every per-walker field at its root, and ``meta.h5`` with ``state_class``,
``step``, ``eshift``, ``nwalkers`` and the scalar fields under
``scalars/``. On a walker mesh each rank writes and reads only its own
shard; rank 0 writes the metadata.

The random stream is the one thing the packages do not share. The port
saves its ``torch.Generator`` state under ``torch_rng_state``, so a port
restart continues the same stream. JAX's ``rng_key`` (a threefry key)
cannot seed a Philox generator: a file written by the JAX package restores
the walkers, ``step`` and ``eshift``, and the driver starts a fresh
stream.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from pauxy_tpu_torch.parallel import mesh as pmesh
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


# ---------------------------------------------------------------------------
# Sharded checkpoint: one file a walker shard + meta.h5
# ---------------------------------------------------------------------------


def _host(val) -> np.ndarray:
    return val.detach().cpu().numpy() if torch.is_tensor(val) \
        else np.asarray(val)


def _put(fh5, name: str, arr: np.ndarray):
    if np.iscomplexobj(arr):
        fh5[name + "__re"] = np.ascontiguousarray(arr.real)
        fh5[name + "__im"] = np.ascontiguousarray(arr.imag)
    else:
        fh5[name] = np.ascontiguousarray(arr)


def _get(fh5, name: str):
    if name in fh5:
        return np.asarray(fh5[name])
    if name + "__re" in fh5:
        return np.asarray(fh5[name + "__re"]) + 1j * np.asarray(
            fh5[name + "__im"])
    return None


def save_walkers_sharded(state, dirname: str, *,
                         generator: torch.Generator | None = None,
                         step: int = 0, eshift: float = 0.0):
    """Write this rank's shard of ``state`` (its rows of every per-walker
    field; the whole state without a mesh) to ``dirname`` as
    ``shard_{start:08d}.h5``, start its global walker offset, and, on rank
    0, ``meta.h5`` with the driver's scalars and, with ``generator``, its
    state (every rank's is the same). On a [walker, chol] mesh the chol
    coordinate 0 of each walker slice writes it, after the
    back-propagation buffer's X slices [w, nhist, X / R] are gathered over
    the chol group, so that the file holds the whole X as JAX's does.
    Returns when every rank has written."""
    mesh = pmesh.active_mesh()
    nl = state.weight.shape[0]
    wcoord = 0 if mesh is None else mesh.coord(pmesh.WALKER_AXIS)
    nwalkers = nl * (1 if mesh is None else mesh.nwalker)
    os.makedirs(dirname, exist_ok=True)
    fields = [(f.name, getattr(state, f.name))
              for f in dataclasses.fields(state)
              if getattr(state, f.name) is not None]
    if mesh is not None and mesh.nchol > 1:
        # Every chol rank takes part in the gather.
        fields = [(name, pmesh.gather_chol(val, 2) if name == "configs"
                   else val) for name, val in fields]
    if mesh is None or mesh.coord(pmesh.CHOL_AXIS) == 0:
        fname = os.path.join(dirname, f"shard_{wcoord * nl:08d}.h5")
        with h5lite.open_file(fname, "w") as fh5:
            for name, val in fields:
                if torch.is_tensor(val) and val.dim() >= 1:
                    _put(fh5, name, _host(val))
    if pmesh.is_rank0():
        with h5lite.open_file(os.path.join(dirname, "meta.h5"), "w") as fh5:
            fh5["state_class"] = type(state).__name__
            fh5["step"] = int(step)
            fh5["eshift"] = complex(eshift).real
            fh5["nwalkers"] = int(nwalkers)
            if generator is not None:
                fh5["torch_rng_state"] = generator.get_state().numpy()
            for name, val in fields:
                if not (torch.is_tensor(val) and val.dim() >= 1):
                    fh5[f"scalars/{name}"] = _host(val)
    if mesh is not None and torch.distributed.is_initialized():
        # The directory is whole when any rank returns.
        torch.distributed.barrier()


def load_walkers_sharded(template, dirname: str, mesh=None):
    """Restore a walker state from a sharded checkpoint directory (the
    port's or the JAX package's). With ``mesh`` the template holds this
    rank's rows and only the shard files covering them are read (on a
    [walker, chol] mesh the back-propagation buffer keeps this rank's X
    slice of the file's whole X); without one the shards are concatenated
    into the whole population. A field present in some shard files and
    missing from others, or shards that do not add up to ``nwalkers``,
    raise ``ValueError`` (an incomplete checkpoint), on every rank alike.

    Returns (state, info) as :func:`load_walkers`.
    """
    files = sorted(glob.glob(os.path.join(dirname, "shard_*.h5")))
    if not files:
        raise FileNotFoundError(f"no shard files in {dirname!r}")
    starts = [int(os.path.basename(f)[6:-3]) for f in files]
    with h5lite.open_file(os.path.join(dirname, "meta.h5"), "r") as fh5:
        info = {"step": int(fh5["step"][()]),
                "eshift": float(fh5["eshift"][()]),
                "rng_state": None, "jax_rng_key": None}
        nwalkers = int(fh5["nwalkers"][()])
        if "torch_rng_state" in fh5:
            info["rng_state"] = torch.from_numpy(
                np.asarray(fh5["torch_rng_state"], dtype=np.uint8))
        if "rng_key" in fh5:
            info["jax_rng_key"] = np.asarray(fh5["rng_key"])
        scalars = {name: np.asarray(fh5[f"scalars/{name}"])
                   for name in (fh5["scalars"] if "scalars" in fh5 else ())}
        repl = {}
        for name in (fh5["replicated"] if "replicated" in fh5 else ()):
            base = name[:-4] if name.endswith(("__re", "__im")) else name
            repl[base] = _get(fh5["replicated"], base)
    # Completeness from the files' metadata (every rank checks every file).
    names = {}
    for f in files:
        with h5lite.open_file(f, "r") as fh5:
            for key in fh5.keys():
                base = key[:-4] if key.endswith(("__re", "__im")) else key
                names.setdefault(base, set()).add(f)
                if base == "weight":
                    names.setdefault("_rows", {})[f] = fh5[key].shape[0]
    rows = names.pop("_rows", {})
    for name, have in names.items():
        if len(have) != len(files):
            raise ValueError(
                f"checkpoint {dirname!r} is incomplete: field {name!r} "
                f"missing from {len(files) - len(have)} of {len(files)} "
                "shard files")
    if sum(rows.values()) != nwalkers:
        raise ValueError(
            f"checkpoint {dirname!r} is incomplete: its shards hold "
            f"{sum(rows.values())} of {nwalkers} walkers")
    ends = [s + rows[f] for s, f in zip(starts, files)]
    if mesh is not None:
        nl = template.weight.shape[0]
        lo = mesh.coord(pmesh.WALKER_AXIS) * nl
        hi = lo + nl
    else:
        lo, hi = 0, nwalkers
    mine = [(f, s, e) for f, s, e in zip(files, starts, ends)
            if s < hi and e > lo]
    parts = {}
    for f, s, e in mine:
        with h5lite.open_file(f, "r") as fh5:
            for name in names:
                arr = _get(fh5, name)
                parts.setdefault(name, []).append(
                    arr[max(lo - s, 0):min(hi, e) - s])
    updates = {}
    for field in dataclasses.fields(template):
        name = field.name
        t = getattr(template, name)
        if not torch.is_tensor(t):
            continue
        if t.dim() == 0:
            arr = scalars.get(name)
        elif name in repl:
            arr = repl[name]
        elif name in parts:
            arr = np.concatenate(parts[name], axis=0)
        else:
            continue
        if arr is None:
            continue
        if name == "configs" and mesh is not None and mesh.nchol > 1:
            nl = t.shape[2]
            c = mesh.coord(pmesh.CHOL_AXIS)
            arr = arr[:, :, c * nl:(c + 1) * nl]
        if tuple(np.shape(arr)) != tuple(t.shape):
            raise ValueError(
                f"{dirname}: {name} has shape {np.shape(arr)}, the run's "
                f"{tuple(t.shape)}")
        updates[name] = torch.from_numpy(np.array(arr)).to(
            device=t.device, dtype=t.dtype)
    return dataclasses.replace(template, **updates), info
