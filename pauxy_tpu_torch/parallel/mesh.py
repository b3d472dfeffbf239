"""The walker mesh: walker-axis (and Cholesky-axis) sharding over ranks.

Counterpart of ``pauxy_tpu/parallel/mesh.py``. JAX runs one program over a
``jax.sharding.Mesh`` and XLA inserts the collectives. Here every rank (one
process, one card) runs the same driver over a contiguous slice of W / R
walkers, R the size of the walker axis, and the collectives are explicit
``torch.distributed`` calls over the axis's process group: NCCL on cards,
gloo on the CPU. The caller starts the process group
(``torch.distributed.init_process_group``, e.g. under ``torchrun``); a
:class:`Mesh` lays the ranks out as ``[walker, chol]``, rank = walker
coordinate x chol size + chol coordinate, as JAX reshapes its devices.

Random draws stay those of the one-rank run: every rank draws a step's
noise for the whole population (all W walkers, and all X fields on a
``[walker, chol]`` mesh) from the same generator and keeps its own rows and
columns (:func:`draw`), so an R-rank run equals the one-rank run to
rounding, at R times the draws; draws every walker shares (the
stochastic-RI probes [X, S], the sketches [M, S]) are drawn whole on every
rank, which keeps its X rows (:func:`draw_shared`). Population control
gathers the W weights on every rank, computes the same global parents there and moves only the
rows whose parent lives on another rank (:func:`exchange`). The block
sums of the estimators are summed over the walker group once a block
(:func:`walker_sum`); on the Cholesky axis the force bias, the VHS and the
energy's Coulomb and exchange sums are partial sums over the rank's X
slice, summed over the chol group (:func:`chol_sum`); the
back-propagation field buffer holds this rank's X slice of the fields
[w, nhist, X / R] (:func:`shard_walkers`).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch
import torch.distributed as dist

from pauxy_tpu_torch import config

WALKER_AXIS = "walker"
CHOL_AXIS = "chol"

# The mesh in force for the current run, registered by shard_walkers (or a
# test) and cleared by a fresh driver.
_ACTIVE_MESH = None


def is_rank0() -> bool:
    """Whether this process writes the files: rank 0 of the process
    group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def set_active_mesh(mesh):
    """Register (or clear, with None) the mesh used by the current run."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a ``[walker, chol]`` grid: ``shape`` (walker size, chol
    size), this rank's ``coords``, the process group of each axis
    (``groups[axis]``: the walker axis always has one, so that its
    collectives run even on one rank; the chol axis has none at size 1)
    and this rank's ``device``."""

    shape: tuple
    coords: tuple
    groups: dict
    device: torch.device
    axis_names: tuple = (WALKER_AXIS, CHOL_AXIS)

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def nwalker(self) -> int:
        return self.shape[0]

    @property
    def nchol(self) -> int:
        return self.shape[1]


def _rank_device(device) -> torch.device:
    """``cuda:<local rank>`` (``LOCAL_RANK``, as torchrun sets it, else the
    rank modulo the cards) unless ``device`` is given; no card raises
    (``config.resolve_device``). The mesh makes a CUDA device the current
    one."""
    if device is not None:
        return config.resolve_device(device)
    config.resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    return torch.device("cuda", local)


def _build(n_walker: int, n_chol: int, device) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "the walker mesh needs torch.distributed: call "
            "init_process_group first (one rank per card)")
    rank = dist.get_rank()
    groups = {WALKER_AXIS: None, CHOL_AXIS: None}
    # Every rank takes part in creating every group, in the same order.
    if n_chol == 1:
        groups[WALKER_AXIS] = dist.group.WORLD
    else:
        for c in range(n_chol):
            g = dist.new_group([w * n_chol + c for w in range(n_walker)])
            if rank % n_chol == c:
                groups[WALKER_AXIS] = g
    if n_chol > 1:
        if n_walker == 1:
            groups[CHOL_AXIS] = dist.group.WORLD
        else:
            for w in range(n_walker):
                g = dist.new_group([w * n_chol + c for c in range(n_chol)])
                if rank // n_chol == w:
                    groups[CHOL_AXIS] = g
    device = _rank_device(device)
    if device.type == "cuda" and device.index is not None:
        # So that device="cuda" elsewhere (the drivers) means this card.
        torch.cuda.set_device(device)
    return Mesh(shape=(n_walker, n_chol),
                coords=(rank // n_chol, rank % n_chol), groups=groups,
                device=device)


def walker_mesh(device=None) -> Mesh:
    """1-D mesh over all ranks, axis 'walker' (the chol axis of size 1)."""
    return _build(dist.get_world_size() if dist.is_initialized() else 1, 1,
                  device)


def walker_chol_mesh(n_chol: int, device=None) -> Mesh:
    """2-D mesh [walker, chol] for memory-bound Generic runs: the X axis of
    the Cholesky tensors sharded over 'chol'. The world size must be a
    multiple of ``n_chol``."""
    nd = dist.get_world_size() if dist.is_initialized() else 1
    assert nd % n_chol == 0, f"{nd} devices not divisible by n_chol={n_chol}"
    return _build(nd // n_chol, n_chol, device)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _walker_slice(mesh: Mesh, n: int) -> slice:
    nl = n // mesh.nwalker
    c = mesh.coord(WALKER_AXIS)
    return slice(c * nl, (c + 1) * nl)


def shard_walkers(state, mesh: Mesh):
    """Keep this rank's rows of every per-walker field (leading axis W);
    scalars such as ``total_weight`` stay whole. On a [walker, chol] mesh
    the back-propagation buffer ``configs`` [w, nhist, X] keeps this
    rank's X slice, as the step writes it. Registers ``mesh`` as the
    active mesh. W must be a multiple of the walker-axis size, as in the
    reference's even per-rank split."""
    nshard = mesh.nwalker
    fields = [(f.name, getattr(state, f.name))
              for f in dataclasses.fields(state)]
    lead = [x for _, x in fields
            if isinstance(x, torch.Tensor) and x.dim() >= 1]
    nw = lead[0].shape[0] if lead else 0
    if nw % nshard != 0:
        raise ValueError(
            f"walker count {nw} is not divisible by the "
            f"walker mesh size {nshard}; pick a multiple (the reference "
            "splits walkers evenly per rank the same way, afqmc.py:167-176)"
        )
    set_active_mesh(mesh)
    rows = _walker_slice(mesh, nw)
    kept = {name: x[rows].contiguous() for name, x in fields
            if isinstance(x, torch.Tensor) and x.dim() >= 1
            and x.shape[0] == nw}
    if mesh.nchol > 1 and getattr(state, "configs", None) is not None:
        kept["configs"] = _x_slice(mesh, kept["configs"], 2)
    return dataclasses.replace(state, **kept)


def _with_buffers(obj, **buffers):
    """A shallow copy of an ``nn.Module`` with some buffers replaced, or of
    a dataclass with some fields replaced (the original keeps its own)."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **buffers)
    new = copy.copy(obj)
    new._buffers = {**obj._buffers, **buffers}
    return new


def _x_slice(mesh: Mesh, x: torch.Tensor, axis: int) -> torch.Tensor:
    nx = x.shape[axis]
    if nx % mesh.nchol:
        raise ValueError(f"{nx} Cholesky vectors are not divisible by the "
                         f"chol mesh size {mesh.nchol}")
    nl = nx // mesh.nchol
    c = mesh.coord(CHOL_AXIS)
    return x.narrow(axis, c * nl, nl).contiguous()


def shard_generic(ham, trial, prop, mesh: Mesh):
    """Keep this rank's X slice of every Cholesky-indexed tensor of a
    Generic Hamiltonian, trial and propagator on a [walker, chol] mesh:
    chol [M, M, X] (the Hamiltonian's, and the propagator's inner one:
    the zero-temperature ``GenericContinuous`` or the thermal
    ``ThermalGenericInner``), rchol [(D,) X, n, M] (a multi-determinant
    trial's on its axis 1) and mf_shift [X]. The exchange supermatrix,
    which has no X axis, is dropped, so that the exchange too is a partial
    sum over the slice. The exact-ERI and PNO tensors have no X axis
    either and stay whole; the stochastic-RI energy and the sketched step
    need nothing more (their probes are drawn whole and sliced,
    :func:`draw_shared`). On a mesh without a chol axis everything stays
    whole."""
    if mesh.nchol == 1:
        return ham, trial, prop
    ham = _with_buffers(ham, chol=_x_slice(mesh, ham.chol, -1))
    upd = {}
    if getattr(trial, "rchola", None) is not None:
        x_axis = 0 if trial.rchola.dim() == 3 else 1   # MSD: [D, X, n, M]
        upd = dict(rchola=_x_slice(mesh, trial.rchola, x_axis),
                   rcholb=_x_slice(mesh, trial.rcholb, x_axis))
    for key in ("exx_supera", "exx_superb"):
        if getattr(trial, key, None) is not None:
            upd[key] = None
    if upd:
        trial = _with_buffers(trial, **upd)
    inner = prop.inner
    upd = {}
    if getattr(inner, "chol", None) is not None:
        upd["chol"] = _x_slice(mesh, inner.chol, -1)
    if getattr(inner, "mf_shift", None) is not None:
        upd["mf_shift"] = _x_slice(mesh, inner.mf_shift, 0)
    if upd:
        prop = dataclasses.replace(prop, inner=_with_buffers(inner, **upd))
    return ham, trial, prop


def replicate(tree, mesh: Mesh):
    """Every rank holds the whole of ``tree`` already: place it on the
    rank's device."""
    return tree.to(mesh.device) if hasattr(tree, "to") else tree


# ---------------------------------------------------------------------------
# Draws and collectives (no-ops without an active mesh)
# ---------------------------------------------------------------------------

def draw(fn, shape, walker_dim: int, chol_dim: int | None = None):
    """``fn(shape)`` for the whole population: the one-rank draw of the
    global shape (the walker dim times the walker size; with ``chol_dim``
    the X dim times the chol size), of which this rank keeps its rows and
    columns. Without an active mesh, ``fn(shape)``."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return fn(tuple(shape))
    full = list(shape)
    full[walker_dim] *= mesh.nwalker
    if chol_dim is not None:
        full[chol_dim] *= mesh.nchol
    x = fn(tuple(full))
    if mesh.nwalker > 1:
        x = x.narrow(walker_dim, mesh.coord(WALKER_AXIS) * shape[walker_dim],
                     shape[walker_dim])
    if chol_dim is not None and mesh.nchol > 1:
        x = x.narrow(chol_dim, mesh.coord(CHOL_AXIS) * shape[chol_dim],
                     shape[chol_dim])
    return x.contiguous()


def draw_shared(fn, shape, chol_dim: int | None = None):
    """``fn(shape)`` for a draw every walker shares: every rank draws the
    same whole tensor (with ``chol_dim``, the X dim times the chol size) and
    keeps its X slice on a [walker, chol] mesh. Without an active mesh, or
    without ``chol_dim``, ``fn(shape)``."""
    mesh = _ACTIVE_MESH
    if mesh is None or chol_dim is None or mesh.nchol == 1:
        return fn(tuple(shape))
    full = list(shape)
    full[chol_dim] *= mesh.nchol
    x = fn(tuple(full))
    return x.narrow(chol_dim, mesh.coord(CHOL_AXIS) * shape[chol_dim],
                    shape[chol_dim]).contiguous()


def chol_sharded() -> bool:
    """Whether the active mesh shards the Cholesky axis."""
    return _ACTIVE_MESH is not None and _ACTIVE_MESH.nchol > 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def walker_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the walker group (every rank gets it)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.groups[WALKER_AXIS] is None:
        return x
    return _all_reduce(x, mesh.groups[WALKER_AXIS])


def chol_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the partial sums ``x`` over the chol group."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.groups[CHOL_AXIS] is None:
        return x
    return _all_reduce(x, mesh.groups[CHOL_AXIS])


def gather_walkers(x: torch.Tensor) -> torch.Tensor:
    """The whole population's [W, ...] from every rank's [W / R, ...]."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.groups[WALKER_AXIS] is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.nwalker)]
    dist.all_gather(parts, x, group=mesh.groups[WALKER_AXIS])
    return torch.cat(parts)


def gather_chol(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole X axis (``dim``) from every chol rank's slice of it."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.groups[CHOL_AXIS] is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.nchol)]
    dist.all_gather(parts, x, group=mesh.groups[CHOL_AXIS])
    return torch.cat(parts, dim=dim)


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a whole-population tensor along ``dim``."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.nwalker == 1:
        return x
    rows = _walker_slice(mesh, x.shape[dim])
    return x.narrow(dim, rows.start, rows.stop - rows.start)


def exchange(tensors, parents: torch.Tensor, dim: int = 0):
    """Replace walker i of each tensor (walker axis ``dim``) by a copy of
    walker ``parents[i]``. With an active mesh ``parents`` [W] are the
    global parents of every slot of the walker group, which every rank
    computes alike; rows whose parent lives on this rank are gathered in
    place, the others come from their owners by one ``all_to_all_single``
    a tensor, with split sizes. Without one, a plain gather."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.groups[WALKER_AXIS] is None:
        return [x.index_select(dim, parents) for x in tensors]
    group = mesh.groups[WALKER_AXIS]
    r = mesh.nwalker
    me = mesh.coord(WALKER_AXIS)
    nl = parents.shape[0] // r
    owner = torch.div(parents, nl, rounding_mode="floor")
    dest = torch.arange(parents.shape[0], device=parents.device) // nl
    if not bool((owner != dest).any()):
        # No row crosses a rank (always so on one rank): every rank knows.
        local = parents[me * nl:(me + 1) * nl] - me * nl
        return [x.index_select(dim, local) for x in tensors]
    # Sent: this rank's rows that other ranks' slots need, in slot order
    # (so by destination rank).
    out_mask = (owner == me) & (dest != me)
    send_rows = parents[out_mask] - me * nl
    send_sizes = torch.bincount(dest[out_mask], minlength=r).tolist()
    mine = owner[me * nl:(me + 1) * nl]
    in_slots = torch.nonzero(mine != me).flatten()
    # Received: ordered by source rank, then by slot.
    in_slots = in_slots[torch.argsort(mine[in_slots] * nl + in_slots)]
    recv_sizes = torch.bincount(mine[in_slots], minlength=r).tolist()
    local = (parents[me * nl:(me + 1) * nl] - me * nl).clamp(0, nl - 1)
    out = []
    for x in tensors:
        # The gathered tensor keeps the input's layout (contiguous).
        y = x.index_select(dim, local)
        send = x.index_select(dim, send_rows).movedim(dim, 0).contiguous()
        recv = torch.empty((sum(recv_sizes),) + tuple(send.shape[1:]),
                           dtype=x.dtype, device=x.device)
        dist.all_to_all_single(recv, send, recv_sizes, send_sizes,
                               group=group)
        out.append(y.index_copy_(dim, in_slots, recv.movedim(0, dim)))
    return out
