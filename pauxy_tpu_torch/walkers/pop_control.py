"""Population control as parent indices for a gather.

Counterpart of ``pauxy_tpu/walkers/pop_control.py``. ``comb_parents`` and
``pair_branch_parents`` return a parent slot per walker; ``comb``,
``pair_branch`` and ``pop_control`` gather every per-walker field of a
[w, ...] ``WalkerState`` with it (the lanes block gathers its own layout).
The uniforms are drawn from ``generator`` unless given (tests inject the
JAX draws).

On a walker mesh (``parallel/mesh``) every rank gathers the W weights,
computes the same global parents from the same uniforms and keeps its
slots' new weights; ``mesh.exchange`` then moves only the rows whose parent
lives on another rank.
"""

from __future__ import annotations

import dataclasses

import torch

from pauxy_tpu_torch.parallel import mesh as pmesh

# Pair-branch thresholds on the rescaled weights (the reference's defaults).
MIN_WEIGHT = 0.1
MAX_WEIGHT = 4.0


def comb_parents(weight: torch.Tensor, target_weight: float,
                 uniform: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
    """Systematic (comb) resampling: (parents [w] long, total weight []).

    Teeth at (i + r) * target/nw against the cumulative rescaled weights;
    an all-dead population stays dead (parents = identity).
    """
    nw = weight.shape[0]
    w = weight.abs()
    total = w.sum()
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    cum = torch.cumsum(w * (target_weight / safe_total), dim=0)
    if uniform is None:
        uniform = torch.rand((), generator=generator, dtype=w.dtype,
                             device=w.device)
    idx = torch.arange(nw, device=w.device)
    teeth = (idx.to(w.dtype) + uniform) * (target_weight / nw)
    parents = torch.searchsorted(cum, teeth, right=True).clamp(0, nw - 1)
    return torch.where(total > 0, parents, idx), total


def pair_branch_parents(weight: torch.Tensor, target_weight: float,
                        uniforms: torch.Tensor | None = None,
                        generator: torch.Generator | None = None):
    """Pair-branch population control: (parents [w], new weights [w],
    total []). Walkers sorted by weight (stable) pair smallest with
    largest; a contiguous head of pairs with small < MIN_WEIGHT or
    large > MAX_WEIGHT branches, the survivor chosen with probability
    proportional to its weight, both copies getting half the pair weight.
    ``uniforms`` holds one draw per pair (nw // 2)."""
    nw = weight.shape[0]
    w = weight.abs()
    total = w.sum()
    wsc = w * (target_weight / torch.where(total > 0, total,
                                           torch.ones_like(total)))
    order = torch.argsort(wsc, stable=True)
    ws = wsc[order]
    half = nw // 2
    small = ws[:half]
    large = ws.flip(0)[:half]
    pair_w = small + large
    want = (small < MIN_WEIGHT) | (large > MAX_WEIGHT)
    active = torch.cumprod(want.to(torch.int32), dim=0).bool()
    if uniforms is None:
        uniforms = torch.rand(half, generator=generator, dtype=w.dtype,
                              device=w.device)
    clone_large = uniforms < large / torch.where(pair_w > 0, pair_w,
                                                 torch.ones_like(pair_w))
    small_idx = order[:half]
    large_idx = order.flip(0)[:half]
    # In place on fresh tensors: slot i keeps itself unless it lost the
    # lottery of its pair.
    parents = torch.arange(nw, device=w.device)
    parents[small_idx] = torch.where(active & clone_large, large_idx,
                                     small_idx)
    parents[large_idx] = torch.where(active & ~clone_large, small_idx,
                                     large_idx)
    new_w = wsc.clone()
    new_w[small_idx] = torch.where(active, 0.5 * pair_w, small)
    new_w[large_idx] = torch.where(active, 0.5 * pair_w, large)
    return parents, new_w, total


def _gather_walkers(state, parents: torch.Tensor):
    """Replace walker i by a copy of walker parents[i]: every field whose
    leading axis is the walker axis moves with its parent; scalars such as
    total_weight stay (weights are the caller's). On a mesh ``parents``
    are the global [W] parents (``mesh.exchange``)."""
    nw = state.weight.shape[0]
    names = [f.name for f in dataclasses.fields(state)
             if isinstance(getattr(state, f.name), torch.Tensor)
             and getattr(state, f.name).dim() >= 1
             and getattr(state, f.name).shape[0] == nw]
    moved = pmesh.exchange([getattr(state, n) for n in names], parents)
    return dataclasses.replace(state, **dict(zip(names, moved)))


def global_parents(weight: torch.Tensor, target_weight: float,
                   method: str, uniforms: torch.Tensor | None = None,
                   generator: torch.Generator | None = None):
    """(parents [W] global, this rank's new weights, total weight []) of
    the whole population (the walker group's on a mesh; the local
    population without one). ``uniforms``: one draw for comb, W // 2 for
    pair_branch."""
    w_all = pmesh.gather_walkers(weight)
    if method == "comb":
        parents, total = comb_parents(
            w_all, target_weight,
            None if uniforms is None else uniforms.reshape(()), generator)
        # A dead population stays dead.
        new_w = (total > 0).to(weight.dtype) * torch.ones_like(weight)
        return parents, new_w, total
    if method == "pair_branch":
        parents, new_w, total = pair_branch_parents(w_all, target_weight,
                                                    uniforms, generator)
        return parents, pmesh.local_rows(new_w), total
    raise ValueError(f"unknown population control method {method!r}")


def comb(state, target_weight: float, uniform: torch.Tensor | None = None,
         generator: torch.Generator | None = None):
    """Comb resampling of the population; weights reset to 1 (0 if the
    whole population is dead), the old ones kept in unscaled_weight."""
    return pop_control(state, target_weight, "comb", uniform, generator)


def pair_branch(state, target_weight: float,
                uniforms: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """Pair-branch population control of the population."""
    return pop_control(state, target_weight, "pair_branch", uniforms,
                       generator)


def pop_control(state, target_weight: float, method: str = "comb",
                uniforms: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """``uniforms``: one draw for comb, nw // 2 for pair_branch."""
    parents, new_w, total = global_parents(state.weight, target_weight,
                                           method, uniforms, generator)
    new = _gather_walkers(state, parents)
    return dataclasses.replace(new, weight=new_w,
                               unscaled_weight=state.weight,
                               total_weight=total)
