"""Population control as parent indices for a gather.

Counterpart of ``comb_parents`` and ``pair_branch_parents`` in
``pauxy_tpu/walkers/pop_control.py``. Each returns a parent slot per walker;
the caller gathers every per-walker tensor with it. The uniforms are drawn
from ``generator`` unless given (tests inject the JAX draws).
"""

from __future__ import annotations

import torch

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
