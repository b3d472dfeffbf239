"""Finite-temperature walker state: batched propagator stacks.

Counterpart of ``pauxy_tpu/walkers/thermal_state.py``. The per-walker stack
of binned B-matrix products is one tensor [w, nbins, 2, M, M]; the
within-bin left (trial) factors are deterministic and precomputed on the
trial (``models/thermal_trial.py``), so only the right (stochastic)
partial product is walker state. ``update_stack`` writes the active bin in
place (JAX's arrays are immutable; here the stack, the largest tensor of
the state, is not copied every slice).
"""

from __future__ import annotations

import dataclasses

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import thermal as th


@dataclasses.dataclass
class ThermalWalkerState:
    stack: torch.Tensor        # [w, nbins, 2, M, M] binned B products
    right: torch.Tensor        # [w, 2, M, M] partial product, active bin
    G: torch.Tensor            # [w, 2, M, M] current Green's function
    log_m0: torch.Tensor       # [w, 2] complex log det G per spin
    weight: torch.Tensor       # [w]
    unscaled_weight: torch.Tensor
    phase: torch.Tensor        # [w] complex
    total_weight: torch.Tensor  # []
    # Per-walker hybrid energy of the previous slice,
    # -(log oratio + cfb + cmf) / dt (the EHybrid column).
    hybrid_energy: torch.Tensor
    # Prefix-cached QDT fold over the finalized bins 0..block-1 of the
    # current beta sweep ([w, 2, M, M], [w, 2, M], [w, 2, M, M]): refreshed
    # once per bin entry instead of refolded every slice.
    pq: torch.Tensor
    pd: torch.Tensor
    pt: torch.Tensor

    @property
    def nwalkers(self) -> int:
        return self.stack.shape[0]

    @property
    def nbins(self) -> int:
        return self.stack.shape[1]

    @property
    def nbasis(self) -> int:
        return self.stack.shape[-1]


def greens_function(stack: torch.Tensor):
    """G = (1 + A)^-1 per spin from the stack, A = stack[nbins-1] ...
    stack[0], natural bin order. Returns (G [w, 2, M, M], log det G
    [w, 2]), the log-det from the QDT factors."""
    return th.greens_function_qdt_logdet(stack.transpose(1, 2))


def init_thermal_walkers(trial, nwalkers: int) -> ThermalWalkerState:
    """All stacks at the trial density matrix; weight 1."""
    m = trial.nbasis
    nbins = trial.nbins
    cdtype = trial.dmat.dtype
    rdtype = config.real_dtype(cdtype)
    dev = trial.dmat.device
    stack = trial.bin_full[None, None].expand(
        nwalkers, nbins, 2, m, m).contiguous()
    right = torch.eye(m, dtype=cdtype, device=dev).expand(
        nwalkers, 2, m, m).contiguous()
    g, log_m0 = greens_function(stack)
    pq, pd, pt = th.qdt_identity((nwalkers, 2), m, cdtype, dev)
    return ThermalWalkerState(
        stack=stack,
        right=right,
        G=g,
        log_m0=log_m0,
        weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        unscaled_weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        phase=torch.ones(nwalkers, dtype=cdtype, device=dev),
        total_weight=torch.tensor(float(nwalkers), dtype=rdtype, device=dev),
        hybrid_energy=torch.zeros(nwalkers, dtype=cdtype, device=dev),
        pq=pq, pd=pd, pt=pt,
    )


def update_stack(trial, state: ThermalWalkerState, b: torch.Tensor,
                 ts: int) -> ThermalWalkerState:
    """Push one slice propagator b [w, 2, M, M] at time slice ts:
    right <- b (counter == 0 ? I : right); stack[block] <- left_table[counter]
    @ right, written into ``state.stack`` in place."""
    ss = trial.stack_size
    block, counter = divmod(ts, ss)
    right = b if counter == 0 else torch.matmul(b, state.right)
    state.stack[:, block] = torch.matmul(trial.left_table[counter], right)
    return dataclasses.replace(state, right=right)
