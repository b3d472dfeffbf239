"""Walker state and population control."""

from pauxy_tpu_torch.walkers.state import WalkerState, init_walkers

__all__ = ["WalkerState", "init_walkers"]
