"""QMC drivers."""

from pauxy_tpu_torch.qmc.afqmc import AFQMC
from pauxy_tpu_torch.qmc.options import QMCOpts

__all__ = ["AFQMC", "QMCOpts"]
