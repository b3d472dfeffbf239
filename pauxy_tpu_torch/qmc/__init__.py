"""QMC drivers."""

from pauxy_tpu_torch.qmc.afqmc import AFQMC
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

__all__ = ["AFQMC", "QMCOpts", "ThermalAFQMC"]
