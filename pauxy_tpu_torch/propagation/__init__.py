"""Propagators."""

from pauxy_tpu_torch.propagation.hirsch_dmc import (DMCDraws, HirschDMC,
                                                    make_hirsch_dmc)

__all__ = ["DMCDraws", "HirschDMC", "make_hirsch_dmc"]
