"""Lattice models and trial wavefunctions."""

from pauxy_tpu_torch.models.hubbard import Hubbard, make_hubbard
from pauxy_tpu_torch.models.trial import (
    SingleDetTrial,
    free_electron_trial,
    trial_from_orbitals,
)

__all__ = ["Hubbard", "make_hubbard", "SingleDetTrial", "free_electron_trial",
           "trial_from_orbitals"]
