"""Lattice and ab-initio models and trial wavefunctions."""

from pauxy_tpu_torch.models.generic import Generic, make_generic
from pauxy_tpu_torch.models.hubbard import Hubbard, make_hubbard
from pauxy_tpu_torch.models.thermal_trial import (OneBodyTrial,
                                                  make_one_body_trial)
from pauxy_tpu_torch.models.trial import (
    SingleDetTrial,
    free_electron_trial,
    rhf_identity_trial,
    trial_from_orbitals,
    uhf_trial,
)
from pauxy_tpu_torch.models.ueg import UEG, make_ueg

__all__ = ["Generic", "make_generic", "Hubbard", "make_hubbard",
           "SingleDetTrial", "free_electron_trial", "rhf_identity_trial",
           "trial_from_orbitals", "uhf_trial", "OneBodyTrial",
           "make_one_body_trial", "UEG", "make_ueg"]
