"""Lattice and ab-initio models and trial wavefunctions."""

from pauxy_tpu_torch.models.generic import Generic, make_generic
from pauxy_tpu_torch.models.ghf import (GHFTrial, ghf_trial_from_uhf,
                                        make_ghf_trial)
from pauxy_tpu_torch.models.hubbard import Hubbard, make_hubbard
from pauxy_tpu_torch.models.hubbard_holstein import (HubbardHolstein,
                                                     coherent_state_trial,
                                                     lang_firsov_trial,
                                                     make_hubbard_holstein)
from pauxy_tpu_torch.models.multi_coherent import (MultiCoherentTrial,
                                                   multi_coherent_trial)
from pauxy_tpu_torch.models.multi_slater import (MultiSlaterTrial,
                                                 multi_slater_trial,
                                                 phmsd_trial)
from pauxy_tpu_torch.models.pw_fft import PWFFT, make_pw_fft
from pauxy_tpu_torch.models.thermal_trial import (OneBodyTrial,
                                                  make_mean_field_trial,
                                                  make_one_body_trial)
from pauxy_tpu_torch.models.trial import (
    SingleDetTrial,
    free_electron_trial,
    rhf_identity_trial,
    spin_project_init,
    trial_from_orbitals,
    uhf_trial,
)
from pauxy_tpu_torch.models.ueg import UEG, make_ueg

__all__ = ["Generic", "make_generic", "Hubbard", "make_hubbard",
           "SingleDetTrial", "free_electron_trial", "rhf_identity_trial",
           "spin_project_init", "trial_from_orbitals", "uhf_trial",
           "OneBodyTrial", "make_one_body_trial", "make_mean_field_trial",
           "UEG", "make_ueg", "PWFFT", "make_pw_fft", "MultiSlaterTrial",
           "multi_slater_trial", "phmsd_trial", "GHFTrial", "make_ghf_trial",
           "ghf_trial_from_uhf", "HubbardHolstein", "make_hubbard_holstein",
           "coherent_state_trial", "lang_firsov_trial", "MultiCoherentTrial",
           "multi_coherent_trial"]
