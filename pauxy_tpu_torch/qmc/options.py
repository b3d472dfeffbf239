"""QMC run options (counterpart of ``pauxy_tpu/qmc/options.py``).

Same JSON keys, aliases and defaults, so input files carry over; ``beta``
(and ``beta_scaled``, with ``scaled_temperature``) are the
finite-temperature options.
"""

from __future__ import annotations

import dataclasses

from pauxy_tpu_torch.utils.io import get_input_value


@dataclasses.dataclass
class QMCOpts:
    nwalkers: int = 10
    dt: float = 0.005
    nsteps: int = 10
    nblocks: int = 1000
    nstblz: int = 10
    npop_control: int = 1
    eqlb_time: float = 2.0
    beta: float | None = None
    rng_seed: int | None = None
    pop_control_method: str = "comb"
    scaled_temp: bool = False
    beta_scaled: float | None = None

    @property
    def total_steps(self) -> int:
        return self.nsteps * self.nblocks

    @property
    def neqlb(self) -> int:
        return int(self.eqlb_time / self.dt)

    def convert_from_reduced_units(self, system, verbose: bool = False):
        """theta = T/T_F reduced units -> Hartree: beta and dt are given in
        units of the inverse Fermi temperature."""
        tf = system.ef
        self.beta_scaled = self.beta
        self.dt = self.dt / tf
        self.beta = self.beta / tf
        if verbose:
            print(f"# beta in Hartree^-1:  {self.beta:13.8e}")
            print(f"# dt in Hartree^-1: {self.dt:13.8e}")

    @classmethod
    def from_dict(cls, inputs: dict, verbose: bool = False) -> "QMCOpts":
        def get(key, default, alias=None):
            return get_input_value(inputs, key, default=default, alias=alias,
                                   verbose=verbose)

        return cls(
            nwalkers=get("num_walkers", 10, ["nwalkers"]),
            dt=get("timestep", 0.005, ["dt"]),
            nsteps=get("num_steps", 10, ["nsteps", "steps"]),
            nblocks=get("blocks", 1000, ["num_blocks", "nblocks"]),
            nstblz=get("stabilise_freq", 10, ["nstabilise", "reortho"]),
            npop_control=get("pop_control_freq", 1,
                             ["npop_control", "pop_control"]),
            eqlb_time=get("equilibration_time", 2.0, ["tau_eqlb"]),
            beta=get("beta", None),
            rng_seed=get("rng_seed", None, ["random_seed", "seed"]),
            pop_control_method=get("pop_control_method", "comb"),
            scaled_temp=get("scaled_temperature", False,
                            ["reduced_temperature"]),
        )
