"""Input-file driven calculation set-up.

Counterpart of ``pauxy_tpu/qmc/calc.py``, on the same JSON schema
(sections ``system|model``, ``qmc``, ``trial``, ``propagator``,
``estimates|estimators``, ``walkers``; ``docs/INPUT.md``): the string-keyed
factories build the port's system, trial and driver on ``device`` at
precision ``dtype`` (keyword-only everywhere; ``device=None`` is the
card). Every system and trial name the JAX factories know maps to the
port's builder; an unknown name raises ``NotImplementedError`` as in JAX.

Two differences, both additions: the zero-temperature driver also takes
the ``walkers`` section (checkpoint ``write_freq`` / ``write_file`` /
``read_file``), and the estimates file is named as the JAX driver names
it (``resolve_estimates_filename``), since the port's drivers write none
without a name.
"""

from __future__ import annotations

import json
import warnings

import numpy as np

from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils.io import (get_input_value,
                                      resolve_estimates_filename)


def get_system(model_opts: dict, *, device=None, dtype=None):
    """The system a ``system``/``model`` section names."""
    kw = dict(device=device, dtype=dtype)
    name = model_opts.get("name", "Generic")
    if name == "Hubbard":
        from pauxy_tpu_torch.models.hubbard import make_hubbard

        return make_hubbard(
            model_opts["nup"], model_opts["ndown"], model_opts["U"],
            model_opts["nx"], model_opts.get("ny", 1),
            t=model_opts.get("t", 1.0), ktwist=model_opts.get("ktwist"),
            xpbc=model_opts.get("xpbc", True),
            ypbc=model_opts.get("ypbc", True),
            symmetric=model_opts.get("symmetric", False),
            pinning_fields=model_opts.get("pinning_fields", False), **kw)
    if name == "HubbardHolstein":
        from pauxy_tpu_torch.models.hubbard_holstein import \
            make_hubbard_holstein

        return make_hubbard_holstein(
            model_opts["nup"], model_opts["ndown"], model_opts["U"],
            model_opts["nx"], model_opts.get("ny", 1),
            t=model_opts.get("t", 1.0), w0=model_opts.get("w0", 1.0),
            lmbda=model_opts.get("lambda", model_opts.get("lmbda", 0.5)),
            **kw)
    if name in ("PW_FFT", "UEG"):
        from pauxy_tpu_torch.models.pw_fft import make_pw_fft
        from pauxy_tpu_torch.models.ueg import make_ueg

        make = make_pw_fft if name == "PW_FFT" else make_ueg
        return make(model_opts["nup"], model_opts["ndown"], model_opts["rs"],
                    model_opts["ecut"], ktwist=model_opts.get("ktwist"), **kw)
    if name == "Generic":
        from pauxy_tpu_torch.models.generic import from_qmcpack_file

        integrals = get_input_value(model_opts, "integrals", default=None,
                                    alias=["integral_file"])
        if integrals is None:
            raise ValueError("Generic system needs an 'integrals' file")
        nelec = None
        if "nup" in model_opts:
            nelec = (model_opts["nup"], model_opts["ndown"])
        # The local-energy variant flags (systems/generic.py:74-123).
        return from_qmcpack_file(
            integrals, nelec=nelec,
            exact_eri=bool(model_opts.get("exact_eri", False)),
            stochastic_ri=bool(model_opts.get("stochastic_ri", False)),
            nsamples=int(model_opts.get("nsamples", 0)),
            control_variate=bool(model_opts.get("control_variate", False)),
            pno=bool(model_opts.get("pno", False)),
            thresh_pno=float(model_opts.get("thresh_pno", 0.0) or 0.0),
            **kw)
    raise NotImplementedError(f"unknown system {name!r}")


def get_trial_wavefunction(ham, trial_opts: dict, seed=None, *, device=None,
                           dtype=None):
    """The zero-temperature trial a ``trial`` section names, with the
    optional spin projection of the walkers' initial determinant."""
    from pauxy_tpu_torch.models import trial as tr

    trial = _build_trial(ham, trial_opts, seed, device=device, dtype=dtype)
    if trial_opts.get("spin_proj", trial_opts.get("spin_project")):
        trial, _ = tr.spin_project_init(
            ham, trial, init_walker=trial_opts.get(
                "init_walker", trial_opts.get("initial_walker")))
    return trial


def _build_trial(ham, trial_opts: dict, seed=None, *, device=None,
                 dtype=None):
    from pauxy_tpu_torch.models import trial as tr

    kw = dict(device=device, dtype=dtype)
    name = trial_opts.get("name", "MultiSlater").lower()
    if name == "free_electron":
        return tr.free_electron_trial(ham, **kw)
    if name == "uhf":
        return tr.uhf_trial(
            ham, ueff=trial_opts.get("ueff", 0.4),
            ninitial=trial_opts.get("ninitial", 10),
            nconv=trial_opts.get("nconv", 5000),
            alpha=trial_opts.get("alpha", 0.5),
            deps=trial_opts.get("deps", 1e-8), seed=seed, **kw)
    if name == "coherent_state":
        if trial_opts.get("symmetrize", False):
            # The translation-symmetrised multi-coherent expansion.
            from pauxy_tpu_torch.models.multi_coherent import \
                multi_coherent_trial

            return multi_coherent_trial(ham, **kw)
        from pauxy_tpu_torch.models.hubbard_holstein import \
            coherent_state_trial

        return coherent_state_trial(ham, **kw)
    if name == "lang_firsov":
        from pauxy_tpu_torch.models.hubbard_holstein import lang_firsov_trial

        trial, _gamma = lang_firsov_trial(
            ham, relax_gamma=trial_opts.get("relax_gamma", False),
            restricted=trial_opts.get("restricted", False), **kw)
        return trial
    if name == "phmsd":
        from pauxy_tpu_torch.models.multi_slater import phmsd_trial

        return phmsd_trial(ham, trial_opts["coefficients"],
                           trial_opts["occa"], trial_opts["occb"], **kw)
    if name in ("hartree_fock", "multislater"):
        filename = trial_opts.get("filename")
        exc = trial_opts.get("excitation", trial_opts.get("excite_ia"))
        if filename is not None:
            if exc is not None:
                raise NotImplementedError(
                    "trial.excitation with a wavefunction file is not "
                    "supported; apply the excitation when writing the file")
            from pauxy_tpu_torch.utils import wavefunction as wio

            return wio.read_wavefunction(ham, filename, **kw)
        if exc is not None:
            # "Promotion energy" excitation in the (energy-ordered) MO
            # basis: occupied alpha orbital i replaced by virtual a
            # (hartree_fock.py:57-77; alpha spin only, as the reference).
            i, a = int(exc[0]), int(exc[1])
            m, na, nb = ham.nbasis, ham.nup, ham.ndown
            if not (0 <= i < na and na <= a < m):
                raise ValueError(
                    f"trial.excitation=[{i}, {a}]: i must be an occupied "
                    f"alpha MO (0..{na - 1}) and a a virtual MO "
                    f"({na}..{m - 1}); beta excitations are not supported "
                    "(matching the reference, hartree_fock.py:57-59)")
            psi = np.zeros((m, na + nb), dtype=np.complex128)
            psi[:na, :na] = np.eye(na)
            psi[:nb, na:] = np.eye(nb)
            psi[:, i] = 0.0
            psi[a, i] = 1.0
            return tr.trial_from_orbitals(ham, psi, name="hartree_fock",
                                          **kw)
        return tr.rhf_identity_trial(ham, **kw)
    if name == "multi_determinant":
        # A GHF expansion from the reference's ascii files
        # (trial_wavefunction/multi_determinant.py:27-34).
        from pauxy_tpu_torch.models.ghf import ghf_trial_from_files

        return ghf_trial_from_files(
            ham, orbital_file=trial_opts["orbitals"],
            coeffs_file=trial_opts["coefficients"],
            ndets=int(trial_opts["ndets"]), **kw)
    raise NotImplementedError(f"unknown trial {name!r}")


def _thermal_trial(ham, qmc: QMCOpts, topts: dict, verbose: bool, *, device,
                   dtype):
    """The finite-temperature trial: ``one_body`` (default) or
    ``mean_field`` (thermal Hartree-Fock). It bisects its own mu unless
    the trial section gives one."""
    from pauxy_tpu_torch.models import thermal_trial as tt

    kw = dict(device=device, dtype=dtype)
    if topts.get("spin_proj", topts.get("spin_project")):
        warnings.warn(
            "trial.spin_proj applies to zero-temperature trials only; "
            "ignored for finite-temperature (qmc.beta) runs", stacklevel=3)
    tname = str(topts.get("name", "one_body")).lower()
    if tname in ("mean_field", "thermal_hartree_fock"):
        return tt.make_mean_field_trial(
            ham, qmc.beta, qmc.dt, mu=topts.get("mu"),
            find_mu=bool(topts.get("find_mu", True)), nav=topts.get("nav"),
            stack_size=topts.get("stack_size"),
            alpha=float(topts.get("alpha", 0.75)), verbose=verbose, **kw)
    if tname == "one_body":
        return tt.make_one_body_trial(
            ham, qmc.beta, qmc.dt, mu=topts.get("mu"), nav=topts.get("nav"),
            stack_size=topts.get("stack_size"), **kw)
    raise ValueError(f"unknown thermal trial name {tname!r}; "
                     "expected 'one_body' or 'mean_field'")


def get_driver(options: dict, verbose: bool = False, *, device=None,
               dtype=None):
    """The driver: ``ThermalAFQMC`` when ``qmc.beta`` is set, else
    ``AFQMC`` (calc.py:42-55)."""
    kw = dict(device=device, dtype=dtype)
    model = options.get("model", options.get("system", {}))
    qmc = QMCOpts.from_dict(options.get("qmc", {}), verbose=verbose)
    ham = get_system(model, **kw)
    if qmc.scaled_temp:
        # theta = T/T_F input (UEG): beta and dt in Hartree units.
        qmc.convert_from_reduced_units(ham, verbose=verbose)
    est = options.get("estimates", options.get("estimators", {})) or {}
    popts = options.get("propagator", options.get("propagators", {})) or {}
    wopts = options.get("walkers", {}) or {}
    topts = options.get("trial", {}) or {}
    filename = resolve_estimates_filename(est)
    if qmc.beta is not None:
        from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

        trial = _thermal_trial(ham, qmc, topts, verbose, **kw)
        # The model section's mu is the system's chemical potential: it
        # goes to the propagator (onebody.py:50, planewave.py:106).
        popts = dict(popts)
        if model.get("mu") is not None:
            popts.setdefault("mu", model["mu"])
        return ThermalAFQMC(ham, trial, qmc, propagator_options=popts,
                            estimator_options=est, walker_options=wopts,
                            verbose=verbose, filename=filename,
                            device=device)
    from pauxy_tpu_torch.qmc.afqmc import AFQMC

    trial = get_trial_wavefunction(ham, topts, seed=qmc.rng_seed, **kw)
    return AFQMC(ham, trial, qmc, propagator_options=popts,
                 estimator_options=est, verbose=verbose, filename=filename,
                 walker_options=wopts, device=device)


def setup_calculation(input_options, *, device=None, dtype=None):
    """input.json path or dict -> driver (calc.py:33-41)."""
    if isinstance(input_options, str):
        with open(input_options) as f:
            options = json.load(f)
    else:
        options = dict(input_options)
    verbose = options.get("verbosity", options.get("verbose", 1))
    return get_driver(options, verbose=bool(verbose), device=device,
                      dtype=dtype)
