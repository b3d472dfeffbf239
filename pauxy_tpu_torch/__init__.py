"""PyTorch/CUDA port of pauxy-tpu's AFQMC: at zero temperature the Hubbard
continuous and discrete paths, the Generic (Cholesky ab-initio) path and
the plane-wave electron gas (UEG and PW_FFT), phaseless, local-energy or
free-projection, with the mixed, back-propagated (with EKT or the UEG
structure factor), and ITCF estimators; at finite temperature the Hubbard,
Generic and UEG paths on the full-rank or low-rank QDT stack
(``qmc.ThermalAFQMC``).

The JAX package ``pauxy_tpu`` stays the reference; this package mirrors its
module paths (``models/hubbard.py`` here is ``pauxy_tpu/models/hubbard.py``
there) and never imports jax. Plain tensor code is PyTorch; the Pallas
kernels on these paths are CUDA C++ kernels for Hopper (``csrc/``), each
with a plain PyTorch version beside it for CPU tensors.

Entry point::

    from pauxy_tpu_torch.models import make_hubbard, free_electron_trial
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda", dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    rows = AFQMC(ham, trial, QMCOpts(nwalkers=1024, dt=0.01), device="cuda").run()
"""
