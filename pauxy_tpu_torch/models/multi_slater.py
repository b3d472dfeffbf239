"""Multi-determinant (NOMSD / PHMSD) trial wavefunctions.

Counterpart of ``pauxy_tpu/models/multi_slater.py``. The determinant axis
is one more batched tensor dimension:

  S[w, d]      = phi^T conj(psi_d)       (batched product)
  logdet[w, d] (``ops/clinalg``: kernel B on the card)
  G_d[w, d]    per-determinant Green's functions
  <psi_T|phi>  = sum_d conj(c_d) det S_d  (log-sum-exp over d)
  G            = sum_d w_d G_d,  w_d = conj(c_d) det_d / sum_d' ...

The trial is built host-side (numpy; setup): the walkers' initial
determinant from the coefficient-weighted span of the determinants (seed 7),
the trial density matrix and energy at that walker, and for a Generic
system the per-determinant half-rotated tensors rchol_d = psi_d^H L and
rh1_d = psi_d^H H1 (complex, so the exchange takes the einsum route, as in
JAX). ``recompute_ci_coeffs`` rediagonalises H in the determinants' span.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.ops import clinalg
from pauxy_tpu_torch.ops.lanelinalg import cadd

# Per-determinant half-rotated tensors of a Generic system (None for
# lattice models): rchol_s [D, X, n_s, M], rh1_s [D, n_s, M].
GENERIC_BUFFERS = ("rchola", "rcholb", "rh1a", "rh1b")

# The log|det| given to an exactly singular S_d: its weight exp(-1e30) is 0.
SINGULAR_LOG = -1e30


class MultiSlaterTrial(nn.Module):
    """|psi_T> = sum_d c_d |psi^a_d> x |psi^b_d>. Buffers: ``psia``
    [D, M, na], ``psib`` [D, M, nb], ``coeffs`` [D], the walkers' initial
    determinant ``inita`` [M, na] / ``initb`` [M, nb], and the Generic
    tensors of ``GENERIC_BUFFERS`` or None. ``G_host`` [2, M, M] (numpy) is
    the det-weighted G at the initial walker, which the propagators' mean
    field shift reads."""

    def __init__(self, psia, psib, coeffs, inita, initb, *,
                 G_host: np.ndarray, etrial: float,
                 name: str = "multi_slater", **generic):
        super().__init__()
        unknown = set(generic) - set(GENERIC_BUFFERS)
        if unknown:
            raise TypeError(f"unknown trial tensors {sorted(unknown)}")
        self.register_buffer("psia", psia)
        self.register_buffer("psib", psib)
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("inita", inita)
        self.register_buffer("initb", initb)
        for key in GENERIC_BUFFERS:
            self.register_buffer(key, generic.get(key))
        self.G_host = G_host
        self.etrial = float(etrial)
        self.name = name

    @property
    def ndets(self) -> int:
        return self.psia.shape[0]

    @property
    def nup(self) -> int:
        return self.psia.shape[-1]

    @property
    def ndown(self) -> int:
        return self.psib.shape[-1]

    @property
    def nbasis(self) -> int:
        return self.psia.shape[1]


class MultiDetGreens(NamedTuple):
    G: torch.Tensor | None       # [w, 2, M, M] det-weighted G (or None)
    Gi: torch.Tensor | None      # [w, D, 2, M, M] per determinant (or None)
    det_weights: torch.Tensor    # [w, D] conj(c_d) det_d / sum
    log_ovlp: torch.Tensor       # [w] complex log <psi_T|phi>
    Ghalfa: torch.Tensor         # [w, D, na, M] per-det half-rotated G
    Ghalfb: torch.Tensor         # [w, D, nb, M]


def logsumexp_c(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log sum exp over ``dim`` of complex z, shifted by the largest real
    part only (as JAX's ``_logsumexp_c``)."""
    m = torch.amax(z.real, dim=dim, keepdim=True)
    ls = torch.log(torch.sum(torch.exp(z - m), dim=dim))
    return torch.complex(m.squeeze(dim) + ls.real, ls.imag)


def log_coeffs(trial) -> torch.Tensor:
    """log conj(c_d) [D]."""
    return torch.log(trial.coeffs.conj())


def _overlaps(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """S[w, d] = phi^T conj(psi_d), [w, D, n, n]."""
    return torch.einsum("wmi,dmj->wdij", phi, psi.conj())


def greens_function_multi_det(trial: MultiSlaterTrial, phia, phib,
                              want_g: bool = True) -> MultiDetGreens:
    """The batched multi-determinant Green's function. S_d^-1 and log det S_d
    come from one pass of kernel B. A walker orthogonal to a determinant
    (det S_d = 0) gets log|det| = -1e30 there (weight 0, its phase kept) and
    a zero half-rotated G_d, so inf * 0 never reaches the weighted sums.
    The full G and Gi are formed only with ``want_g``."""

    def spin_half(phi, psi):
        logdet, inv = clinalg.inv_logdet(_overlaps(phi, psi))
        singular = ~torch.isfinite(logdet.real)           # [w, D]
        ghalf = torch.matmul(inv, phi.transpose(-1, -2)[:, None])
        ghalf = torch.where(singular[..., None, None],
                            torch.zeros_like(ghalf), ghalf)
        logdet = torch.complex(
            torch.where(singular, torch.full_like(logdet.real,
                                                  SINGULAR_LOG),
                        logdet.real), logdet.imag)
        g = (torch.einsum("dmi,wdin->wdmn", psi.conj(), ghalf) if want_g
             else None)
        return g, ghalf, logdet.to(phi.dtype)

    ga, gha, la = spin_half(phia, trial.psia)
    gb, ghb, lb = spin_half(phib, trial.psib)
    logw = cadd(la, lb, log_coeffs(trial)[None, :])     # [w, D]
    log_ovlp = logsumexp_c(logw)
    w_d = torch.exp(logw - log_ovlp[:, None])
    gi = g = None
    if want_g:
        gi = torch.stack([ga, gb], dim=2)                  # [w, D, 2, M, M]
        g = torch.einsum("wd,wdsmn->wsmn", w_d, gi)
    return MultiDetGreens(G=g, Gi=gi, det_weights=w_d, log_ovlp=log_ovlp,
                          Ghalfa=gha, Ghalfb=ghb)


def log_overlap_multi_det(trial: MultiSlaterTrial, phia, phib
                          ) -> torch.Tensor:
    """log <psi_T|phi> [w]: the determinants' log-dets (kernel B, log-det
    only), a non-finite log|det| replaced by -1e30 (phase kept), then the
    log-sum-exp."""
    logw = cadd(clinalg.slogdet(_overlaps(phia, trial.psia)),
                clinalg.slogdet(_overlaps(phib, trial.psib)),
                log_coeffs(trial)[None, :])
    logw = torch.complex(
        torch.where(torch.isfinite(logw.real), logw.real,
                    torch.full_like(logw.real, SINGULAR_LOG)), logw.imag)
    return logsumexp_c(logw)


def _span_init(block: np.ndarray, n: int) -> np.ndarray:
    """The dominant subspace of the determinants' span [M, n]: a seeded
    random combination of all their columns, orthonormalised (an
    axis-aligned subspace can be exactly orthogonal to a determinant)."""
    cols = np.concatenate(list(block), axis=1)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((cols.shape[1], n))
    q, _ = np.linalg.qr(cols @ w)
    return q[:, :n]


def multi_slater_trial(ham, psi: np.ndarray, coeffs=None, init=None, *,
                       device=None, dtype=None) -> MultiSlaterTrial:
    """An NOMSD trial from psi [D, M, na + nb] and coefficients (all 1 by
    default). The walkers start from ``init`` [M, na + nb], else from the
    span of the determinants. ``etrial`` is the energy of the det-weighted
    G at that walker (0 where the system has no host energy)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    cplx = prec.np_cplx
    psi = np.asarray(psi).astype(cplx)
    d = psi.shape[0]
    na, nb = ham.nup, ham.ndown
    coeffs = np.asarray(np.ones(d) if coeffs is None else coeffs).astype(cplx)
    if init is None:
        init = np.concatenate([_span_init(psi[:, :, :na], na),
                               _span_init(psi[:, :, na:], nb)], axis=1)
    init = np.asarray(init).astype(cplx)
    psia, psib = psi[:, :, :na], psi[:, :, na:]

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    host = MultiSlaterTrial(dev(psia), dev(psib), dev(coeffs),
                            dev(init[:, :na]), dev(init[:, na:]),
                            G_host=None, etrial=0.0)
    g_host = greens_function_multi_det(host, host.inita[None],
                                       host.initb[None]).G[0].numpy()
    try:
        etrial = float(np.real(le.local_energy_G_host(ham, g_host)[0]))
    except NotImplementedError:
        etrial = 0.0
    generic = {}
    if getattr(ham, "chol", None) is not None:
        chol = ham.chol.cpu().numpy()                     # [M, M, X]
        h1 = ham.H1.cpu().numpy()
        generic = {
            "rchola": np.einsum("dpi,pmx->dxim", psia.conj(), chol,
                                optimize=True),
            "rcholb": np.einsum("dpi,pmx->dxim", psib.conj(), chol,
                                optimize=True),
            "rh1a": np.einsum("dpi,pm->dim", psia.conj(), h1[0],
                              optimize=True),
            "rh1b": np.einsum("dpi,pm->dim", psib.conj(), h1[1],
                              optimize=True)}
        generic = {k: dev(v.astype(cplx)).to(device)
                   for k, v in generic.items()}
    return MultiSlaterTrial(
        dev(psia).to(device), dev(psib).to(device), dev(coeffs).to(device),
        dev(init[:, :na]).to(device), dev(init[:, na:]).to(device),
        G_host=g_host, etrial=etrial, **generic)


def phmsd_trial(ham, coeffs, occa, occb, *, device=None, dtype=None
                ) -> MultiSlaterTrial:
    """Particle-hole MSD from occupation lists (a CI expansion in an
    orthogonal basis): each determinant is a column selection of the
    identity."""
    eye = np.eye(ham.nbasis)
    psis = [np.concatenate([eye[:, list(oa)], eye[:, list(ob)]], axis=1)
            for oa, ob in zip(occa, occb)]
    return multi_slater_trial(ham, np.stack(psis), np.asarray(coeffs),
                              device=device, dtype=dtype)


def recompute_ci_coeffs(ham, psi: np.ndarray = None, nup: int = None,
                        occa=None, occb=None):
    """Rediagonalise H in the span of the determinants (host-side).

    Orthogonal (PHMSD) expansions, given as ``occa`` / ``occb`` occupation
    lists, take Slater-Condon matrix elements; non-orthogonal ones, given as
    ``psi`` [D, M, ne], solve H_ij = ovlp_ij E_loc(G_ij), S_ij = ovlp_ij
    with pairs of overlap below 1e-12 dropped. Returns (coeffs [D], e0):
    the ground eigenvector and eigenvalue.
    """
    import scipy.linalg

    if occa is not None:
        from pauxy_tpu_torch.estimators.ci import fci_hamiltonian

        basis = list(zip([tuple(a) for a in occa], [tuple(b) for b in occb]))
        h, _ = fci_hamiltonian(ham, basis=basis)
        e, ev = scipy.linalg.eigh(h)
        return np.array(ev[:, 0], dtype=complex), float(e[0].real)

    psi = np.asarray(psi)
    d = psi.shape[0]
    h = np.zeros((d, d), dtype=complex)
    s = np.zeros((d, d), dtype=complex)
    for i in range(d):
        for j in range(i, d):
            dia, dib = psi[i][:, :nup], psi[i][:, nup:]
            dja, djb = psi[j][:, :nup], psi[j][:, nup:]
            oa = dia.conj().T @ dja
            ob = dib.conj().T @ djb
            ovlp = np.linalg.det(oa) * np.linalg.det(ob)
            if abs(ovlp) > 1e-12:
                ga = np.conj(dja @ np.linalg.solve(oa, dia.conj().T)).T
                gb = np.conj(djb @ np.linalg.solve(ob, dib.conj().T)).T
                etot = le.local_energy_G_host(ham, np.stack([ga, gb]))[0]
                h[i, j] = ovlp * etot
                s[i, j] = ovlp
                h[j, i] = np.conj(h[i, j])
                s[j, i] = np.conj(s[i, j])
    e, ev = scipy.linalg.eigh(h, s)
    return np.array(ev[:, 0], dtype=complex), float(e[0].real)
