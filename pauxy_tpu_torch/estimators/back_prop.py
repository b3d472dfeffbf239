"""Back-propagated estimators.

Counterpart of ``pauxy_tpu/estimators/back_prop.py``. At a measurement the
trial determinant is propagated backwards through the stored
auxiliary-field history, batched over walkers (one pass of CholeskyQR
every ``nstblz`` steps, the Cholesky-inverse kernel on the card); the
back-propagated Green's function G = gab(phi_bp, phi_old)^T (kernel B's
inverse) gives weighted energies, the 1-RDM and optionally the full 2-RDM
and the EKT generalised Fock matrices.

Weight restoration (``restore_weights``):
  None      -> the phaseless weight
  'partial' -> weight x prod(phase factors)
  'full'    -> weight x prod(phase factors) / prod(cosine factors)

The optional 2-RDM tail is the full spin-summed 2-RDM (``two_rdm='full'``)
or, for the UEG, the structure factor S(k) blocks [2, 2, nq]
(``'structure_factor'``): by FFT correlations with the per-walker
back-propagated bra when the system has its cube maps, else by the gather
kernels on the back-propagated G.
"""

from __future__ import annotations

import numpy as np
import torch

from pauxy_tpu_torch.estimators import ekt as ekt_mod
from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.ops import clinalg, greens


def _apply_bh1_dagger(bh1, phia, phib):
    """phi <- BH1^H phi per spin; a [2, M] bh1 is diagonal."""
    if bh1.dim() == 2:
        return (bh1[0].conj()[None, :, None] * phia,
                bh1[1].conj()[None, :, None] * phib)
    return (torch.matmul(bh1[0].conj().transpose(-1, -2), phia),
            torch.matmul(bh1[1].conj().transpose(-1, -2), phib))


def trial_batch(trial, nw: int, dtype):
    """The trial determinant once per walker, [w, M, n] per spin."""
    phia = trial.psia[None].expand((nw,) + tuple(trial.psia.shape))
    phib = trial.psib[None].expand((nw,) + tuple(trial.psib.shape))
    return phia.to(dtype), phib.to(dtype)


def ortho_every(j: int, nstblz: int, phia, phib):
    """One CholeskyQR pass of both spins at slice j != 0 with
    j % nstblz == 0 (the Cholesky-inverse kernel on the card)."""
    if j != 0 and j % nstblz == 0:
        phia = clinalg.cholesky_qr(phia)[0]
        phib = clinalg.cholesky_qr(phib)[0]
    return phia, phib


def back_propagate_continuous(prop, trial, configs, nstblz: int):
    """phi_bp = prod_j B(x_j)^dagger psi_T over the stored fields
    ``configs`` [w, nbp, nfields] (most recent last, taken first), with
    B^dagger = BH1^H e^{VHS(y)} BH1^H and y the model's adjoint fields."""
    inner = prop.inner
    nw, nbp, _ = configs.shape
    phia, phib = trial_batch(trial, nw, configs.dtype)
    for j in range(nbp):
        x = configs[:, nbp - 1 - j]
        phia, phib = _apply_bh1_dagger(inner.BH1, phia, phib)
        phia, phib = inner.apply_vhs(phia, phib, inner.bp_dagger_fields(x))
        phia, phib = _apply_bh1_dagger(inner.BH1, phia, phib)
        phia, phib = ortho_every(j, nstblz, phia, phib)
    return phia, phib


def back_propagate_hirsch(prop, trial, configs, nstblz: int):
    """Discrete-HS back propagation, B(x)^dagger = BT2^H diag(auxf[x])^H
    BT2^H, with the integer fields stored in ``configs`` [w, nbp, M]."""
    nw, nbp, _ = configs.shape
    phia, phib = trial_batch(trial, nw, prop.BT2.dtype)
    for j in range(nbp):
        xi = configs[:, nbp - 1 - j].real.long()
        phia, phib = _apply_bh1_dagger(prop.BT2, phia, phib)
        phia = phia * prop.auxf[xi, 0].conj()[:, :, None]
        phib = phib * prop.auxf[xi, 1].conj()[:, :, None]
        phia, phib = _apply_bh1_dagger(prop.BT2, phia, phib)
        phia, phib = ortho_every(j, nstblz, phia, phib)
    return phia, phib


def bp_greens_function(phia_bp, phib_bp, phia_old, phib_old):
    """G_s = gab(phi_bp_s, phi_old_s)^T per walker."""
    return (greens.gab(phia_bp, phia_old).transpose(-1, -2),
            greens.gab(phib_bp, phib_old).transpose(-1, -2))


def bp_half_greens_function(phi_bp, phi_old):
    """Half factor gh [w, n, M] of the back-propagated G: with
    S = phi_bp^H phi_old, gh = S^-T phi_old^T, so G = conj(phi_bp) gh."""
    s = torch.matmul(phi_bp.conj().transpose(-1, -2), phi_old)
    return clinalg.solve(s.transpose(-1, -2), phi_old.transpose(-1, -2))


def _restore_ok(cos: torch.Tensor) -> torch.Tensor:
    """|cos| > 1e-300, JAX's guard: in float32 the bound rounds to 0, so
    there it reads |cos| > 0."""
    bound = 1e-300 if cos.dtype == torch.float64 else 0.0
    return cos.abs() > bound


def restored_weights(state, restore: str | None, weight_dtype):
    """Walker weights with the phase factors restored ('partial') and the
    cosine factors divided out ('full'); None keeps the weight."""
    w = state.weight.to(weight_dtype)
    if restore is None:
        return w
    ph = torch.prod(state.weight_fac, dim=-1)
    if restore == "full":
        cos = torch.prod(state.cos_fac, dim=-1)
        ok = _restore_ok(cos)
        safe = torch.where(ok, cos, torch.ones_like(cos))
        return torch.where(ok, w * ph / safe, torch.zeros_like(w))
    return w * ph


def bp_weights(state, restore_weights: str | None):
    """Back-propagation weights, of the phase factors' type."""
    return restored_weights(state, restore_weights, state.weight_fac.dtype)


def bp_two_rdm_size(ham, calc_two_rdm: str | None) -> int:
    """Flat length of the optional 2-RDM tail: 'structure_factor' ->
    [2, 2, nq] (UEG only), 'full' -> [M]^4."""
    if calc_two_rdm is None:
        return 0
    if calc_two_rdm == "structure_factor":
        if ham.name != "UEG":
            raise NotImplementedError("structure_factor 2-RDM is UEG-only")
        return 4 * ham.nq
    if calc_two_rdm == "full":
        return ham.nbasis ** 4
    raise NotImplementedError(f"unknown two_rdm mode {calc_two_rdm!r}")


def bp_acc_size(ham, calc_two_rdm: str | None, eval_ekt: bool) -> int:
    """Length of one split's accumulator: 4 sums, G [2, M, M], the 2-RDM
    tail and the two EKT Fock matrices."""
    m = ham.nbasis
    return (4 + 2 * m * m + bp_two_rdm_size(ham, calc_two_rdm)
            + (2 * m * m if eval_ekt else 0))


def _two_rdm_full(ga, gb, w):
    """Spin-summed 2-RDM <p+ q+ s r> = G(p,r,q,s), same-spin exchange
    included, summed over walkers with weights ``w``."""
    def pair(x, y, exchange):
        t = torch.einsum("w,wpr,wqs->prqs", w, x, y)
        if exchange:
            t = t - torch.einsum("w,wps,wqr->prqs", w, x, y)
        return t

    rdm = (pair(ga, ga, True) + pair(gb, gb, True)
           + pair(ga, gb, False) + pair(gb, ga, False))
    return rdm.reshape(-1)


def update(ham, trial, prop, state, energy_fn, *, nstblz: int,
           restore_weights: str | None, discrete: bool,
           eval_ekt: bool = False, nbp_len: int | None = None,
           calc_two_rdm: str | None = None) -> torch.Tensor:
    """One back-propagation measurement, the flat accumulator
    [e, e1b, e2b, denom, G (, 2-RDM) (, EKT 1p/1h Focks)] summed over
    walkers. ``nbp_len`` restricts it to the first stored fields (the
    multi-split schedule measures at several times through one buffer).
    On a [walker, chol] mesh the buffer holds this rank's X slice of the
    fields: the back propagation's VHS, the dense-G energy and the EKT
    Focks' two-body parts are summed over the chol group, so every chol
    rank returns the same accumulator."""
    bp_two_rdm_size(ham, calc_two_rdm)
    configs = state.configs
    if nbp_len is not None:
        configs = configs[:, :nbp_len]
    back = back_propagate_hirsch if discrete else back_propagate_continuous
    phia_bp, phib_bp = back(prop, trial, configs, nstblz)
    ga, gb = bp_greens_function(phia_bp, phib_bp, state.phia_old,
                                state.phib_old)
    w = bp_weights(state, restore_weights)
    if energy_fn is not None:
        etot, e1b, e2b = energy_fn(ga, gb)
    else:
        etot = e1b = e2b = torch.zeros_like(w)
    g = torch.stack([ga, gb], dim=1)                      # [w, 2, M, M]
    parts = [torch.stack([torch.sum(w * etot), torch.sum(w * e1b),
                          torch.sum(w * e2b), torch.sum(w)]),
             torch.einsum("w,wsmn->smn", w, g).reshape(-1)]
    if calc_two_rdm == "structure_factor":
        if getattr(ham, "gmap", None) is not None:
            factors = (
                (phia_bp, bp_half_greens_function(phia_bp, state.phia_old)),
                (phib_bp, bp_half_greens_function(phib_bp, state.phib_old)))
        else:
            factors = ((ga, None), (gb, None))
        sk = le.structure_factor_ueg(ham, factors)
        parts.append(torch.einsum("w,wabq->abq", w, sk).reshape(-1))
    elif calc_two_rdm is not None:
        parts.append(_two_rdm_full(ga, gb, w))
    if eval_ekt:
        m = ga.shape[-1]
        eye = torch.eye(m, dtype=ga.dtype, device=ga.device)
        pa = eye - ga.transpose(-1, -2)
        pb = eye - gb.transpose(-1, -2)
        f1p, f1h = ekt_mod.weighted_focks(ham.H1[0], ham.chol, pa, pb, w)
        parts.append(f1p.reshape(-1))
        parts.append(f1h.reshape(-1))
    return torch.cat(parts)


class BPReporter:
    """Host-side normalisation of the block-summed BP accumulators.

    With an ``output`` (an ``H5EstimatorHelper`` on the group
    ``back_propagated``) it pushes the reference's datasets
    ``energies_{s}``, ``denominator_{s}``, ``one_rdm_{s}`` (and
    ``two_rdm_{s}``, ``fock_1p_{s}``, ``fock_1h_{s}``) per split s; every
    block's values are also kept in ``rows`` (one dict per block)."""

    def __init__(self, output, nbp: int, eval_energy: bool, nsplit: int = 1,
                 two_rdm_shape=None):
        self.output = output
        self.nbp = nbp
        self.eval_energy = eval_energy
        self.nsplit = nsplit
        self.splits = [(i + 1) * (nbp // nsplit) for i in range(nsplit)]
        self.two_rdm_shape = two_rdm_shape
        self.rows: list[dict] = []

    def _push(self, data, name: str, row: dict):
        row[name] = np.asarray(data)
        if self.output is not None:
            self.output.push(data, name)

    def block_row(self, acc, nbasis: int):
        """Push one block; returns the last split's normalised energies."""
        acc = np.asarray(acc)
        per = acc.size // self.nsplit
        out = None
        row: dict = {}
        ng = 2 * nbasis * nbasis
        for k, s in enumerate(self.splits):
            a = acc[k * per:(k + 1) * per]
            denom = a[3]
            self._push(np.array([denom]), f"denominator_{s}", row)
            if self.eval_energy and abs(denom) > 0:
                self._push(a[:3] / denom, f"energies_{s}", row)
            self._push(a[4:4 + ng].reshape(2, nbasis, nbasis),
                       f"one_rdm_{s}", row)
            rest = a[4 + ng:]
            if self.two_rdm_shape is not None:
                n2 = int(np.prod(self.two_rdm_shape))
                self._push(rest[:n2].reshape(self.two_rdm_shape),
                           f"two_rdm_{s}", row)
                rest = rest[n2:]
            if rest.size == ng:
                nmm = nbasis * nbasis
                self._push(rest[:nmm].reshape(nbasis, nbasis),
                           f"fock_1p_{s}", row)
                self._push(rest[nmm:].reshape(nbasis, nbasis),
                           f"fock_1h_{s}", row)
            if s == self.splits[-1]:
                out = a[:3] / denom if abs(denom) > 0 else a[:3]
        if self.output is not None:
            self.output.increment()
        self.rows.append(row)
        return out
