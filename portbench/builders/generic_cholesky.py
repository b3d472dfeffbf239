"""Builder of a Generic (Cholesky) configuration.

Draws the integrals on the card from the seed, as weights are drawn for a
model, and hands the same numbers to the program (``make_generic``,
``rhf_identity_trial``) and to the plain reference
(``reference/generic.py``). The draw, from the configuration's
``integrals`` group:

* one-body: a diagonal of ``occ_diag`` (evenly spaced, occupied orbitals)
  and ``virt_diag`` (the rest), so that the identity trial is the
  one-body part's ground state with a gap above orbital nup, plus a
  symmetric off-diagonal part of normal entries of scale ``offdiag``;
* two-body: naux Cholesky vectors L_x = c_x S_x, S_x symmetric with normal
  entries of variance 1 / M, c_x = ``chol_scale`` exp(-x / (naux
  ``chol_decay``)), so that (ik|jl) = sum_x L[i,k,x] L[j,l,x] is positive
  semidefinite by construction with a decaying spectrum.
"""

from __future__ import annotations

import math

import torch

from portbench import draws
from portbench.reference.generic import GenericModel


def draw_integrals(cfg: dict, seed: int, device):
    """(h1e [M, M], chol [M, M, X]) float32 on ``device``."""
    m, nx, nup = cfg["nmo"], cfg["naux"], cfg["nup"]
    p = cfg["integrals"]
    g = draws.generator(seed, "integrals", device)
    f32 = dict(dtype=torch.float32, device=device)
    diag = torch.cat([torch.linspace(*p["occ_diag"], nup, **f32),
                      torch.linspace(*p["virt_diag"], m - nup, **f32)])
    off = torch.randn((m, m), generator=g, **f32) * p["offdiag"]
    h1e = torch.diag(diag) + 0.5 * (off + off.T) * (
        1 - torch.eye(m, **f32))
    s = torch.randn((nx, m, m), generator=g, **f32) / math.sqrt(m)
    s = 0.5 * (s + s.transpose(1, 2)) * math.sqrt(2.0)
    c = p["chol_scale"] * torch.exp(
        -torch.arange(nx, **f32) / (nx * p["chol_decay"]))
    chol = (c[:, None, None] * s).permute(1, 2, 0).contiguous()
    return h1e, chol


class Built:
    """The program's system and trial, the ``AFQMC`` options, and what the
    reference needs."""

    def __init__(self, cfg, mix, seed, device, dtype):
        from pauxy_tpu_torch.models import make_generic, rhf_identity_trial

        self.h1e, self.chol = draw_integrals(cfg, seed, device)
        self.cfg, self.mix = cfg, mix
        self.nfields = cfg["naux"]
        self.ham = make_generic((cfg["nup"], cfg["ndown"]),
                                self.h1e.cpu().numpy(),
                                self.chol.cpu().numpy(), cfg["ecore"],
                                device=device, dtype=dtype)
        self.trial = rhf_identity_trial(self.ham, device=device, dtype=dtype)
        self.propagator_options = {
            "taylor_impl": mix["taylor_impl"],
            "matmul_precision": mix["matmul_precision"]}
        self.env = {}

    def reference(self, dtype):
        return GenericModel(self.h1e, self.chol, self.cfg["nup"],
                            self.cfg["ndown"], self.cfg["ecore"],
                            self.mix["dt"], dtype=dtype)


def build(cfg: dict, mix: dict, seed: int, device, dtype="single"):
    return Built(cfg, mix, seed, device, dtype)

