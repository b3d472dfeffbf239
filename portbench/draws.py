"""Seeded draws: every input of a run follows from ``--seed``.

Each use of randomness has a tag (the integrals, a warm-up block, a window
block, the check's sample), and its generator's seed is a hash of the run's
seed and the tag, so that the same seed gives the same inputs whatever else
the run does, and any whole number is a seed.
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tag) -> int:
    """A 63-bit seed from the run's seed and a tag."""
    text = ":".join(str(t) for t in (seed, *tag)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(seed: int, tag, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


class BlockDraws:
    """A block's draws on the card: the fields xi [nsteps, w, F] ~ N(0, 1)
    and the comb's uniforms [nsteps, 1], from the generator of
    (seed, tag, block), made in two calls."""

    def __init__(self, seed: int, nsteps: int, nwalkers: int, nfields: int,
                 device):
        self.seed, self.device = seed, device
        self.shape = (nsteps, nwalkers, nfields)
        self.gen = torch.Generator(device=device)

    def block(self, tag: str, index: int):
        from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

        self.gen.manual_seed(derive(self.seed, tag, index))
        xi = torch.randn(self.shape, generator=self.gen,
                         dtype=torch.float32, device=self.device)
        pop = torch.rand((self.shape[0], 1), generator=self.gen,
                         dtype=torch.float32, device=self.device)
        return BlockNoise(xi, pop)
