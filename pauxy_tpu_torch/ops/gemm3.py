"""The plain version of the 3-pass bf16 split GEMM (``ops/gemm3_cuda``,
``csrc/gemm_bf16x3.cu``): the port's ``'bfloat16_3x'`` matmul tier.

What XLA's ``BF16_BF16_F32_X3`` dot algorithm computes, which is what the
JAX package's ``'bfloat16_3x'`` tier runs on the TPU (``pauxy_tpu/config.py``
``set_matmul_precision``), in torch on any device: each float32 value x
split into x_hi = bf16_rn(x) and x_lo = bf16_rn(x - x_hi) (torch's cast
rounds to nearest even; x - x_hi is exact), and a real product as
a_hi b_lo + a_lo b_hi + a_hi b_hi, three float32 products of bf16 values
(each exact) under ``config.full_precision()`` (IEEE float32 and, on a
card, outside the split route). A complex64 product is the four real
products on the planes, Re = Ar Br - Ai Bi and Im = Ar Bi + Ai Br. The CPU
tests hold it against a numpy model of the algorithm, and ``chip_smoke.py``
phase 35 holds the kernel against it on the card; nothing on the card's
path calls it.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch import config

TYPES = (torch.float32, torch.complex64)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_hi, x_lo) of a float32 tensor, as float32 tensors of bf16 values."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    lo = (x - hi).to(torch.bfloat16).to(x.dtype)
    return hi, lo


def _real(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = split(a)
    bh, bl = split(b)
    with config.full_precision():
        return (torch.matmul(ah, bl) + torch.matmul(al, bh)
                + torch.matmul(ah, bh))


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (``torch.matmul``'s broadcasting) in three passes; float32 or
    complex64 operands of one type."""
    if a.dtype not in TYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm3: needs float32 or complex64 operands of one "
                        f"type, got {a.dtype} and {b.dtype}")
    if not a.is_complex():
        return _real(a, b)
    a, b = a.resolve_conj(), b.resolve_conj()
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(_real(ar, br) - _real(ai, bi),
                         _real(ar, bi) + _real(ai, br))


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha a @ b + beta c (c ignored when beta is 0, as torch's addmm
    ignores its input), the product in three passes."""
    out = product(a, b)
    if alpha != 1:
        out = alpha * out
    if c is not None and beta != 0:
        out = out + beta * c
    return out


# aten's forms.
mm = bmm = product


def addmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, beta=1,
          alpha=1) -> torch.Tensor:
    return gemm(a, b, c, alpha, beta)


baddbmm = addmm
