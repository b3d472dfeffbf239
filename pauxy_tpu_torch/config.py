"""Precision bundle, device choice and the matmul-precision ladder.

Counterpart of ``pauxy_tpu/config.py``. ``"single"`` is float32/complex64,
``"double"`` float64/complex128. The H100 has native FP64, so double is a
production option here, not only a test setting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype bundle threaded through models, trials and propagators."""

    real: torch.dtype
    cplx: torch.dtype

    @property
    def name(self) -> str:
        return "double" if self.real == torch.float64 else "single"

    @property
    def np_real(self) -> np.dtype:
        return np.dtype(np.float64 if self.name == "double" else np.float32)

    @property
    def np_cplx(self) -> np.dtype:
        return np.dtype(np.complex128 if self.name == "double"
                        else np.complex64)


SINGLE = Precision(real=torch.float32, cplx=torch.complex64)
DOUBLE = Precision(real=torch.float64, cplx=torch.complex128)

_BY_NAME = {
    "single": SINGLE, "f32": SINGLE, "float32": SINGLE, "complex64": SINGLE,
    "double": DOUBLE, "f64": DOUBLE, "float64": DOUBLE, "complex128": DOUBLE,
}
_BY_DTYPE = {torch.float32: SINGLE, torch.complex64: SINGLE,
             torch.float64: DOUBLE, torch.complex128: DOUBLE}


def get_precision(dtype: str | torch.dtype | Precision | None = None
                  ) -> Precision:
    """Resolve a precision spec: a name, a torch dtype or a bundle.

    ``None`` is single precision, the production default.
    """
    if isinstance(dtype, Precision):
        return dtype
    if dtype is None:
        return SINGLE
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_DTYPE:
            raise ValueError(f"unsupported dtype {dtype}")
        return _BY_DTYPE[dtype]
    key = str(dtype).lower()
    if key not in _BY_NAME:
        raise ValueError(f"unknown precision: {dtype!r}")
    return _BY_NAME[key]


def real_dtype(cdtype: torch.dtype) -> torch.dtype:
    """float32 for complex64, float64 for complex128 (and for reals)."""
    return get_precision(cdtype).real


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device to build on. ``None`` means the CUDA card; without one it
    raises rather than choosing the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# The JAX package's ladder names and the torch rung each sets
# (pauxy_tpu/config.py's alias chains: "highest", "high", "default").
# "bfloat16_3x" keeps IEEE float32 in cuBLAS: on a card its float32 /
# complex64 products take the 3-pass split GEMM (SPLIT_TIER) instead.
MATMUL_TIERS = {"float32": "highest", "bfloat16_3x": "highest",
                "bfloat16": "medium"}
SPLIT_TIER = "bfloat16_3x"

# Open config.full_precision() bodies (the process's, like torch's rung).
_pins = 0


def _ladder_name(policy: str | None) -> str:
    if policy is None:
        policy = os.environ.get("PAUXY_TPU_MATMUL", "float32")
    if policy not in MATMUL_TIERS:
        raise ValueError(f"matmul_precision {policy!r}: want one of "
                         f"{sorted(MATMUL_TIERS)}")
    return policy


def matmul_tier(policy: str | None) -> str:
    """The torch rung of a ladder name. ``None`` reads ``PAUXY_TPU_MATMUL``
    (default ``"float32"``), as the JAX package does; a name off the
    ladder raises ``ValueError``."""
    return MATMUL_TIERS[_ladder_name(policy)]


def split_route(policy: str | None, device: str | torch.device) -> bool:
    """Whether the tier sends float32 / complex64 products on ``device``
    through the 3-pass bf16 split GEMM: ``"bfloat16_3x"`` on a CUDA device
    (a name off the ladder raises ``ValueError``)."""
    name = _ladder_name(policy)
    return name == SPLIT_TIER and torch.device(device).type == "cuda"


def set_matmul_precision(policy: str | None,
                         device: str | torch.device) -> str:
    """Set the ``matmul_precision`` tier for float32 / complex64 products
    on ``device``; returns the ladder name in force.

    * ``"float32"``     -> torch's ``"highest"``: IEEE float32 products
      (default);
    * ``"bfloat16_3x"`` -> ``"highest"`` and the split route
      (``ops/gemm3_cuda.install_route``): every aten mm / bmm / addmm /
      baddbmm of float32 or complex64 on the card launches the 3-pass bf16
      split GEMM (``csrc/gemm_bf16x3.cu``), XLA's ``BF16_BF16_F32_X3``
      that JAX's tier runs on the TPU (3 passes, ~3e-5 relative there);
      the product's relative error at the Generic VHS shape is
      ``chip_smoke.py`` phase 35 (a)'s reading;
    * ``"bfloat16"``    -> ``"medium"``: on an NVIDIA H100 80GB HBM3 at
      700 W (torch 2.11, CUDA 12.8) cuBLAS's single-pass TF32 mode
      (operands rounded to a 10-bit mantissa, float32 sums), complex64
      included: 2.8e-4 relative at [1024, 512] x [512, 128 * 128] against
      float64, above float32's 1.0e-6 and inside JAX's one bf16 pass
      (~5e-3), so the port keeps the more accurate rung.

    Any tier but ``"bfloat16_3x"`` removes the split route, so
    ``"float32"`` and ``"bfloat16"`` run torch's own kernels with no cost
    a call. The rung and the route are the process's: a card driver's
    lower tier also reaches the CPU float32 products of the same process
    (the route only the card's). On a CPU device nothing changes and
    ``"float32"`` comes back, as the JAX package's CPU backend answers:
    torch's ``"medium"`` would send CPU float32 products through oneDNN's
    bf16. A name off the ladder raises ``ValueError`` on either device.
    The hand-written kernels read neither, as JAX's ladder does not reach
    its Pallas bodies.
    """
    name = _ladder_name(policy)
    if torch.device(device).type == "cpu":
        return "float32"
    from pauxy_tpu_torch.ops import gemm3_cuda

    torch.set_float32_matmul_precision(MATMUL_TIERS[name])
    if split_route(name, device):
        gemm3_cuda.install_route()
    else:
        gemm3_cuda.remove_route()
    return name


def pinned() -> bool:
    """Whether a ``full_precision()`` body is open."""
    return _pins > 0


def _fp32_backends():
    """The per-backend float32 product settings that
    ``torch.set_float32_matmul_precision`` moves, where this torch has
    them (``"none"`` and ``"ieee"`` both mean IEEE float32)."""
    return [b for b in (torch.backends.cuda.matmul,
                        torch.backends.mkldnn.matmul)
            if hasattr(b, "fp32_precision")]


@contextlib.contextmanager
def full_precision():
    """IEEE float32 products in the body, whatever the tier: torch's rung
    ``"highest"`` and the split route passed by (its products go to
    cuBLAS); the rung and each backend's ``fp32_precision`` come back
    exactly as they were afterwards, also when the body raises.
    Torch's counterpart of JAX's per-product ``precision=HIGHEST``."""
    global _pins
    prev = torch.get_float32_matmul_precision()
    backends = [(b, b.fp32_precision) for b in _fp32_backends()]
    torch.set_float32_matmul_precision("highest")
    _pins += 1
    try:
        yield
    finally:
        _pins -= 1
        torch.set_float32_matmul_precision(prev)
        for backend, value in backends:
            backend.fp32_precision = value
