"""Precision bundle, device choice and matmul precision.

Counterpart of ``pauxy_tpu/config.py``. ``"single"`` is float32/complex64,
``"double"`` float64/complex128. The H100 has native FP64, so double is a
production option here, not only a test setting.
"""

from __future__ import annotations

import dataclasses

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


def set_matmul_precision() -> None:
    """Keep float32 products in full float32: no TF32 in matmuls or cuDNN.

    Mirrors ``pauxy_tpu/config.set_matmul_precision``'s default tier: a
    lower tier is opened only after an end-to-end anchor validates it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
