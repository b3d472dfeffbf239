"""Peaks of one NVIDIA H100 (SXM, dense, 700 W) and the bound arithmetic.

The least time a piece of work can take is the larger of its operations
over the peak rate of the arithmetic that runs it and its bytes (each input
read once, each output written once) over the memory bandwidth; a
roofline share is that bound over the measured device time. The peaks are
those of NVIDIA's data sheet for the H100 SXM (dense, no sparsity); a
card set below 700 W runs slower, so its power limit is printed beside
every run's numbers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOAT32_SIMT = 67e12          # IEEE float32 outside the tensor cores
BF16_TENSOR = 989e12          # bf16 products, float32 sums
TF32_TENSOR = 495e12

# Peak of the float32 / complex64 products under each matmul tier of the
# port: "float32" is IEEE float32 (torch "highest"); "bfloat16_3x" runs
# three bf16 passes a product; "bfloat16" is cuBLAS TF32 on this card.
TIER_PEAK = {"float32": FLOAT32_SIMT, "bfloat16_3x": BF16_TENSOR / 3,
             "bfloat16": TF32_TENSOR}


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """max(ops / peak, bytes / bandwidth) in seconds."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def share_pct(bound: float, device_s: float):
    """100 bound / device time, or None where nothing was timed."""
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
