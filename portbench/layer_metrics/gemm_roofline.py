"""gemm_roofline: the float32 / complex64 matrix products' share of their
roofline, in percent: every aten mm / bmm / addmm / baddbmm of those types
in the profiled blocks (cuBLAS, or the split GEMM under "bfloat16_3x"),
each bounded from its recorded shapes at the matmul tier's peak, against
the device time of the kernels it launched."""

from portbench import roofline
from portbench.trace import gemm_count

RANGES = ()


def totals(t):
    """(bound seconds, device seconds) of the counted products."""
    pk = roofline.TIER_PEAK[t.mix["matmul_precision"]]
    bound = dev = 0.0
    for g in t.gemm:
        c = gemm_count(g)
        if c is None or g["device_s"] <= 0:
            continue
        bound += roofline.bound_s(c[0], c[1], pk)
        dev += g["device_s"]
    return bound, dev


def read(t):
    bound, dev = totals(t)
    return roofline.share_pct(bound, dev)
