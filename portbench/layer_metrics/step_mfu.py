"""step_mfu: the whole step's share of the card's peak, in percent: the
operations of the profiled blocks that the benchmark counts (every float32
/ complex64 aten product from its shapes, with the Taylor series by the
count that ``taylor_roofline``'s range records in place of the products
inside it) over the blocks' wall time at the matmul tier's peak. Work it
does not count (the exchange kernel, kernel B, the Cholesky QR, the FFTs,
elementwise work, and the Taylor kernel in a cell without
``taylor_roofline``) only lowers it."""

from portbench import roofline
from portbench.trace import gemm_count

RANGES = ()


def read(t):
    if t.wall_s <= 0:
        return None
    ops = sum(c[0] for g in t.gemm if "taylor" not in g["ranges"]
              for c in [gemm_count(g)] if c is not None)
    ops += t.counts.get("taylor", {}).get("ops", 0)
    if ops <= 0:
        return None
    return 100.0 * ops / (t.wall_s * roofline.TIER_PEAK[
        t.mix["matmul_precision"]])
