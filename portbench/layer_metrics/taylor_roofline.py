"""taylor_roofline: the exp(VHS) phi Taylor series' share of its roofline,
in percent, on whatever route runs it (``propagation/generic.taylor_series``
as bound in ``generic`` and in ``planewave``).

The count is the series', whatever implements it: order k products of
V [w, M, M] with a [w, M, C] block, 8 real operations a complex
multiply-add, so 8 k M^2 C w operations; V read once and the block read and
written once, 8 bytes a complex64 element. The peak is the arithmetic of
the route: the float32 kernel and the plain series past its cap run IEEE
float32 (67 TFLOP/s); the bf16 kernel bf16 products; the "xla" series
takes the matmul tier's products.
"""

from portbench import roofline

ENTRY = "taylor_series"


def count(vhs_shape, phi_shape, order: int, itemsize: int = 8):
    """(operations, bytes) of one series application."""
    w, m, _ = vhs_shape
    c = phi_shape[-1]
    ops = 8 * order * m * m * c * w
    nbytes = itemsize * (w * m * m + 2 * w * m * c)
    return ops, nbytes


def peak(route: str, tier: str) -> float:
    if route == "pallas":
        return roofline.FLOAT32_SIMT
    if route == "pallas_bf16":
        return roofline.BF16_TENSOR
    return roofline.TIER_PEAK[tier]


def hook(args, kwargs):
    vhs, phi = args[0], args[1]
    order = args[2] if len(args) > 2 else kwargs["order"]
    route = args[3] if len(args) > 3 else kwargs["taylor_impl"]
    ops, nbytes = count(tuple(vhs.shape), tuple(phi.shape), int(order),
                        vhs.element_size())
    return {"ops": ops, "bytes": nbytes, f"route.{route}": 1}


RANGES = (("pauxy_tpu_torch.propagation.generic", ENTRY, "taylor", hook),
          ("pauxy_tpu_torch.propagation.planewave", ENTRY, "taylor", hook))


def bound_s(t):
    """The profiled blocks' Taylor bound in seconds, or None."""
    c = t.counts.get("taylor")
    if not c or not c.get("ops"):
        return None
    routes = [k[len("route."):] for k in c if k.startswith("route.")]
    pk = max(peak(r, t.mix["matmul_precision"]) for r in routes)
    return roofline.bound_s(c["ops"], c["bytes"], pk)


def read(t):
    b = bound_s(t)
    if b is None or not t.range_calls.get("taylor"):
        return None
    return roofline.share_pct(b, t.range_s["taylor"])
