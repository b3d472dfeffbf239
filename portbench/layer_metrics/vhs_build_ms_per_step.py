"""vhs_build_ms_per_step: device milliseconds of the plane-wave VHS build
(``ops/ueg_sparse.assemble_vhs``: the gathers of the per-q coefficients
into a dense [w, M, M]) a step."""

RANGES = (("pauxy_tpu_torch.ops.ueg_sparse", "assemble_vhs", "vhs_build",
           None),)


def read(t):
    if not t.range_s.get("vhs_build") or not t.steps:
        return None
    return t.range_s["vhs_build"] * 1e3 / t.steps
