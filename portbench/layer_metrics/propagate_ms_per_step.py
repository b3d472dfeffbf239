"""propagate_ms_per_step: device milliseconds launched from inside
``propagation/continuous.Continuous.propagate`` a step (the Green's
function, force bias, VHS, Taylor series and weights of the step; the
re-orthogonalisation and population control are outside it)."""

RANGES = (("pauxy_tpu_torch.propagation.continuous", "Continuous.propagate",
           "propagate", None),)


def read(t):
    if not t.range_s.get("propagate") or not t.steps:
        return None
    return t.range_s["propagate"] * 1e3 / t.steps
