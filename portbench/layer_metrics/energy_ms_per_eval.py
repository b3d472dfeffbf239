"""energy_ms_per_eval: device milliseconds launched from inside the mixed
estimator's local energies (``estimators/mixed._energies``: the Green's
functions, one-body, Coulomb and exchange terms) an evaluation."""

RANGES = (("pauxy_tpu_torch.estimators.mixed", "_energies", "energy", None),)


def read(t):
    calls = t.range_calls.get("energy")
    if not calls or not t.range_s.get("energy"):
        return None
    return t.range_s["energy"] * 1e3 / calls
