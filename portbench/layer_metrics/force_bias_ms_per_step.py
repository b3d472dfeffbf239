"""force_bias_ms_per_step: device milliseconds a step of the force bias
(the port's span ``force_bias`` in ``propagation/continuous.
two_body_factors``: the Cholesky products of the Generic system, the FFT
correlations of the plane waves, and the clamp), median over the traced
window's unprofiled blocks."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.span_ms_per_step("force_bias")
