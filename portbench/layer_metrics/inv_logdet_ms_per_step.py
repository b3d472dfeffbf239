"""inv_logdet_ms_per_step: device milliseconds a step of the overlap
matrices' inverses and log-determinants (the port's span ``inv_logdet``
in ``ops/clinalg.inv_logdet`` and ``slogdet``: kernel B, or
``torch.linalg`` past its cap), in the propagation and the energy, median
over the traced window's unprofiled blocks."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.span_ms_per_step("inv_logdet")
