"""ortho_ms_per_step: device milliseconds a step of the walkers'
re-orthogonalisation (the port's span ``ortho``: CholeskyQR2 every
``nstblz`` steps), median over the traced window's unprofiled blocks."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.span_ms_per_step("ortho")
