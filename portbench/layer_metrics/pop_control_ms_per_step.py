"""pop_control_ms_per_step: device milliseconds a step of the population
control (the port's span ``pop_control``, around the call to
``walkers.pop_control.pop_control``: the comb's parents and the gather of
the walkers), median over the traced window's unprofiled blocks."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.span_ms_per_step("pop_control")
