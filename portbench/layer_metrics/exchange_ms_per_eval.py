"""exchange_ms_per_eval: device milliseconds of the exchange energy an
energy evaluation (the port's span ``exchange`` around both spins'
``estimators/local_energy._exx``: the exchange kernel or supermatrix
product), median over the traced window's unprofiled blocks."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.span_ms_per_call("exchange")
