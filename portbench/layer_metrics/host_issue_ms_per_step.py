"""host_issue_ms_per_step: the host's milliseconds a step to issue a
block: from the start of ``AFQMC.run_block`` to its last launch, just
before the readback (the port's block record, ``host_issue_s``), over the
block's steps; median over the traced window's unprofiled blocks. Where it
nears the card's time a step, the host paces the block."""

from portbench import program_spans

RANGES = ()

program_spans.start()


def read(t):
    return program_spans.median(
        lambda b: None if b["host_issue_s"] is None
        else b["host_issue_s"] * 1e3 / b["steps"])
