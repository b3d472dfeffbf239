"""The port's own block records, for the per-layer metrics that read them.

The port records, while its recorder is on, one record a block
(``pauxy_tpu_torch.utils.tracing``): the block's wall time, the host's
time to issue its last launch, and for each span of the step its calls
and device seconds (CUDA events at the span's edges, read after the
block's readback). A reader of these records calls ``start()`` when it
loads. The harness loads readers only in a traced run, after the warm-up
blocks and before the window, so the recorder is on for the traced window
and off in every untraced run.

The profiler slows the host 1.5-2.6x, so a profiled block is paced by the
host and its spans' event intervals hold idle time: only the window's
unprofiled blocks are read. Each reader gives the median over them of a
value a block, or None where the value never arises (a span that never
ran, or a port without the recorder, which leaves no records).
"""

from __future__ import annotations

import statistics


def _tracing():
    try:
        from pauxy_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def start() -> bool:
    """Turn the port's recorder on with an empty history; False where the
    port has no recorder."""
    tracing = _tracing()
    if tracing is None:
        return False
    tracing.enable()
    tracing.clear()
    return True


def window_blocks() -> list[dict]:
    """The records of the blocks run while no profiler recorded."""
    tracing = _tracing()
    if tracing is None:
        return []
    return [b for b in tracing.blocks() if not b["profiled"]]


def median(value):
    """The median over the unprofiled blocks of ``value(record)``, leaving
    out the blocks where it is None; None if it is None in all."""
    vals = [v for v in map(value, window_blocks()) if v is not None]
    return statistics.median(vals) if vals else None


def span_ms_per_step(name: str):
    """The span's device milliseconds a step, median over the blocks."""
    def value(b):
        s = b["spans"].get(name)
        return None if s is None else s["device_s"] * 1e3 / b["steps"]

    return median(value)


def span_ms_per_call(name: str):
    """The span's device milliseconds a call, median over the blocks."""
    def value(b):
        s = b["spans"].get(name)
        return None if not s else s["device_s"] * 1e3 / s["calls"]

    return median(value)
