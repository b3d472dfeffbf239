"""Spans at the layer boundaries of an AFQMC step, and per-block records of
their times.

``span(name)`` is a context manager that the step puts around its layers:
``ortho``, ``propagate``, ``pop_control`` and ``measure`` at the top of the
step (``qmc/afqmc.run_block`` and the lanes block of ``qmc/hubbard_fast``),
and inside them ``force_bias``, ``vhs``, ``taylor``, ``inv_logdet``,
``energy`` and ``exchange``. A span costs nothing unless something asks
for it:

* **off** (the default), it reads one flag of this module and torch's
  "a profiler is recording" flag and returns one shared no-op context:
  no event, no ``record_function``, nothing allocated or launched;
* **while any torch profiler records** (``torch.profiler.profile``, whoever
  started it, ``AFQMC(profile_dir=...)`` included), the span is also a
  ``record_function("pauxy.<name>")``: the profile shows it on the
  profiler's clock, nested in its parent span, with the aten ops and
  kernel launches it holds;
* **while the recorder is on** (``enable()``), each ``AFQMC.run_block``
  records its block: every span records a CUDA event on the current
  stream at its entry and exit (the host clock for a CPU run) and the
  host's ``time.perf_counter`` at both edges. The events come from a pool
  reused across blocks. A block's events are read once the next block
  has issued its launches, while the host waits for the card (or when the
  records are asked for): they completed before the block's readback,
  which already waited for the card, so the recorder adds no
  synchronisation, no device-to-host read and no host work between
  blocks.

An operator turns the recorder on for every driver of the process::

    from pauxy_tpu_torch.utils import tracing

    tracing.enable()
    af.run()
    for rec in tracing.blocks():
        print(rec["wall_s"], rec["spans"]["propagate"]["device_s"])

``AFQMC(block_mode="split")`` records its own blocks whether the recorder
is on or not, and prints its per-phase table from the records. Each block
record is a dict: ``steps``; ``wall_s``, the block's wall time (the value
``AFQMC.block_seconds`` gets); ``host_issue_s``, from the block's start
to the moment the host had issued its last launch (just before the
readback), so ``wall_s - host_issue_s`` is the time the host waited for
the card; ``profiled``, whether a profiler was recording during the
block (its host times are then the profiler's, not the program's); and
``spans``, for each span name ``calls``, ``device_s`` (the sum over its
calls of the time between its two events on the card, idle gaps inside
the span included) and ``host_s``. The last ``HISTORY`` records are kept.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "pauxy."
HISTORY = 4096


class _Off:
    """The shared context of a span that nothing asks for."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

# The block being recorded, or None: the one flag of this module that a
# span reads.
_block = None


class _Recorder:
    """The process's recorder: the operator's switch, the recorded blocks
    (``history``; ``pending``, those whose events are not read yet) and
    the free CUDA events, a pool for each device, reused across blocks."""

    def __init__(self):
        self.enabled = False
        self.history = collections.deque(maxlen=HISTORY)
        self.pending = []
        self.pools: dict = {}

    def resolve_pending(self):
        for b in self.pending:
            b.resolve()
        self.pending = []


_RECORDER = _Recorder()


def enable():
    """Record every block that an ``AFQMC`` driver of this process runs."""
    _RECORDER.enabled = True


def disable():
    """Stop recording blocks (split-mode drivers still record their own);
    the history is kept."""
    _RECORDER.enabled = False


def blocks() -> list[dict]:
    """The block records kept, oldest first."""
    _RECORDER.resolve_pending()
    return [b.record for b in _RECORDER.history]


def clear():
    """Drop the block records kept."""
    _RECORDER.resolve_pending()
    _RECORDER.history.clear()


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The span ``name``: a no-op unless a profiler records or a block is
    being recorded (see the module's docstring)."""
    if _block is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "block", "rf", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.block = _block
        if self.block is not None:
            self.entry = self.block.enter(self.name, self.rf is not None)
        return self

    def __exit__(self, *exc):
        if self.block is not None:
            self.block.exit(self.entry)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _NoBlock:
    """What ``block`` returns when the block is not recorded."""

    __slots__ = ()
    record = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def issued(self):
        pass

    def end(self, wall_s: float):
        pass


_NO_BLOCK = _NoBlock()


def block(device, steps: int, t0: float, *, always: bool = False):
    """The context of one driver block of ``steps`` steps on ``device``,
    started at ``t0`` on ``time.perf_counter``'s clock. Recorded while the
    recorder is on, or with ``always``; otherwise (and inside a block
    already recorded) a shared no-op. Inside it the driver calls
    ``issued()`` once its last launch is issued and ``end(wall_s)`` after
    the readback. A block that exits cleanly is kept in the history; its
    ``record`` is read from its events when first asked for, else in the
    next block's ``issued()``."""
    global _block
    if _block is not None or not (always or _RECORDER.enabled):
        return _NO_BLOCK
    _block = _Block(torch.device(device), steps, t0)
    return _block


class _Block:
    def __init__(self, device: torch.device, steps: int, t0: float):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self.pool = (_RECORDER.pools.setdefault(self.stream.device, [])
                     if self.cuda else None)
        self.steps = steps
        self.t0 = t0
        self.profiled = _profiling()
        self.host_issue_s = None
        self.wall_s = None
        self.spans = []             # [name, start, end, host start, end]
        self._record = None

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = (self.pool.pop() if self.pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(self.stream)
        return ev

    def enter(self, name: str, profiled: bool) -> list:
        self.profiled = self.profiled or profiled
        entry = [name, self._mark(), None, time.perf_counter(), None]
        self.spans.append(entry)
        return entry

    def exit(self, entry: list):
        entry[4] = time.perf_counter()
        entry[2] = self._mark()

    def issued(self):
        self.host_issue_s = time.perf_counter() - self.t0
        # The earlier blocks' events completed before their readbacks; the
        # host reads them here, while the card runs this block.
        _RECORDER.resolve_pending()

    def end(self, wall_s: float):
        self.wall_s = wall_s
        self.profiled = self.profiled or _profiling()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        global _block
        _block = None
        if exc_type is None and self.wall_s is not None:
            _RECORDER.history.append(self)
            _RECORDER.pending.append(self)
        else:
            self.spans = []
        return False

    @property
    def record(self) -> dict | None:
        """The block's record (see the module's docstring)."""
        if self._record is None and self.wall_s is not None:
            self.resolve()
        return self._record

    def resolve(self):
        """Read the block's events into its record and return them to the
        pool. They completed before the readback that ended the block, so
        reading them waits for nothing."""
        if self._record is not None:
            return
        spans = {}
        for name, a, b, h0, h1 in self.spans:
            s = spans.get(name)
            if s is None:
                s = spans[name] = {"calls": 0, "device_s": 0.0,
                                   "host_s": 0.0}
            s["calls"] += 1
            if self.cuda:
                s["device_s"] += a.elapsed_time(b) * 1e-3
                self.pool += (a, b)
            else:
                s["device_s"] += b - a
            s["host_s"] += h1 - h0
        self.spans = []
        self._record = {"steps": self.steps, "wall_s": self.wall_s,
                        "host_issue_s": self.host_issue_s,
                        "profiled": self.profiled, "spans": spans}
