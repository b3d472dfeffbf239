"""The traced run: ranges around the program's layers, a profile of a fixed
number of whole blocks spread through the window, and the reduction of
each block's trace to times, counts and shapes.

Ranges are ``torch.profiler.record_function`` spans that the harness puts
around the calls into a layer, by wrapping the entry point at every place it
is bound; each per-layer reader (``layer_metrics/<metric>.py``) names its
entry points in ``RANGES`` as (module, attribute path, range, hook). A hook
sees the call's arguments and returns counts (operations, bytes) that are
summed for the range while a block is profiled. A kernel's device time
belongs to every range whose host span holds the host call that launched
it (matched by the profiler's correlation ids); an aten matrix product's
shapes come from the profiler's recorded input shapes.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import json
import os
import tempfile

import torch

BLOCK = "portbench.block"
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Operand types of the float32 / complex64 products, with their bytes and
# whether they are complex.
GEMM_TYPES = {"float": (4, False), "c10::complex<float>": (8, True)}
TOP = 10


class Patches:
    """setattr with undo, for the wrappers of a run."""

    def __init__(self):
        self._undo = []

    def wrap(self, module: str, path: str, make):
        """Replace ``module.path`` (a dotted attribute path) by
        ``make(original)``; raises if the entry point has gone."""
        obj = importlib.import_module(module)
        *parents, last = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        orig = getattr(obj, last)
        setattr(obj, last, make(orig))
        self._undo.append((obj, last, orig))

    def undo(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo = []


class Tracer:
    """Installs the readers' ranges and reduces the profiled blocks."""

    def __init__(self, readers: dict, log):
        self.readers = readers          # metric name -> reader module
        self.log = log
        self.active = False
        self.counts = collections.defaultdict(lambda: collections.Counter())
        self.missing = {}               # metric -> why its range is absent
        self.patches = Patches()
        self.blocks = []                # BlockTrace of each profiled block

    def install(self):
        done = {}
        for metric, reader in self.readers.items():
            for module, path, rng, hook in getattr(reader, "RANGES", ()):
                key = (module, path)
                if key in done:
                    if done[key] is not None:
                        self.missing[metric] = done[key]
                    continue
                try:
                    self.patches.wrap(module, path,
                                      lambda f, r=rng, h=hook:
                                      self._ranged(f, r, h))
                    done[key] = None
                except (ImportError, AttributeError) as e:
                    done[key] = f"{module}.{path}: {e}"
                    self.missing[metric] = done[key]
        for metric, why in self.missing.items():
            self.log(f"# {metric}: entry point gone ({why}); left out")

    def _ranged(self, fn, name: str, hook):
        label = f"portbench.{name}"

        def wrapper(*args, **kwargs):
            if self.active and hook is not None:
                self.counts[name].update(hook(args, kwargs))
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    def uninstall(self):
        self.patches.undo()

    @contextlib.contextmanager
    def profiled(self):
        """Profile one block and reduce its trace at once (a profile's
        device events do not outlive the next profile)."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts, record_shapes=True)
        self.active = True
        with prof:
            with torch.profiler.record_function(BLOCK):
                yield
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.blocks.append(BlockTrace(events))

    def summary(self, nsteps: int, wall_s: float):
        """The profiled blocks as the readers see them; ``wall_s`` is a
        block's wall time when it is not profiled."""
        return TraceSummary(self.blocks, nsteps, self.counts, wall_s)


class _Intervals:
    """Host spans of one name on one thread, for 'which span holds t'."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[0])
        self.starts = [s[0] for s in self.spans]

    def holding(self, t: float):
        """The innermost span (latest start) that holds t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if self.spans[j][1] >= t:
                return self.spans[j]
        return None


class BlockTrace:
    """One profiled block reduced: wall and busy seconds, kernels and their
    device seconds, device seconds and calls by range, the products with
    their shapes, and the idle gaps by what the host was doing."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        block = [e for e in xs if e.get("name") == BLOCK
                 and e.get("cat") == "user_annotation"]
        if not block:
            raise RuntimeError("the profiled block has no block range")
        b0 = float(block[0]["ts"])
        b1 = b0 + float(block[0]["dur"])
        self.wall_s = (b1 - b0) * 1e-6
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launch[e["args"]["correlation"]] = (float(e["ts"]), e["tid"])
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = collections.Counter()
        self.launches = 0
        self.unmatched = 0
        spans = []
        ranges = collections.defaultdict(list)
        gemm_spans = []
        for e in xs:
            if e.get("cat") == "user_annotation" and e["name"].startswith(
                    "portbench.") and e["name"] != BLOCK:
                ranges[e["name"][len("portbench."):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e))
            elif e.get("cat") == "cpu_op" and e["name"] in GEMM_OPS:
                gemm_spans.append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"]), e))
        rix = {k: _Intervals(v) for k, v in ranges.items()}
        gix = _Intervals(gemm_spans)
        self.range_s = collections.Counter()
        self.range_calls = {k: len(v) for k, v in ranges.items()}
        self.gemm = []
        gemm_dev = collections.Counter()
        for e in dev:
            t0, dur = float(e["ts"]), float(e["dur"])
            if t0 < b0 or t0 > b1:
                continue
            spans.append((t0, t0 + dur))
            if e["cat"] == "kernel":
                self.launches += 1
                self.kernels[e["name"][:160]] += dur * 1e-6
            corr = e.get("args", {}).get("correlation")
            if corr not in launch:
                self.unmatched += 1
                continue
            lt, _ = launch[corr]
            for name, ix in rix.items():
                if ix.holding(lt) is not None:
                    self.range_s[name] += dur * 1e-6
            g = gix.holding(lt)
            if g is not None:
                gemm_dev[id(g[2])] += dur * 1e-6
        for s0, s1, e in gemm_spans:
            inside = {name for name, ix in rix.items()
                      if ix.holding(s0) is not None}
            self.gemm.append({"op": e["name"],
                              "dims": e.get("args", {}).get("Input Dims"),
                              "types": e.get("args", {}).get("Input type"),
                              "device_s": gemm_dev.get(id(e), 0.0),
                              "ranges": inside})
        self.busy_s, self.idle = self._busy_and_gaps(spans, b0, b1, xs)

    @staticmethod
    def _busy_and_gaps(spans, b0, b1, xs):
        spans.sort()
        merged = []
        for s in spans:
            if merged and s[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s[1])
            else:
                merged.append([s[0], s[1]])
        busy = sum(e - s for s, e in merged) * 1e-6
        host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]) for e in xs
                if e.get("cat") in ("cpu_op", "user_annotation")
                and e.get("name") != BLOCK]
        hix = _Intervals(host)
        idle = collections.Counter()
        edges = [b0] + [x for s in merged for x in s] + [b1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            h = hix.holding(0.5 * (g0 + g1))
            idle[h[2][:160] if h is not None else "host (no op)"] += (
                (g1 - g0) * 1e-6)
        return busy, idle


class TraceSummary:
    """The profiled blocks together, as the per-layer readers see them.

    Under the profiler the host runs a block 1.5-3x slower (CUPTI's
    tracing of each launch, the recorded ops and shapes); the device's
    times are unchanged. So the blocks' wall time ``wall_s`` is their
    number times a block's wall time when it is not profiled (the mean
    of the window's other blocks), and the device's busy time ``busy_s``
    is the union of their device intervals."""

    def __init__(self, blocks, nsteps: int, counts, block_wall_s: float):
        self.nblocks = len(blocks)
        self.steps = self.nblocks * nsteps
        self.wall_s = self.nblocks * block_wall_s
        self.traced_wall_s = sum(b.wall_s for b in blocks)
        self.busy_s = sum(b.busy_s for b in blocks)
        self.launches = sum(b.launches for b in blocks)
        self.unmatched = sum(b.unmatched for b in blocks)
        self.range_s = sum((b.range_s for b in blocks), collections.Counter())
        self.range_calls = collections.Counter()
        for b in blocks:
            self.range_calls.update(b.range_calls)
        self.gemm = [g for b in blocks for g in b.gemm]
        self.kernels = sum((b.kernels for b in blocks), collections.Counter())
        self.idle = sum((b.idle for b in blocks), collections.Counter())
        self.counts = counts
        self.mix = {}

    def breakdown(self) -> dict:
        return {"device_ops": [[k, v] for k, v in
                               self.kernels.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in self.idle.most_common(TOP)]}


def gemm_count(g: dict):
    """(operations, bytes) of one float32 / complex64 aten product from its
    recorded shapes, or None for another type or an unreadable record."""
    dims, types = g.get("dims"), g.get("types")
    if not dims or not types:
        return None
    args = {"aten::mm": (0, 1), "aten::bmm": (0, 1),
            "aten::addmm": (1, 2), "aten::baddbmm": (1, 2)}[g["op"]]
    a, b = dims[args[0]], dims[args[1]]
    ta = types[args[0]]
    if ta not in GEMM_TYPES or types[args[1]] != ta:
        return None
    size, cplx = GEMM_TYPES[ta]
    if len(a) == 2 and len(b) == 2:
        batch, (m, k), n = 1, a, b[1]
    elif len(a) == 3 and len(b) == 3:
        batch, m, k, n = a[0], a[1], a[2], b[2]
    else:
        return None
    ops = (8 if cplx else 2) * batch * m * n * k
    nbytes = size * batch * (m * k + k * n + m * n)
    if g["op"] in ("aten::addmm", "aten::baddbmm"):
        nbytes += size * batch * m * n
    return ops, nbytes
