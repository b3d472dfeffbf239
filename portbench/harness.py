"""One run of one cell: set-up, the measured window, the check, the result.

Set-up builds the cell's system from its configuration and the seed,
builds the port's ``pauxy_tpu_torch.qmc.AFQMC`` through its
normal API, checks its start, and runs the mix's warm-up blocks,
which build or load the kernel library and touch every shape of the cell.
The window then runs whole ``AFQMC.run_block`` calls, each with the
block's seeded draws, until ``seconds`` have passed, and lets the last
block that started finish. Sampled blocks (drawn from the seed) are
recorded step by step for the check (``check.py``), which runs once the
window has closed, the peak memory has been read and ``AFQMC`` is freed.
The peak is the program's own: it is read over the window's blocks that
record nothing, less what the recorded blocks hold.
With ``trace`` the readers' ranges are on for the whole window and a fixed
number of blocks, spread evenly in time through it, are profiled.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import time

import numpy as np
import torch

from portbench import check, draws
from portbench.trace import Tracer

# Blocks profiled in a traced run, spread evenly in time through the window.
TRACE_BLOCKS = 8


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list
    breakdown: dict | None = None
    control: dict | None = None


def sample_fractions(seed: int, mix: dict) -> list[float]:
    """When, as shares of the window, the blocks the check follows start:
    the first block to start past each share, drawn from the seed."""
    rng = random.Random(draws.derive(seed, "sample"))
    return sorted(0.95 * rng.random() for _ in range(mix["check_blocks"]))


def build_afqmc(built, mix: dict, seed: int, device):
    """The port's ``AFQMC`` for the cell, through its public API."""
    for k, v in built.env.items():
        os.environ[k] = v
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    qmc = QMCOpts(nwalkers=mix["nwalkers"], dt=mix["dt"],
                  nsteps=mix["nsteps"], nblocks=1, nstblz=mix["nstblz"],
                  npop_control=mix["npop_control"],
                  rng_seed=draws.derive(seed, "afqmc"),
                  pop_control_method=mix["pop_control"])
    return AFQMC(built.ham, built.trial, qmc,
                 propagator_options=built.propagator_options,
                 estimator_options={"mixed": {
                     "energy_eval_freq": mix["energy_eval_freq"]}},
                 device=device)


def _row_ok(row) -> bool:
    return bool(np.isfinite(row[5].real) and np.isfinite(row[2].real))


def run(reg, workload: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, log, *, dtype: str = "single",
        control: bool = False) -> Result:
    """One run of ``workload``. ``t_start`` is the process's start on the
    host clock (set-up is measured from it). With ``control`` the check
    also reads the control (``check.control_model``) on the same blocks,
    for calibration, into the result's ``control``."""
    cell = reg.workload(workload)
    cfg = reg.config(cell["config"])
    mix = reg.mix(cell["traffic"])
    limits = reg.limits(workload)
    builder = reg.builder(cfg["builder"])
    built = builder.build(cfg, mix, seed, device, dtype)
    af = build_afqmc(built, mix, seed, device)
    start_state = af.state
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    noise = draws.BlockDraws(seed, mix["nsteps"], mix["nwalkers"],
                             built.nfields, device)
    check.verify_seams()
    # The warm-up blocks are recorded as the window's sampled blocks are,
    # and the records dropped: the card's caching allocator then already
    # holds the memory that the window's records take.
    warm = []
    for k in range(mix["warmup_blocks"]):
        warm.append(check.Capture())
        with warm[-1]:
            af.run_block(noise.block("warmup", k))
    del warm
    tracer = None
    if trace:
        readers = {m["name"]: reg.metric_reader(m["name"])
                   for m in reg.per_layer(workload)}
        tracer = Tracer(readers, log)
        tracer.install()
        # The profiler's first start initialises its tracing: once here.
        with tracer.profiled():
            af.run_block(noise.block("warmup", mix["warmup_blocks"]))
        tracer.blocks.clear()
        tracer.counts.clear()
    sync()
    fracs = [f * seconds for f in sample_fractions(seed, mix)]
    marks = [seconds * k / TRACE_BLOCKS for k in range(TRACE_BLOCKS)]
    records, etotal = [], []
    # The program's peak: over the blocks that record nothing, less the
    # bytes that the recorded blocks' states keep on the card (``held``).
    memory_peak, held = 0, 0
    profiled = set()
    failed = 0
    nblock0 = len(af.block_seconds)
    b = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        nz = noise.block("window", b)
        profile = trace and marks and now >= marks[0]
        if profile:
            marks.pop(0)
            profiled.add(b)
        sampled = bool(fracs) and now >= fracs[0]
        try:
            if sampled:
                fracs.pop(0)
                before = _allocated(cuda, device)
                rec = check.BlockRecord(b, af.step, af.state, af.eshift, nz,
                                        check.Capture(), None)
                with rec.capture:
                    rec.row = _run_block(af, nz, tracer if profile else None)
                records.append(rec)
                row = rec.row
                held += _allocated(cuda, device) - before
            else:
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                row = _run_block(af, nz, tracer if profile else None)
                if cuda:
                    memory_peak = max(memory_peak, torch.cuda.
                                      max_memory_allocated(device) - held)
        except (RuntimeError, ValueError, FloatingPointError) as e:
            log(f"# block {b} raised {type(e).__name__}: {e}")
            failed += 1
            b += 1
            break
        etotal.append(float(row[5].real))
        if not _row_ok(row):
            failed += 1
        b += 1
    t_end = time.perf_counter()
    window_s = t_end - t0
    attempted = b
    done = attempted - failed
    block_s = af.block_seconds[nblock0:]
    # Sampled blocks the window did not reach run after it, untimed.
    extra = 0
    while failed == 0 and fracs:
        fracs.pop(0)
        nz = noise.block("window", b)
        rec = check.BlockRecord(b, af.step, af.state, af.eshift, nz,
                                check.Capture(), None)
        with rec.capture:
            rec.row = af.run_block(nz)
        records.append(rec)
        b += 1
        extra += 1
    if extra:
        log(f"# ran {extra} blocks past the window to reach the sampled "
            "blocks")
    if etotal:
        log(f"# ETotal of the window's blocks: first {etotal[0]!r}, last "
            f"{etotal[-1]!r}, min {min(etotal)!r}, max {max(etotal)!r}")
    sync()
    metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        tracer.uninstall()
        plain = [s for i, s in enumerate(block_s) if i not in profiled]
        summary = tracer.summary(mix["nsteps"],
                                 float(np.mean(plain or block_s)))
        summary.mix = mix
        if summary.unmatched:
            log(f"# {summary.unmatched} device events without a host launch "
                "in the trace")
        for name, reader in tracer.readers.items():
            if name in tracer.missing:
                continue
            v = reader.read(summary)
            if v is None:
                log(f"# {name}: nothing to read in this cell")
                continue
            unit = next(m["unit"] for m in reg.per_layer(workload)
                        if m["name"] == name)
            metrics[name] = {"value": v, "unit": unit}
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.wall_s
        breakdown = summary.breakdown()
        log(f"# traced {summary.nblocks} blocks: busy {summary.busy_s!r} s, "
            f"{summary.traced_wall_s!r} s under the profiler, "
            f"{summary.wall_s!r} s at the unprofiled blocks' median")
    elif done > 0:
        rate = done * mix["nsteps"] * mix["nwalkers"] / window_s
        units = {m["name"]: m["unit"] for m in reg.end_to_end(workload)}
        values = {"walker_steps_per_s": rate,
                  "block_ms_p95": float(np.percentile(block_s, 95)) * 1e3,
                  "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": u}
                   for k, u in units.items()}
    log(f"# window {window_s:.6f} s, {attempted} blocks, {failed} failed, "
        f"setup {setup_s:.6f} s, peak {memory_peak} bytes (the program's; "
        f"the recorded blocks hold {held} more)")
    if block_s:
        q = np.percentile(block_s, [0, 50, 95, 100]) * 1e3
        log(f"# block ms min {q[0]:.3f} median {q[1]:.3f} p95 {q[2]:.3f} "
            f"max {q[3]:.3f}; load average {os.getloadavg()}")
    # The check: AFQMC, its system and its state freed first.
    del af
    built.ham = built.trial = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        from pauxy_tpu_torch import config
        config.set_matmul_precision("float32", device)
    t_check = time.perf_counter()
    model = check.reference_model(built)
    numbers = {"start_mismatch": check.start_mismatch(
        start_state, model.psia, model.psib)}
    ctl_numbers = None
    if failed == 0 and records:
        ctl = check.control_model(built) if control else None
        got, ctl_numbers = check.check_blocks(model, records, mix, ctl,
                                              log)
        numbers.update(got)
    correct, rows = check.judge(numbers, limits)
    correct = correct and failed == 0
    log(f"# check {time.perf_counter() - t_check:.3f} s over blocks "
        f"{[r.index for r in records]}")
    return Result(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev_info, checks=rows,
                  breakdown=breakdown, control=ctl_numbers)


def _allocated(cuda: bool, device) -> int:
    return torch.cuda.memory_allocated(device) if cuda else 0


def _run_block(af, nz, tracer):
    if tracer is None:
        return af.run_block(nz)
    with tracer.profiled():
        return af.run_block(nz)

