"""Helpers of the benchmark's CPU and card tests: the cells' registry cut
to tiny sizes, and one harness run past its look for a card."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny sizes of the two configurations and of every mix, for the CPU.
SMALL_CONFIG = {"c6h6_dz": dict(nmo=12, nup=3, ndown=3, naux=30),
                "ueg14_rs1": dict(ecut=1.0)}
SMALL_MIX = dict(nwalkers=16)


def shrunk_registry(configs=SMALL_CONFIG, mix=SMALL_MIX):
    """The benchmark's registry with its configurations and mixes cut to
    the given sizes."""
    from portbench.registry import Registry

    reg = Registry()
    config0, mix0 = reg.config, reg.mix

    def config(name):
        c = config0(name)
        c.update(configs.get(name, {}))
        return c

    def mix_(name):
        m = mix0(name)
        m.update(mix)
        return m

    reg.config, reg.mix = config, mix_
    return reg


def run_cell(reg, workload, seed=2 ** 33 + 7, seconds=0.5, device="cpu",
             **kw):
    from portbench import harness

    return harness.run(reg, workload, seed, seconds, False, device,
                       time.perf_counter(), lambda m: None, **kw)
