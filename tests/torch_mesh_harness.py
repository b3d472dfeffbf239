"""Run mesh cases on R gloo ranks while the parent runs them on one.

A module-scoped fixture of each ``tests/test_torch_mesh*.py`` file calls
:func:`sharded_and_one_rank` once: the ranks (``parallel.launch``, one
torch thread each, their own timeout) run every case of the file and hand
back their results, while this process computes the one-rank results.
"""

from __future__ import annotations

import threading

import numpy as np

import torch_mesh_cases as cases
from pauxy_tpu_torch.parallel import launch

NRANKS = 4
# Seconds for the process group's start, each collective and the join.
TIMEOUT = 120.0


def sharded_and_one_rank(names, tmp):
    """({name: one-rank result}, [{name: result} per rank])."""
    box = {}

    def ranks():
        try:
            box["ranks"] = launch.run_ranks(cases.run_rank, NRANKS,
                                            list(names), str(tmp),
                                            timeout=TIMEOUT)
        except Exception as exc:              # re-raised in the test
            box["error"] = exc

    t = threading.Thread(target=ranks)
    t.start()
    try:
        ref = {n: cases.run(n, None, str(tmp)) for n in names}
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return ref, box["ranks"]


def flat(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in flat(e)]
    return [np.asarray(x)]


def assert_same(ref, got, rtol=1e-8, atol=1e-10):
    a, b = flat(ref), flat(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=rtol, atol=atol)
