"""The port's span recorder (``pauxy_tpu_torch/utils/tracing``) on the
generic block (a small Generic and a small UEG system) and on the lanes
block (the Hubbard continuous path):

* off, a span is one shared no-op context: no ``record_function`` is
  entered and no block is recorded;
* on, each block leaves one record whose span calls follow the block's
  schedule, whose host issue time is within its wall time, and whose
  child spans take no longer than their parents; its counters are empty
  on the CPU (no kernel launches), and a UEG block whose cube the
  force-bias kernel does not take counts each force bias's torch.fft
  route, with the rows the same bits with the recorder off and on;
* the output rows are the same bits with the recorder off, on and in
  split mode;
* under ``torch.profiler`` the ``pauxy.*`` ranges nest as the step does,
  with aten operations inside them.
"""

import json

import numpy as np
import pytest
import torch

from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                    make_hubbard, make_ueg,
                                    rhf_identity_trial)
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.utils import tracing
from pauxy_tpu_torch.utils.testing import generate_hamiltonian
from pauxy_tpu_torch.walkers import pop_control

CPU = dict(device="cpu", dtype="double")
NSTEPS, NSTBLZ, NPOP, EFREQ = 6, 3, 2, 3
CASES = ("generic", "ueg", "lanes")
TOP = ("ortho", "propagate", "pop_control", "measure")
# Each inner span and the spans that may hold it.
PARENTS = {"force_bias": ("propagate",), "vhs": ("propagate",),
           "taylor": ("propagate",), "energy": ("measure",),
           "exchange": ("energy",), "inv_logdet": ("propagate", "energy")}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _system(case):
    if case == "generic":
        h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=5)
        ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
        return ham, rhf_identity_trial(ham, **CPU)
    if case == "ueg":
        ham = make_ueg(2, 2, rs=1.0, ecut=0.5, **CPU)
        return ham, rhf_identity_trial(ham, **CPU)
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **CPU)
    return ham, free_electron_trial(ham, **CPU)


def _driver(case, **kw):
    ham, trial = _system(case)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=NSTEPS, nblocks=2,
                  nstblz=NSTBLZ, npop_control=NPOP, rng_seed=11)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": EFREQ}},
               device="cpu", **kw)
    assert af.use_fast_block == (case == "lanes")
    return af


def _blocks(af, n=2):
    """The rows of ``n`` blocks, without the wall-clock column (Time)."""
    return np.array([af.run_block() for _ in range(n)])[:, :10]


@pytest.mark.parametrize("case", CASES)
def test_off_is_one_shared_noop(case, monkeypatch):
    assert tracing.span("ortho") is tracing.span("taylor")

    def refuse(*args, **kwargs):
        raise AssertionError("a span entered record_function while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    af = _driver(case)
    rows = _blocks(af)
    assert np.isfinite(rows).all()
    assert tracing.blocks() == []
    assert af.timing["prop"] == 0.0


@pytest.mark.parametrize("case", CASES)
def test_records_follow_the_schedule(case):
    tracing.enable()
    af = _driver(case)
    _blocks(af)
    recs = tracing.blocks()
    assert len(recs) == 2
    for rec, wall in zip(recs, af.block_seconds):
        assert rec["steps"] == NSTEPS and rec["wall_s"] == wall
        assert 0 < rec["host_issue_s"] <= rec["wall_s"]
        assert not rec["profiled"]
        calls = {k: v["calls"] for k, v in rec["spans"].items()}
        want = {"ortho": NSTEPS // NSTBLZ, "propagate": NSTEPS,
                "pop_control": NSTEPS // NPOP, "measure": NSTEPS}
        if case != "lanes":
            want.update(force_bias=NSTEPS, vhs=NSTEPS, taylor=NSTEPS,
                        energy=NSTEPS // EFREQ)
        if case == "generic":
            want["exchange"] = NSTEPS // EFREQ
        assert {k: calls.get(k) for k in want} == want
        if case == "lanes":
            assert set(calls) == set(TOP)
        else:
            assert calls["inv_logdet"] > NSTEPS
        assert set(calls) <= set(TOP) | set(PARENTS)
        assert rec["counts"] == {}


@pytest.mark.parametrize("case", CASES)
def test_children_take_no_longer_than_parents(case):
    tracing.enable()
    af = _driver(case)
    _blocks(af)
    for rec in tracing.blocks():
        spans = rec["spans"]
        for key in ("device_s", "host_s"):
            def total(*names):
                return sum(spans[n][key] for n in names if n in spans)

            assert total(*TOP) <= rec["wall_s"]
            for child, parents in PARENTS.items():
                if child in spans:
                    # inv_logdet also runs inside propagate's and
                    # measure's other children; energy holds measure's.
                    held = ("propagate", "measure") \
                        if child == "inv_logdet" else parents
                    assert total(child) <= total(*held), (child, key)
            assert all(v["device_s"] > 0 for v in spans.values())


@pytest.mark.parametrize("case", CASES)
def test_rows_are_the_same_bits_off_on_and_split(case):
    off = _blocks(_driver(case))
    tracing.enable()
    on = _blocks(_driver(case))
    tracing.disable()
    split = _driver(case, block_mode="split")
    rows = _blocks(split)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(rows, off)
    # Split mode records its blocks with the recorder off, and its timing
    # is the four top-level spans' sums.
    recs = tracing.blocks()[-2:]
    assert len(tracing.blocks()) == 4
    for key, name in (("ortho", "ortho"), ("prop", "propagate"),
                      ("pop", "pop_control"), ("estim", "measure")):
        assert split.timing[key] == pytest.approx(
            sum(r["spans"][name]["device_s"] for r in recs), rel=1e-12)


def test_ueg_block_counts_the_force_bias_fft_route(monkeypatch):
    """Past the kernel's rule the UEG's force bias takes the torch.fft
    route: the block record counts one a step, and the recorder changes
    no bit of the rows."""
    from pauxy_tpu_torch.ops import pw_force_bias_cuda
    monkeypatch.setattr(pw_force_bias_cuda, "fits", lambda tab, dt: False)
    off = _blocks(_driver("ueg"))
    tracing.enable()
    on = _blocks(_driver("ueg"))
    np.testing.assert_array_equal(on, off)
    for rec in tracing.blocks():
        assert rec["counts"] == {"pw_force_bias.fft_route": NSTEPS}
        assert rec["spans"]["force_bias"]["calls"] == NSTEPS


def _trace_events(tmp_path, run):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.mark.parametrize("case", CASES)
def test_profiler_sees_nested_spans(case, tmp_path):
    af = _driver(case)
    events = _trace_events(tmp_path, af.run_block)
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                tracing.PREFIX):
            spans.setdefault(e["name"][len(tracing.PREFIX):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    assert len(spans["propagate"]) == NSTEPS
    assert len(spans["ortho"]) == NSTEPS // NSTBLZ
    want = set(TOP) if case == "lanes" else set(TOP) | {
        "force_bias", "vhs", "taylor", "energy", "inv_logdet"}
    if case == "generic":
        want.add("exchange")
    assert set(spans) == want

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    for child, parents in PARENTS.items():
        for s in spans.get(child, ()):
            assert any(inside(s, p) for name in parents
                       for p in spans.get(name, ())), child
    for name, intervals in spans.items():
        for s in intervals:
            assert any(inside(op, s) for op in ops), name
    # The profiled block is recorded only with the recorder on.
    assert tracing.blocks() == []
    tracing.enable()
    _trace_events(tmp_path, af.run_block)
    (rec,) = tracing.blocks()
    assert rec["profiled"]


def test_a_block_that_raises_leaves_no_record(monkeypatch):
    tracing.enable()
    af = _driver("generic")

    def fail(*args, **kwargs):
        raise FloatingPointError("planted")

    monkeypatch.setattr(pop_control, "pop_control", fail)
    with pytest.raises(FloatingPointError):
        af.run_block()
    assert tracing.blocks() == []
    monkeypatch.undo()
    tracing.disable()
    # The failed block is closed: spans are off again.
    assert tracing.span("propagate") is tracing.span("ortho")
