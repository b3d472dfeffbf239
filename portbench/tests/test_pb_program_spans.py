"""The readers of the port's block records (``program_spans.py`` and the
six per-layer metrics that use it), on synthetic records and on a real
block: the value of each reader, profiled blocks left out, None where a
span never ran or the port has no recorder, and ``start()`` clearing the
history."""

import pytest

from pauxy_tpu_torch.utils import tracing
from portbench import program_spans
from portbench.registry import Registry

READERS = ("host_issue_ms_per_step", "ortho_ms_per_step",
           "pop_control_ms_per_step", "force_bias_ms_per_step",
           "inv_logdet_ms_per_step", "exchange_ms_per_eval")


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    tracing.disable()
    tracing.clear()


def _record(scale, profiled=False, exchange=True):
    spans = {"ortho": {"calls": 2, "device_s": 0.002 * scale},
             "pop_control": {"calls": 10, "device_s": 0.010 * scale},
             "force_bias": {"calls": 10, "device_s": 0.020 * scale},
             "inv_logdet": {"calls": 40, "device_s": 0.005 * scale}}
    if exchange:
        spans["exchange"] = {"calls": 10, "device_s": 0.030 * scale}
    for s in spans.values():
        s["host_s"] = 1e-4
    return {"steps": 10, "wall_s": 0.2 * scale, "host_issue_s": 0.1 * scale,
            "profiled": profiled, "spans": spans}


def _readers():
    reg = Registry()
    return {name: reg.metric_reader(name) for name in READERS}


def test_readers_take_the_median_of_unprofiled_blocks(monkeypatch):
    readers = _readers()
    recs = [_record(1.0), _record(2.0), _record(4.0),
            _record(100.0, profiled=True)]
    monkeypatch.setattr(tracing, "blocks", lambda: recs)
    want = {"host_issue_ms_per_step": 20.0, "ortho_ms_per_step": 0.4,
            "pop_control_ms_per_step": 2.0, "force_bias_ms_per_step": 4.0,
            "inv_logdet_ms_per_step": 1.0, "exchange_ms_per_eval": 6.0}
    for name, reader in readers.items():
        assert reader.RANGES == ()
        assert reader.read(None) == pytest.approx(want[name]), name


def test_a_span_that_never_ran_reads_none(monkeypatch):
    readers = _readers()
    recs = [_record(1.0, exchange=False), _record(1.0, profiled=True)]
    monkeypatch.setattr(tracing, "blocks", lambda: recs)
    assert readers["exchange_ms_per_eval"].read(None) is None
    assert readers["ortho_ms_per_step"].read(None) == pytest.approx(0.2)
    monkeypatch.setattr(tracing, "blocks", lambda: recs[1:])
    assert all(r.read(None) is None for r in readers.values())


def test_a_port_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_tracing", lambda: None)
    readers = _readers()
    assert program_spans.start() is False
    assert all(r.read(None) is None for r in readers.values())


def test_start_turns_the_recorder_on_and_clears_it():
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    kw = dict(device="cpu", dtype="double")
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **kw)
    af = AFQMC(ham, free_electron_trial(ham, **kw),
               QMCOpts(nwalkers=8, dt=0.01, nsteps=4, nblocks=1, nstblz=2,
                       npop_control=1, rng_seed=3), device="cpu")
    tracing.disable()
    af.run_block()
    assert tracing.blocks() == []
    readers = _readers()            # each calls start() as it loads
    assert program_spans.start() and program_spans.start()
    af.run_block()
    (rec,) = program_spans.window_blocks()
    assert readers["ortho_ms_per_step"].read(None) == pytest.approx(
        rec["spans"]["ortho"]["device_s"] * 1e3 / 4)
    assert readers["host_issue_ms_per_step"].read(None) > 0
    assert readers["force_bias_ms_per_step"].read(None) is None  # lanes
    program_spans.start()
    assert tracing.blocks() == []
