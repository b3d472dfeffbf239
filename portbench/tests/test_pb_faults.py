"""The check fails a run whose timed path is broken underneath: the
harness run on the CPU (past its look for a card) with a fault planted in
the program, once for each fault the cells can have. The cells run on one
card, so there is no exchange between cards to leave out."""

import pytest
import torch

from pb_helpers import run_cell


def _step_unchanged(monkeypatch):
    from pauxy_tpu_torch.propagation import continuous

    monkeypatch.setattr(continuous.Continuous, "propagate",
                        lambda self, trial, state, *a, **k: state)


def _half_batch_energy(monkeypatch):
    """The local energies of the second half of the walkers replaced by
    the first half's mean."""
    from pauxy_tpu_torch.estimators import mixed

    orig = mixed._energies

    def energies(ham, trial, state, *a, **k):
        etot, e1b, e2b, g2 = orig(ham, trial, state, *a, **k)
        h = etot.shape[0] // 2
        out = []
        for e in (etot, e1b, e2b):
            e = e.clone()
            e[h:] = e[:h].mean()
            out.append(e)
        return (*out, g2)

    monkeypatch.setattr(mixed, "_energies", energies)


def _answer_altered(monkeypatch):
    """One walker's exp(VHS) phi off by 1e-3 where the series makes it."""
    from pauxy_tpu_torch.propagation import generic, planewave

    orig = generic.taylor_series

    def series(vhs, phi, order, taylor_impl):
        out = orig(vhs, phi, order, taylor_impl).clone()
        out[0] *= 1.001
        return out

    monkeypatch.setattr(generic, "taylor_series", series)
    monkeypatch.setattr(planewave, "taylor_series", series)


def _comb_wrong_parent(monkeypatch):
    """Population control gives walker 0 the last walker's parent."""
    from pauxy_tpu_torch.walkers import pop_control as pc

    orig = pc.global_parents

    def parents(*a, **k):
        p, w, t = orig(*a, **k)
        p = p.clone()
        p[0] = p[-1]
        return p, w, t

    monkeypatch.setattr(pc, "global_parents", parents)


FAULTS = {"step_unchanged": _step_unchanged,
          "half_batch_energy": _half_batch_energy,
          "answer_altered": _answer_altered,
          "comb_wrong_parent": _comb_wrong_parent}


@pytest.mark.parametrize("workload", ["c6h6_dz.fp32",
                                      "ueg14_rs1.taylor_kernel"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_check(small_registry, monkeypatch, workload,
                               fault):
    torch.manual_seed(0)
    FAULTS[fault](monkeypatch)
    res = run_cell(small_registry, workload)
    assert not res.correct, res.checks


def test_a_step_that_bypasses_a_seam_is_named(small_registry, monkeypatch):
    """A program that no longer calls its estimator update through the
    module's name (as a fused or graphed step would not) stops the check
    with ``SeamMissing`` naming the seam, not with a numerical verdict."""
    from pauxy_tpu_torch.estimators import mixed
    from pauxy_tpu_torch.qmc import afqmc

    from portbench import check

    class Bypass:
        """The module, with ``update`` bound before the check wraps it."""

        update = staticmethod(mixed.update)

        def __getattr__(self, name):
            return getattr(mixed, name)

    monkeypatch.setattr(afqmc, "mixed", Bypass())
    with pytest.raises(check.SeamMissing, match="estimators.mixed.update"):
        run_cell(small_registry, "c6h6_dz.fp32")


def test_a_seam_gone_is_named_before_the_window(small_registry,
                                                monkeypatch):
    from pauxy_tpu_torch.estimators import mixed

    from portbench import check

    monkeypatch.delattr(mixed, "_energies")
    with pytest.raises(check.SeamMissing, match="mixed._energies"):
        run_cell(small_registry, "ueg14_rs1.taylor_kernel")
