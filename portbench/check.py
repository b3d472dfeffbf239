"""What decides ``correct``: the program's blocks against the plain reference.

A comb population control every step draws each walker's parent from the
cumulative weights of all walkers, so the program (float32) and a
reference (float64) that each ran a whole block on their own would part
at the first tooth that falls within rounding of a boundary, and every
walker after it would follow. So the check follows the program step by
step from the program's own state, over the sampled blocks of the window:

* ``Capture`` records, inside a sampled block, the state that enters each
  population control with its uniform and the state it returns
  (``walkers.pop_control.pop_control``), and the state that enters each
  mixed-estimator update (``estimators.mixed.update``);
* the propagation stage: from the state that ends step i - 1 (the block's
  start state for the first step) the reference re-orthogonalises (on
  ``step % nstblz == 0``), propagates with the block's draws, takes the
  hybrid weight and the weight cap, and is compared with the state that
  enters step i's population control: ``phi_gap``, ``weight_gap``,
  ``ehyb_gap``;
* the comb: the parents from the program's own weights and the step's
  uniform, in float64; every walker of the returned state must equal its
  parent (or, where a tooth lies within ``COMB_MARGIN`` of a boundary,
  the neighbour on the other side) exactly, with weight 1 and the old
  weight kept: ``comb_mismatch``;
* the mixed estimator: each walker's local energy (total, one-body,
  two-body; ``estimators.mixed._energies``) on the energy steps, as a share
  of the component's median size: ``energy_gap``;
* the block's output row against the reference's, whose step sums the
  reference computes from each step's state: ``row_gap``;
* the start: ``AFQMC``'s walkers before the first block are the trial's
  orbitals with weight 1, exactly: ``start_mismatch``.

The control runs the same reference in complex64 with TF32 products in
the reference's place, on the same inputs.

The three names that ``Capture`` wraps (``SEAMS``) are part of the
yardstick: a program that no longer calls through one of them (inlined,
renamed, fused, or inside a CUDA graph) cannot be followed, and the check
raises ``SeamMissing`` naming it, never a numerical verdict.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import afqmc as ref

# A comb tooth this close to a cumulative boundary (as a share of the
# teeth's spacing) may fall on either side in float32.
COMB_MARGIN = 4e-3
ROW_FIELDS = ("Weight", "WeightFactor", "ETotal", "E1Body", "E2Body",
              "EHybrid", "Overlap")
# Their columns in ``AFQMC``'s output row (``MixedReporter.block_row``).
ROW_INDEX = {"WeightFactor": 1, "Weight": 2, "ETotal": 5, "E1Body": 6,
             "E2Body": 7, "EHybrid": 8, "Overlap": 9}
NUMBERS = ("start_mismatch", "phi_gap", "weight_gap", "ehyb_gap",
           "comb_mismatch", "energy_gap", "row_gap")


# The program's names the check records through: (module, attribute).
SEAMS = (("pauxy_tpu_torch.walkers.pop_control", "pop_control"),
         ("pauxy_tpu_torch.estimators.mixed", "update"),
         ("pauxy_tpu_torch.estimators.mixed", "_energies"))


class SeamMissing(Exception):
    """The program no longer calls through a name the check records
    through; the check cannot follow it. Not a numerical fault, and not a
    ``RuntimeError``, so the window does not count it as a failed block."""


def _seam(i: int) -> str:
    return ".".join(SEAMS[i])


def verify_seams():
    """Raise ``SeamMissing`` if a seam's name has gone from the program."""
    import importlib

    for i, (module, name) in enumerate(SEAMS):
        if not callable(getattr(importlib.import_module(module), name,
                                None)):
            raise SeamMissing(f"the check's seam {_seam(i)} is gone from "
                              "the program; the check records each step "
                              "through it and cannot follow the blocks")


def _seam_count(index: int, what: str, got: int, want: int):
    if got != want:
        raise SeamMissing(
            f"block {index}: the check's seam {what} was called {got} times "
            f"for {want} steps; the program no longer routes its steps "
            "through it (inlined, renamed, fused or graphed), so the check "
            "cannot follow the block. This is not a numerical fault.")


class Capture:
    """Records one block's per-step states by wrapping the program's
    population control, mixed-estimator update and local energies
    (``SEAMS``) for its duration."""

    def __init__(self):
        self.pops, self.updates, self.energies = [], [], []
        self._restore = []

    def __enter__(self):
        verify_seams()
        from pauxy_tpu_torch.estimators import mixed
        from pauxy_tpu_torch.walkers import pop_control as pc

        orig_pop, orig_update = pc.pop_control, mixed.update
        orig_energies = mixed._energies

        def pop_control(state, *args, **kwargs):
            out = orig_pop(state, *args, **kwargs)
            u = kwargs.get("uniforms", args[2] if len(args) > 2 else None)
            self.pops.append((state, u, out))
            return out

        def update(ham, trial, state, eval_energy, *args, **kwargs):
            self.updates.append((state, bool(eval_energy)))
            return orig_update(ham, trial, state, eval_energy, *args,
                               **kwargs)

        def energies(*args, **kwargs):
            out = orig_energies(*args, **kwargs)
            self.energies.append(out[:3])
            return out

        pc.pop_control, mixed.update = pop_control, update
        mixed._energies = energies
        self._restore = [(pc, "pop_control", orig_pop),
                         (mixed, "update", orig_update),
                         (mixed, "_energies", orig_energies)]
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._restore:
            setattr(mod, name, orig)
        self._restore = []
        return False


class BlockRecord:
    """A sampled block: its start state and eshift, its draws, the
    captured steps and the program's output row."""

    def __init__(self, index, step0, start, eshift, noise, capture, row):
        self.index, self.step0 = index, step0
        self.start, self.eshift = start, eshift
        self.noise, self.capture, self.row = noise, capture, row


def start_mismatch(state, trial_psia, trial_psib) -> float:
    """Elements of the initial walkers that differ from the trial's
    orbitals, plus weights that are not 1 (exact)."""
    bad = 0
    for phi, psi in ((state.phia, trial_psia), (state.phib, trial_psib)):
        bad += int((phi != psi.to(phi.dtype)[None]).sum())
    bad += int((state.weight != 1).sum())
    return float(bad)


def _chunks(n: int, size: int):
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


def _propagate(model, prev, xi, eshift, dt, ortho, cap):
    """The reference's step from ``prev`` (a program state), in blocks of
    walkers."""
    parts = []
    tw = float(prev.total_weight)
    for sl in _chunks(prev.weight.shape[0], model.walker_chunk):
        st = ref.StepIn(prev.phia[sl], prev.phib[sl], prev.weight[sl],
                        prev.hybrid_energy[sl], tw)
        parts.append(ref.propagate(model, st, xi[sl], eshift, dt,
                                   ortho=ortho, cap=cap))
    return ref.StepOut(*(torch.cat([getattr(p, f) for p in parts])
                         for f in ref.StepOut._fields))


def _stage_gaps(out: ref.StepOut, state, dt: float) -> dict:
    f64, c128 = torch.float64, torch.complex128
    rphi = torch.cat([out.phia, out.phib], -1).to(c128)
    pphi = torch.cat([state.phia, state.phib], -1).to(c128)
    num = torch.linalg.vector_norm(pphi - rphi, dim=(-2, -1))
    den = torch.linalg.vector_norm(rphi, dim=(-2, -1))
    wr = out.weight.to(f64)
    wp = state.weight.to(f64)
    eh = (state.hybrid_energy.real.to(f64) - out.hybrid_energy.real.to(f64))
    return {"phi_gap": float((num / den).max()),
            "weight_gap": float((wp - wr).abs().max() / wr.abs().mean()),
            "ehyb_gap": float(dt * eh.abs().max())}


def _comb_mismatch(pre, uniform, post, target: float, log=None) -> float:
    parents, lo, hi, total = ref.comb(pre.weight, target, float(uniform),
                                      COMB_MARGIN)
    fields = ("phia", "phib", "log_ovlp", "hybrid_energy")

    def same(idx):
        ok = torch.ones_like(parents, dtype=torch.bool)
        for f in fields:
            a, b = getattr(post, f), getattr(pre, f)[idx]
            ok &= (a == b).reshape(a.shape[0], -1).all(-1)
        return ok

    ok = same(parents) | same(lo) | same(hi)
    ok &= post.weight == 1
    ok &= post.unscaled_weight == pre.weight
    bad = float((~ok).sum())
    if bad and log is not None:
        flat = pre.phia.reshape(pre.phia.shape[0], -1)
        for i in torch.nonzero(~ok).flatten()[:4].tolist():
            got = torch.nonzero((flat == post.phia[i].reshape(1, -1))
                                .all(-1)).flatten().tolist()
            log(f"# comb walker {i}: parent {int(parents[i])} "
                f"(reach {int(lo[i])}..{int(hi[i])}), the program's "
                f"{got[:4]}, weight {float(post.weight[i])!r}, old "
                f"{float(post.unscaled_weight[i])!r} / "
                f"{float(pre.weight[i])!r}, u {float(uniform)!r}")
    if not math.isclose(float(post.total_weight), total, rel_tol=1e-5):
        bad += 1
        if log is not None:
            log(f"# comb total {float(post.total_weight)!r} against "
                f"{total!r}")
    return bad


def _energy_gap(ref_e, judged) -> float:
    """The largest gap of a walker's energy (total, one-body, two-body) as
    a share of that component's median size over the walkers."""
    gap = 0.0
    for r, p in zip(ref_e, judged):
        r = r.real.to(torch.float64)
        p = p.real.to(torch.float64)
        gap = max(gap, float((p - r).abs().max() / r.abs().median()))
    return gap


def _row_gaps(row: dict, judged) -> dict:
    return {name: abs(judged(name) - row[name]) / max(abs(row[name]), 1e-300)
            for name in ROW_FIELDS}


def check_block(model, rec: BlockRecord, mix: dict, control=None,
                log=None):
    """The numbers of one sampled block (the largest over its steps), and
    with ``control`` (the reference at the lower precision) the control's
    numbers on the same inputs, or None."""
    nsteps, dt = mix["nsteps"], mix["dt"]
    pops, updates = rec.capture.pops, rec.capture.updates
    steps = [rec.step0 + 1 + i for i in range(nsteps)]
    _seam_count(rec.index, _seam(1), len(updates), nsteps)
    _seam_count(rec.index, _seam(0), len(pops),
                sum(s % mix["npop_control"] == 0 for s in steps))
    _seam_count(rec.index, _seam(2), len(rec.capture.energies),
                sum(bool(e) for _, e in updates))
    got = {"phi_gap": 0.0, "weight_gap": 0.0, "ehyb_gap": 0.0,
           "comb_mismatch": 0.0, "energy_gap": 0.0}
    ctl = None if control is None else dict.fromkeys(
        ("phi_gap", "weight_gap", "ehyb_gap", "energy_gap"), 0.0)
    ienergy = 0
    dev = rec.start.weight.device
    sums = torch.zeros(8, dtype=torch.float64, device=dev)
    ctl_sums = torch.zeros_like(sums)
    prev = rec.start
    ipop = 0
    for i in range(nsteps):
        step = rec.step0 + 1 + i
        kw = dict(ortho=step % mix["nstblz"] == 0, cap=step > 1)
        out = _propagate(model, prev, rec.noise.xi[i], rec.eshift, dt, **kw)
        if step % mix["npop_control"] == 0:
            pre, uniform, post = pops[ipop]
            ipop += 1
            got["comb_mismatch"] += _comb_mismatch(
                pre, uniform.reshape(()).item(), post, mix["nwalkers"],
                log)
        else:
            pre = updates[i][0]
        for k, v in _stage_gaps(out, pre, dt).items():
            got[k] = max(got[k], v)
        state, eval_energy = updates[i]
        args = (state.phia, state.phib, state.weight, state.unscaled_weight,
                state.hybrid_energy, eval_energy)
        s, e_ref = ref.step_sums(model, *args)
        sums += s
        if eval_energy:
            got["energy_gap"] = max(got["energy_gap"], _energy_gap(
                e_ref, rec.capture.energies[ienergy]))
            ienergy += 1
        if control is not None:
            cout = _propagate(control, prev, rec.noise.xi[i], rec.eshift,
                              dt, **kw)
            for k, v in _stage_gaps(out, cout, dt).items():
                ctl[k] = max(ctl[k], v)
            s, e_ctl = ref.step_sums(control, *args)
            ctl_sums += s
            if eval_energy:
                ctl["energy_gap"] = max(ctl["energy_gap"],
                                        _energy_gap(e_ref, e_ctl))
        prev = state
    row = ref.block_row(sums, nsteps)
    gaps = _row_gaps(row, lambda name: float(rec.row[ROW_INDEX[name]].real))
    got["row_gap"] = max(gaps.values())
    if log is not None:
        log(f"# block {rec.index} row gaps {gaps}")
    if control is not None:
        crow = ref.block_row(ctl_sums, nsteps)
        cgaps = _row_gaps(row, lambda name: crow[name])
        ctl["row_gap"] = max(cgaps.values())
        if log is not None:
            log(f"# block {rec.index} control row gaps {cgaps}")
    return got, ctl


def check_blocks(model, records, mix: dict, control=None, log=None):
    """The largest of each number over the sampled blocks, for the program
    and (with ``control``) for the control."""
    out, ctl = {}, ({} if control is not None else None)
    for rec in records:
        got, c = check_block(model, rec, mix, control, log)
        for k, v in got.items():
            out[k] = max(out.get(k, 0.0), v)
        for k, v in (c or {}).items():
            ctl[k] = max(ctl.get(k, 0.0), v)
    return out, ctl


def control_model(built):
    """The reference in complex64 with TF32 products: the control."""
    torch.backends.cuda.matmul.allow_tf32 = True
    return built.reference(torch.complex64)


def reference_model(built):
    """The reference in complex128."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return built.reference(torch.complex128)


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers the cell's limits
    name, in NUMBERS order; a number missing or not finite fails."""
    rows, ok = [], True
    for name in NUMBERS:
        if name not in limits:
            continue
        v = numbers.get(name, math.nan)
        lim = limits[name]
        rows.append((name, v, lim))
        if not (math.isfinite(v) and v <= lim):
            ok = False
    return ok, rows


def judge_control(control: dict, limits: dict):
    """The control's verdict by ``judge``. The control is the reference
    itself in the program's place: it starts from the trial's orbitals and
    combs with the reference's own comb, so its ``start_mismatch`` and
    ``comb_mismatch`` are 0 by construction; the other numbers are its
    readings against the complex128 reference."""
    return judge({"start_mismatch": 0.0, "comb_mismatch": 0.0, **control},
                 limits)
