"""The fused Taylor exp(VHS)-apply kernels and their plain versions.

Counterpart of ``pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas``:
phi <- sum_{k <= order} VHS^k phi / k! per walker, the term kept on chip and
VHS streamed once per order. ``apply_taylor`` launches the CUDA kernel of
``csrc/taylor.cu`` on a CUDA tensor with M up to ``max_m(dtype)`` and calls
``apply_taylor_plain`` on a CPU tensor; any other device, a larger M, or a
CUDA tensor the kernel does not take, raises. The propagators choose by
shape (``fits``) before any launch and send a larger M to the plain
series.

``lowp=True`` is the TPU kernel's bf16-multiplicand branch: V's planes
rounded once to bf16, each order's term rounded to bf16, the four real
products accumulated in float32, the term scaled by 1/k in float32 and
summed in float32, the result cast to phi's type (a complex128 caller's
inputs go in as float32 planes, as JAX's ``pad0`` casts them). Its kernel
is ``csrc/taylor_bf16.cu`` (tensor-core ``mma.sync``), with its own cap
``max_m_bf16`` and its own launch count ``launches_bf16``. It has two
routes, chosen by shape in ``route_bf16`` before any launch: "resident"
(each walker's V read once and held on chip by a cluster of 1, 2, 4 or 8
CTAs, up to ``max_m_resident(C)``) and "streaming" (V read once an order,
past that cap up to ``max_m_bf16``); each counts its launches apart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops.cuda_build import round_up

# Kernel launches so far (the float32 kernel's, the bf16 kernel's); a run
# can show that its path used the kernel.
launches = 0
launches_bf16 = 0
# The bf16 kernel's launches by route (they sum to launches_bf16).
launches_bf16_resident = 0
launches_bf16_streaming = 0

_SYMBOLS = {torch.complex64: "pauxy_taylor_c64",
            torch.complex128: "pauxy_taylor_c128"}

# csrc/taylor.cu's tiles: rows (TM) and columns (TN) a thread owns, VHS
# columns a slab holds (KS) and a slab row's stride (KSP); ring stages;
# threads a block at most, by type.
TILES = {torch.complex64: (4, 4, 16, 18), torch.complex128: (4, 4, 8, 9)}
STAGES = 2
MAX_THREADS = {torch.complex64: 640, torch.complex128: 320}


def smem_bytes(m: int, cb: int, dtype: torch.dtype) -> int:
    """Shared memory of a block of ``cb`` columns (TaylorLayout in
    csrc/taylor.cu): the term [TR, cb], the running sum [MP, cb] and the
    VHS ring [STAGES, MP, KSP], MP = M padded to TM, TR = max(MP, M padded
    to KS)."""
    tm, _, ks, ksp = TILES[dtype]
    mp = round_up(m, tm)
    tr = max(mp, round_up(m, ks))
    return (tr * cb + mp * cb + STAGES * mp * ksp) * dtype.itemsize


def threads(m: int, cb: int, dtype: torch.dtype) -> int:
    """Threads of a block of ``cb`` columns: one per TM x TN tile, rounded
    up to whole warps."""
    tm, tn, _, _ = TILES[dtype]
    return round_up(round_up(m, tm) // tm * (cb // tn), 32)


@functools.lru_cache(maxsize=None)
def plan(m: int, ncol: int, dtype: torch.dtype) -> int:
    """Columns of a part, a multiple of TN: all C columns (padded to TN) in
    one block when the threads and shared memory allow, else the fewest
    equal parts that fit. Raises ValueError when not even one column group
    fits (M > ``max_m``). Derived once per shape and type."""
    _, tn, _, _ = TILES[dtype]
    parts = 1
    while True:
        cb = round_up(-(-ncol // parts), tn)
        if (threads(m, cb, dtype) <= MAX_THREADS[dtype]
                and smem_bytes(m, cb, dtype) <= cuda_build.SMEM_MAX):
            return cb
        if cb == tn:
            raise ValueError(f"apply_taylor: M = {m} > {max_m(dtype)}, the "
                             f"largest the kernel takes in {dtype}")
        parts += 1


@functools.lru_cache(maxsize=None)
def max_m(dtype: torch.dtype) -> int:
    """Largest M the kernel launches for ``dtype``: one column group and the
    VHS ring fit a block (656 in complex64, 556 in complex128). Derived
    once per type."""
    _, tn, _, _ = TILES[dtype]
    m = 1
    while (smem_bytes(m + 1, tn, dtype) <= cuda_build.SMEM_MAX
           and threads(m + 1, tn, dtype) <= MAX_THREADS[dtype]):
        m += 1
    return m


# csrc/taylor_bf16.cu: M and the contraction padded to BF16_TILE rows, C
# to BF16_COLS columns a column tile; a term row's stride in bf16 values is
# M padded + BF16_SKEW (bank spread of the B-fragment loads).
BF16_TILE = 16
BF16_COLS = 8
BF16_SKEW = 8
BF16_TYPES = (torch.complex64, torch.complex128)


def smem_bytes_bf16(m: int, cb: int) -> int:
    """Shared memory of a bf16 block of ``cb`` columns: the term's two
    bf16 planes twice (this order's and the next), [cb][MP + SKEW] each,
    and the running sum's two float32 planes [MP][cb]."""
    mp = round_up(m, BF16_TILE)
    return 2 * 2 * cb * (mp + BF16_SKEW) * 2 + 2 * mp * cb * 4


@functools.lru_cache(maxsize=None)
def plan_bf16(m: int, ncol: int) -> int:
    """Columns of a bf16 part, a multiple of BF16_COLS: all C columns in
    one block when the shared memory allows, else the fewest equal parts
    that fit. Raises ValueError past ``max_m_bf16``."""
    parts = 1
    while True:
        cb = round_up(-(-ncol // parts), BF16_COLS)
        if smem_bytes_bf16(m, cb) <= cuda_build.SMEM_MAX:
            return cb
        if cb == BF16_COLS:
            raise ValueError(f"apply_taylor: M = {m} > {max_m_bf16()}, the "
                             f"largest the bf16 kernel takes")
        parts += 1


@functools.lru_cache(maxsize=None)
def max_m_bf16() -> int:
    """Largest M the bf16 kernel launches for: one column tile's term and
    sums fit a block (1808)."""
    m = BF16_TILE
    while smem_bytes_bf16(m + BF16_TILE, BF16_COLS) <= cuda_build.SMEM_MAX:
        m += BF16_TILE
    return m


# The resident route: at most BF16_RES_TILES row tiles of BF16_TILE a CTA
# (a warp each), clusters of BF16_CLUSTERS CTAs, at most BF16_RES_COLS
# columns (the accumulators and the running sum live in registers).
BF16_RES_TILES = 16
BF16_CLUSTERS = (1, 2, 4, 8)
BF16_RES_COLS = 32


def smem_bytes_resident(m: int, cb: int, tiles: int) -> int:
    """Shared memory of a resident CTA: the term's two bf16 planes twice,
    [cb][MP + SKEW] each, and V's slab of ``tiles`` row tiles, two bf16
    planes [tiles * TILE][MP + SKEW]."""
    kp = round_up(m, BF16_TILE) + BF16_SKEW
    return 2 * 2 * cb * kp * 2 + 2 * tiles * BF16_TILE * kp * 2


class Bf16Route(NamedTuple):
    """How the bf16 kernel takes a shape: ``route`` "resident" or
    "streaming"; ``cb`` the columns of a part (C padded to 8 when
    resident, ``plan_bf16``'s when streaming); ``cluster`` the CTAs a
    walker and ``tiles`` the row tiles a CTA (resident; 1 and 0 when
    streaming)."""
    route: str
    cb: int
    cluster: int
    tiles: int


def resident_plan(m: int, ncol: int, cluster: int) -> Bf16Route | None:
    """The resident route with ``cluster`` CTAs a walker, or None where a
    CTA's share of V and the term do not fit (or C > BF16_RES_COLS)."""
    cb = round_up(ncol, BF16_COLS)
    tiles = -(-round_up(m, BF16_TILE) // BF16_TILE // cluster)
    if (cb <= BF16_RES_COLS and tiles <= BF16_RES_TILES
            and smem_bytes_resident(m, cb, tiles) <= cuda_build.SMEM_MAX):
        return Bf16Route("resident", cb, cluster, tiles)
    return None


@functools.lru_cache(maxsize=None)
def route_bf16(m: int, ncol: int) -> Bf16Route:
    """The bf16 kernel's route for [.., M, M] x [.., M, C]: resident with
    the smallest cluster that holds V when one does, else streaming
    (raises ValueError past ``max_m_bf16``). Derived once per shape."""
    for cluster in BF16_CLUSTERS:
        plan = resident_plan(m, ncol, cluster)
        if plan is not None:
            return plan
    return Bf16Route("streaming", plan_bf16(m, ncol), 1, 0)


@functools.lru_cache(maxsize=None)
def max_m_resident(ncol: int) -> int:
    """Largest M the resident route takes at C = ``ncol`` (0 for none):
    592 at C <= 8, 512 at C <= 16, 496 at C <= 24, 432 at C <= 32.
    Feasibility falls monotonically with M, so the route is resident
    exactly up to here."""
    m = 0
    while resident_plan(m + 1, ncol, BF16_CLUSTERS[-1]) is not None:
        m += 1
    return m


def fits(m: int, dtype: torch.dtype, lowp: bool = False) -> bool:
    """Whether a propagator sends an [.., M, M] VHS of ``dtype`` to
    ``apply_taylor`` (a type the kernel does not take goes there too,
    and is refused)."""
    if lowp:
        return dtype not in BF16_TYPES or m <= max_m_bf16()
    return dtype not in TILES or m <= max_m(dtype)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 (nearest, ties to even), kept as
    float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def apply_taylor_plain(vhs: torch.Tensor, phi: torch.Tensor,
                       order: int = 6, lowp: bool = False) -> torch.Tensor:
    """Plain version, also the propagators' "xla" route: the series as
    batched matmuls, each term scaled by 1/k as the kernel scales it.
    vhs [w, M, M], phi [w, M, C]. With ``lowp`` the bf16 tier: V and each
    term rounded to bf16 and multiplied in float32 (a product of two bf16
    values is exact in float32, so this is bf16 multiplicands with float32
    sums), four real products an order."""
    if lowp:
        f32 = torch.float32
        vr, vi = _round_bf16(vhs.real.to(f32)), _round_bf16(vhs.imag.to(f32))
        tr, ti = phi.real.to(f32), phi.imag.to(f32)
        accr, acci = tr, ti
        for k in range(1, order + 1):
            a, b = _round_bf16(tr), _round_bf16(ti)
            inv = 1.0 / k
            tr = (torch.matmul(vr, a) - torch.matmul(vi, b)) * inv
            ti = (torch.matmul(vr, b) + torch.matmul(vi, a)) * inv
            accr = accr + tr
            acci = acci + ti
        return torch.complex(accr, acci).to(phi.dtype)
    term = out = phi
    for k in range(1, order + 1):
        term = torch.matmul(vhs, term) * (1.0 / k)
        out = out + term
    return out


def _apply_taylor_bf16(vhs: torch.Tensor, phi: torch.Tensor, order: int,
                       route: str | None = None) -> torch.Tensor:
    """The bf16 kernel's launch: complex64 planes in (a complex128 input
    cast, as JAX casts it), the result cast to phi's type. The route is
    ``route_bf16``'s; ``route="streaming"`` forces the streaming kernel,
    for the tests and the card's timings only."""
    global launches_bf16, launches_bf16_resident, launches_bf16_streaming
    m = vhs.shape[-1]
    v64 = vhs.to(torch.complex64)
    p64 = phi.to(torch.complex64)
    w, _, ncol = phi.shape
    out = torch.empty(p64.shape, dtype=torch.complex64, device=phi.device)
    if w == 0 or m == 0 or ncol == 0:
        return out.to(phi.dtype)
    if route not in (None, "streaming"):
        raise ValueError(f"apply_taylor: route {route!r}")
    plan = (route_bf16(m, ncol) if route is None
            else Bf16Route("streaming", plan_bf16(m, ncol), 1, 0))
    lib = cuda_build.library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            rc = lib.pauxy_taylor_bf16_resident(
                v64.data_ptr(), p64.data_ptr(), out.data_ptr(), w, m, ncol,
                order, plan.cluster, plan.tiles, stream)
        else:
            rc = lib.pauxy_taylor_bf16(v64.data_ptr(), p64.data_ptr(),
                                       out.data_ptr(), w, m, ncol, order,
                                       plan.cb, stream)
    cuda_build.check(rc, f"apply_taylor(lowp=True) {plan.route}")
    launches_bf16 += 1
    if plan.route == "resident":
        launches_bf16_resident += 1
    else:
        launches_bf16_streaming += 1
    return out.to(phi.dtype)


def apply_taylor(vhs: torch.Tensor, phi: torch.Tensor,
                 order: int = 6, lowp: bool = False) -> torch.Tensor:
    """exp(vhs) phi to ``order``: vhs [w, M, M], phi [w, M, C], complex64
    or complex128, contiguous, on one device. Returns [w, M, C]. With
    ``lowp`` the bf16 tier (``csrc/taylor_bf16.cu`` on the card)."""
    global launches
    if phi.device.type == "cpu":
        return apply_taylor_plain(vhs, phi, order, lowp)
    if phi.device.type != "cuda" or vhs.device != phi.device:
        raise ValueError(f"apply_taylor: tensors on {vhs.device} and "
                         f"{phi.device}, want one CUDA device")
    if phi.dtype not in _SYMBOLS or vhs.dtype != phi.dtype:
        raise TypeError(f"apply_taylor: needs complex64 or complex128 for "
                        f"both, got {vhs.dtype} and {phi.dtype}")
    if (vhs.dim() != 3 or phi.dim() != 3 or vhs.shape[1] != vhs.shape[2]
            or vhs.shape[:2] != phi.shape[:2]):
        raise ValueError(f"apply_taylor: shapes {tuple(vhs.shape)} and "
                         f"{tuple(phi.shape)}, want [w, M, M] and [w, M, C]")
    if not (vhs.is_contiguous() and phi.is_contiguous()):
        raise ValueError("apply_taylor: needs contiguous tensors")
    if order < 0:
        raise ValueError(f"apply_taylor: order {order} < 0")
    if lowp:
        return _apply_taylor_bf16(vhs, phi, order)
    w, m, ncol = phi.shape
    # 16-byte copies of VHS rows: complex128 always, complex64 when its
    # rows start on 16 bytes.
    aligned = vhs.data_ptr() % 16 == 0
    if phi.dtype == torch.complex128 and not aligned:
        raise ValueError("apply_taylor: complex128 VHS not 16-byte aligned")
    vec = int(phi.dtype == torch.complex128 or (aligned and m % 2 == 0))
    out = torch.empty_like(phi)
    if w == 0 or m == 0 or ncol == 0:
        return out
    cb = plan(m, ncol, phi.dtype)
    fn = getattr(cuda_build.library(), _SYMBOLS[phi.dtype])
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vhs.data_ptr(), phi.data_ptr(), out.data_ptr(), w, m, ncol,
                order, cb, vec, stream)
    cuda_build.check(rc, "apply_taylor")
    launches += 1
    return out
