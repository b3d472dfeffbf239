"""The 3-pass bf16 split GEMM on the card, and the ``'bfloat16_3x'`` route.

It stands for no Pallas kernel: JAX's ``'bfloat16_3x'`` tier
(``pauxy_tpu/config.py:set_matmul_precision``) sends every float32 /
complex64 dot that is not pinned to HIGHEST through XLA's
``BF16_BF16_F32_X3`` algorithm. ``gemm`` launches ``csrc/gemm_bf16x3.cu``
on CUDA tensors and calls the plain version (``ops/gemm3``) on CPU tensors;
any other device, or a type the kernel does not take, raises. ``plan``
picks the route by shape before any launch: at most 8 rows or columns the
skinny route; at most 32 columns (after a transposition that puts the
small side there) the narrow wgmma tile; else the wide one. It also picks
how each operand is staged, by its strides: one TMA box a slab where the
layout allows it (a ``.real`` / ``.imag`` view at stride 2 through its
complex pairs); rows that are no whole number of 16 bytes by TMA over
groups of 2 or 4 rows; otherwise at unit stride a bulk copy a row, else
one cp.async an element.

``install_route`` registers CUDA implementations of aten ``mm``, ``bmm``,
``addmm`` and ``baddbmm`` (``torch.library``): float32 / complex64
products launch the kernel, every other type goes to the op's ``.out``
overload, whose CUDA kernel is untouched, and so does every product inside
a ``config.full_precision()`` body (JAX's HIGHEST pins).
``config.set_matmul_precision`` installs it for ``'bfloat16_3x'`` on a card
and removes it for any other tier, so ``'float32'`` and ``'bfloat16'`` pay
nothing per call. A registration at the dispatcher, not a
``TorchDispatchMode``: a mode runs Python on every op, and the lattice,
GHF and BP paths are host-bound. No fallback: a kernel that does not build
or launch, or a layout it refuses, raises out of the product.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build, gemm3

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0
# The same by route (they sum to ``launches``).
launches_by_route = {"tile": 0, "narrow": 0, "skinny": 0}

_SYMBOLS = {torch.float32: "pauxy_gemm_bf16x3_f32",
            torch.complex64: "pauxy_gemm_bf16x3_c64"}
TILE_M = 128       # rows of D a tile block (csrc kBM)
NARROW = 32        # columns (after transposition) of the narrow tile, at most
TILE_N = (16, 32, 64, 128, 256)   # a tile's columns (complex64: up to 128)
SMS = 132          # the H100's SMs: one persistent tile block each
MAX_BLOCKS = 2 ** 31 - 1   # gridDim.x, and the tiles of one launch
SKINNY = 8         # rows (after transposition) of the skinny route
SKINNY_WARPS = 8   # warps a block of the skinny route (256 threads)
# How an operand is staged (csrc Operand::flags).
KMAJ = 1    # K's stride the smaller: staged [row][k], else [k][row]
TMA = 2     # one TMA box a slab, else one cp.async an element
PAIR = 4    # float32 at stride 2, staged through its complex pairs
PLANE = 8   # of a pair, the second (imaginary) plane
CONJ = 16   # complex64 read conjugated (set per call)
SWAP = 32   # the TMA map's dims (fast, batch, slow)
BCAST = 64  # one matrix for the whole batch (stride 0, or a batch of one)
ROWS = 128  # unit stride, rows not 16-byte aligned: a bulk copy a row
GROUP2 = 256   # TMA over groups of 2 (or 4) lines of the flattened batch,
GROUP4 = 512   # a line stride of 8 (4 or 12) mod 16 bytes


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``route``: ``"skinny"`` (at most SKINNY rows
    after ``transposed``, D^T = B^T A^T when N < M; ``code`` the mode: a
    warp a column, a thread a column at K <= 32 (+ 2), the columns or the
    batch (+ 1) fastest, as B's strides run), ``"narrow"`` (a tile of
    ``code`` = 16 or 32 columns) or ``"tile"`` (64, 128 or, float32, 256;
    ``transposed`` puts the small side of a short product in the
    columns). ``flags_a`` / ``flags_b``: how A and B (after the
    transposition) are staged; ``shift_*`` the bytes from a pair's first
    element back to its complex base; ``strides`` the launch's (sab, sam,
    sak, sbb, sbk, sbn), after the transposition, in the staged unit. At
    most ``batch_chunk`` matrices a launch."""
    route: str
    code: int
    transposed: bool
    flags_a: int
    flags_b: int
    shift_a: int
    shift_b: int
    strides: tuple
    batch_chunk: int

    @property
    def skinny(self) -> int:
        return self.code if self.route == "skinny" else 0

    @property
    def bn(self) -> int:
        return 0 if self.route == "skinny" else self.code

    a_kmaj = property(lambda self: bool(self.flags_a & KMAJ))
    b_kmaj = property(lambda self: bool(self.flags_b & KMAJ))
    tma_a = property(lambda self: bool(self.flags_a & TMA))
    tma_b = property(lambda self: bool(self.flags_b & TMA))


def _k_fast(s_row: int, s_k: int, rows: int, k: int) -> bool:
    """Whether K's stride is the smaller (size-1 dimensions aside): that
    dimension runs along the threads when the tile is staged."""
    sk = abs(s_k) if k > 1 else math.inf
    sr = abs(s_row) if rows > 1 else math.inf
    return sk <= sr


def _stage(ext: tuple, st: tuple, mod16: int, plane: int, item: int,
           tile_rows: int) -> tuple[int, int, tuple]:
    """(flags, shift, strides) of one operand [B, rows, K] (extents ``ext``,
    strides ``st`` in elements, data pointer ``mod16`` bytes past 16,
    ``plane`` its place in complex pairs or -1). TMA reads it if the fast
    dimension has stride 1 (a float32 pair: 2, the pair whole in its
    storage), the base (a pair's complex base) is 16-byte aligned and the
    two other dimensions nest in 16-byte multiples; the strides passed are
    then those of the map (a size-1 or broadcast dimension nested
    anyway). A line stride that is no 16-byte multiple (rows of 93 or 257
    complex values) takes TMA over groups of 2 or 4 lines (``_group``),
    a box's line (a tile's ``tile_rows`` values of a [k][row] slab, or 16
    of [row][k]) and 16 bytes at most 256 floats.
    Else, if the fast dimension has stride 1, one bulk copy a line of the
    slab (from the 16 bytes that hold its start); else one element a copy;
    these three at the strides as they are."""
    nb, rows, k = ext
    s_b, s_r, s_k = st
    kmaj = _k_fast(s_r, s_k, rows, k)
    flags = KMAJ if kmaj else 0
    s_fast, n_fast, s_slow, n_slow = ((s_k, k, s_r, rows) if kmaj
                                      else (s_r, rows, s_k, k))
    pair = item == 4 and s_fast == 2 and n_fast > 1 and plane >= 0
    shift = 4 * plane if pair else 0
    unit = 4 if pair or item == 4 else 8      # bytes of a stride's unit
    fast_bytes = n_fast * (8 if pair else item)
    unit_fast = s_fast == 1 or n_fast == 1
    fallback = flags | ROWS if unit_fast and k > 0 else flags
    ok = k > 0 and (unit_fast or pair) and (mod16 - shift) % 16 == 0
    if not ok:
        return fallback, 0, st
    if pair:
        flags |= PAIR | (PLANE if plane else 0)
    b_slow = s_slow * unit if n_slow > 1 else -(-fast_bytes // 16) * 16
    bcast = nb == 1 or s_b == 0
    dims = [(b_slow, n_slow, "slow")]
    if not bcast:
        dims.append((s_b * unit, nb, "batch"))
    dims.sort(key=lambda d: d[0])
    span = fast_bytes
    for stride, n, _ in dims:
        if stride % 16 or stride < span:
            g = 0 if pair or (not kmaj and tile_rows * item > 1008) \
                else _group(nb, n_slow, s_slow, s_b, n_fast, item)
            if g:
                return (flags | TMA | (GROUP2 if g == 2 else GROUP4)
                        | (BCAST if bcast else 0)), 0, st
            return fallback, 0, st
        span = stride * n
    if bcast:
        flags |= BCAST
        b_batch = span          # any nested stride: the map has one matrix
    else:
        b_batch = s_b * unit
        if dims[0][2] == "batch" and b_batch < b_slow:
            flags |= SWAP
    b_slow //= unit
    b_batch //= unit
    out = ((b_batch, b_slow, s_k) if kmaj else (b_batch, s_r, b_slow))
    return flags | TMA, shift, out


def _group(nb: int, n_slow: int, s_slow: int, s_b: int, n_fast: int,
           item: int) -> int:
    """G for TMA over groups of G lines of an operand at unit fast stride
    whose line stride (``s_slow`` elements) is no 16-byte multiple but G
    times it is (G = 2 or 4), else 0: the lines must not overlap, the
    batch must stack its matrices' lines evenly (or be one matrix), and
    the flattened lines must fill whole groups (no box reads past the
    operand)."""
    g = 16 // math.gcd(16, s_slow * item)
    bcast = nb == 1 or s_b == 0
    if g not in (2, 4) or s_slow < n_fast or not (
            bcast or s_b == n_slow * s_slow):
        return 0
    return g if ((1 if bcast else nb) * n_slow) % g == 0 else 0


@functools.lru_cache(maxsize=4096)
def _plan(shape_a: tuple, stride_a: tuple, info_a: tuple, shape_b: tuple,
          stride_b: tuple, info_b: tuple, item: int) -> Plan:
    nb, m, k = shape_a
    n = shape_b[2]
    if min(m, n) <= SKINNY:
        transposed = n < m
        cols = m if transposed else n
        # B's batch and column strides after the transposition.
        s_batch, s_col = ((stride_a[0], stride_a[1]) if transposed
                          else (stride_b[0], stride_b[2]))
        batch_fast = nb > 1 and (cols == 1 or abs(s_batch) < abs(s_col))
        strides = ((stride_b[0], stride_b[2], stride_b[1], stride_a[0],
                    stride_a[2], stride_a[1]) if transposed
                   else (*stride_a, *stride_b))
        return Plan(route="skinny", code=1 + 2 * (k <= 32) + batch_fast,
                    transposed=transposed, flags_a=0, flags_b=0, shift_a=0,
                    shift_b=0, strides=strides,
                    batch_chunk=max(1, MAX_BLOCKS * SKINNY_WARPS
                                    // max(cols, 1)))
    transposed = n > m and m < TILE_M
    if transposed:
        rows, cols = n, m
        # A' = B^T [B, n, k], B' = A^T [B, k, m].
        ga, sa, ia = (nb, n, k), (stride_b[0], stride_b[2], stride_b[1]), \
            info_b
        gb, sb, ib = (nb, m, k), (stride_a[0], stride_a[1], stride_a[2]), \
            info_a
    else:
        rows, cols = m, n
        ga, sa, ia = (nb, m, k), tuple(stride_a), info_a
        gb, sb, ib = (nb, n, k), (stride_b[0], stride_b[2], stride_b[1]), \
            info_b
    # The narrowest tile that holds the columns (complex64: at most 128);
    # a wide tile halved (not below 64) while the product has tiles for
    # fewer than half the card's SMs.
    widest = TILE_N[-2] if item == 8 else TILE_N[-1]
    bn = next(w for w in TILE_N if w >= cols or w == widest)
    while bn > 64 and 2 * nb * -(-rows // TILE_M) * -(-cols // bn) < SMS:
        bn //= 2
    fa, sha, (sab, sam, sak) = _stage(ga, sa, *ia, item, TILE_M)
    fb, shb, (sbb, sbn, sbk) = _stage(gb, sb, *ib, item, bn)
    tiles = -(-rows // TILE_M) * -(-cols // bn)
    return Plan(route="narrow" if bn <= NARROW else "tile", code=bn,
                transposed=transposed, flags_a=fa, flags_b=fb, shift_a=sha,
                shift_b=shb, strides=(sab, sam, sak, sbb, sbk, sbn),
                batch_chunk=max(1, MAX_BLOCKS // tiles))


def _pair_plane(t: torch.Tensor) -> int:
    """Of a float32 view with even strides (a complex tensor's ``.real`` or
    ``.imag``, or any such view): its plane (the storage offset's parity)
    when its storage holds the pair of every element whole, else -1."""
    off = t.storage_offset()
    plane = off % 2
    last = off
    for n, s in zip(t.shape, t.stride()):
        if n > 1:
            if s % 2:
                return -1
            last += (n - 1) * s
    return plane if last + 1 - plane < t.untyped_storage().nbytes() // 4 \
        else -1


def _geometry(t: torch.Tensor) -> tuple[tuple, tuple]:
    """t's shape and strides as a batch: a matrix is a batch of one."""
    if t.dim() == 2:
        return (1, *t.shape), (0, *t.stride())
    return tuple(t.shape), t.stride()


def _info(t: torch.Tensor, stride: tuple) -> tuple[int, int]:
    """What ``_plan`` reads of t besides its shape and strides."""
    plane = (_pair_plane(t) if t.dtype is torch.float32 and 2 in stride
             else -1)
    return t.data_ptr() % 16, plane


def plan(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The route and staging of ``gemm(a, b)``, a [B, m, k] (or [m, k]), b
    [B, k, n] (or [k, n]); derived once per shapes, strides, alignment and
    plane."""
    ga, sa = _geometry(a)
    gb, sb = _geometry(b)
    return _plan(ga, sa, _info(a, sa), gb, sb, _info(b, sb),
                 a.element_size())


def _plain_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` without torch's lazy negation (the kernel reads conjugation
    in place, not a negated view)."""
    return t.resolve_neg() if t.is_neg() else t


_fns = {}


def _current(dev: int) -> bool:
    """Whether CUDA device ``dev`` is the current one."""
    return torch._C._cuda_getDevice() == dev


def _stream(dev: int) -> int:
    """Device ``dev``'s current stream, as the launch takes it."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _fn(dtype):
    """The kernel's ctypes function for ``dtype``, resolved once."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = _fns[dtype] = getattr(cuda_build.library(), _SYMBOLS[dtype])
    return fn


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha a @ b + beta c: a [B, m, k] and b [B, k, n] (or both
    matrices) float32 or complex64 of one type, any strides (0
    broadcasts); c broadcastable to the result, read only when beta != 0.
    A new contiguous [B, m, n] (or [m, n])."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm3.gemm(a, b, c, alpha, beta)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gemm_bf16x3: tensors on {a.device} and "
                         f"{b.device}, want one CUDA device")
    if a.dtype not in _SYMBOLS or b.dtype != a.dtype:
        raise TypeError(f"gemm_bf16x3: needs float32 or complex64 operands "
                        f"of one type, got {a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim() or (
            a.dim() == 3 and a.shape[0] != b.shape[0]) \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"gemm_bf16x3: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, want [B, m, k] and [B, k, n]")
    shape = (*a.shape[:-1], b.shape[-1])
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    a, b = _plain_layout(a), _plain_layout(b)
    use_c = c is not None and beta != 0
    if use_c:
        if c.dtype != a.dtype or c.device != a.device:
            raise TypeError(f"gemm_bf16x3: c is {c.dtype} on {c.device}")
        c = _plain_layout(c.resolve_conj()).expand(shape)
    _launch(a, b, c if use_c else None, complex(alpha), complex(beta), out)
    return out


def _launch(a, b, c, alpha: complex, beta: complex, out) -> None:
    global launches
    ga, sa = _geometry(a)
    gb, sb = _geometry(b)
    pl = _plan(ga, sa, _info(a, sa), gb, sb, _info(b, sb), a.element_size())
    nb, m, k = ga
    n = gb[2]
    item = a.element_size()
    _, sd = _geometry(out)
    sc = _geometry(c)[1] if c is not None else (0, 0, 0)
    conj_a, conj_b = CONJ * a.is_conj(), CONJ * b.is_conj()
    pa, pb = a.data_ptr(), b.data_ptr()
    if pl.transposed:
        # D^T = B^T A^T.
        pa, pb, conj_a, conj_b = pb, pa, conj_b, conj_a
        m, n = n, m
        sc = (sc[0], sc[2], sc[1])
        sd = (sd[0], sd[2], sd[1])
    pa -= pl.shift_a
    pb -= pl.shift_b
    pc = c.data_ptr() if c is not None else None
    pd = out.data_ptr()
    fn = _fn(a.dtype)
    dev = a.device.index
    if not _current(dev):
        with torch.cuda.device(dev):
            return _launch(a, b, c, alpha, beta, out)
    stream = _stream(dev)
    fa, fb = pl.flags_a | conj_a, pl.flags_b | conj_b
    sab, sam, sak, sbb, sbk, sbn = pl.strides
    args = (k, sab, sam, sak, sbb, sbk, sbn, *sc, *sd, alpha.real,
            alpha.imag, beta.real, beta.imag, fa, fb, pl.code, stream)
    # A launch, or one a chunk of the batch past the grid's limits (the
    # pointers moved by the batch strides; a broadcast operand stays).
    za = 0 if pl.flags_a & BCAST else sab * (4 if pl.flags_a & PAIR else item)
    zb = 0 if pl.flags_b & BCAST else sbb * (4 if pl.flags_b & PAIR else item)
    for z in range(0, nb, pl.batch_chunk):
        rc = fn(pa + z * za, pb + z * zb,
                None if pc is None else pc + z * sc[0] * item,
                pd + z * sd[0] * item, min(pl.batch_chunk, nb - z), m, n,
                *args)
        cuda_build.check(rc, "gemm_bf16x3")
        launches += 1
        launches_by_route[pl.route] += 1
    return None


# aten's forms (matrices go to the kernel as they are: a batch of one).
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gemm(a, b)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gemm(a, b)


def addmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, beta=1,
          alpha=1) -> torch.Tensor:
    return gemm(a, b, c, alpha, beta)


def baddbmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, beta=1,
            alpha=1) -> torch.Tensor:
    return gemm(a, b, c, alpha, beta)


# ---- the route -------------------------------------------------------------

# The torch.library registration while the route is installed.
_route = None


def _split(*ts: torch.Tensor) -> bool:
    """Whether a product takes the kernel: operands of one type, float32 or
    complex64, outside a ``config.full_precision()`` body."""
    return (ts[0].dtype in _SYMBOLS and all(t.dtype == ts[0].dtype
                                            for t in ts)
            and not config.pinned())


def _mm(a, b):
    if _split(a, b):
        return gemm(a, b)
    return torch.ops.aten.mm.out(
        a, b, out=a.new_empty((a.shape[0], b.shape[1])))


def _bmm(a, b):
    if _split(a, b):
        return gemm(a, b)
    return torch.ops.aten.bmm.out(
        a, b, out=a.new_empty((a.shape[0], a.shape[1], b.shape[2])))


def _addmm(c, a, b, *, beta=1, alpha=1):
    if _split(c, a, b):
        return gemm(a, b, c, alpha, beta)
    return torch.ops.aten.addmm.out(
        c, a, b, beta=beta, alpha=alpha,
        out=a.new_empty((a.shape[0], b.shape[1])))


def _baddbmm(c, a, b, *, beta=1, alpha=1):
    if _split(c, a, b):
        return gemm(a, b, c, alpha, beta)
    return torch.ops.aten.baddbmm.out(
        c, a, b, beta=beta, alpha=alpha,
        out=a.new_empty((a.shape[0], a.shape[1], b.shape[2])))


def install_route(key: str = "CUDA") -> None:
    """Send aten mm / bmm / addmm / baddbmm on ``key``'s tensors through
    ``_split``'s choice (the tests use ``"CPU"``, where ``gemm`` runs the
    plain version). Installing twice changes nothing."""
    global _route
    if _route is not None:
        return
    lib = torch.library.Library("aten", "IMPL")
    with warnings.catch_warnings():
        # torch warns, once a process, that a kernel is overridden.
        warnings.simplefilter("ignore", UserWarning)
        for name, fn in (("mm", _mm), ("bmm", _bmm), ("addmm", _addmm),
                         ("baddbmm", _baddbmm)):
            lib.impl(name, fn, key)
    _route = lib


def remove_route() -> None:
    """Give the four ops their own kernels back."""
    global _route
    if _route is not None:
        _route._destroy()
        _route = None


def route_installed() -> bool:
    return _route is not None


def route_live() -> bool:
    """Whether a float32 / complex64 product takes the kernel now: the route
    installed and no ``config.full_precision()`` body open."""
    return _route is not None and not config.pinned()
