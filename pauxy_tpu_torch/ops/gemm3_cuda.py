"""The 3-pass bf16 split GEMM on the card, and the ``'bfloat16_3x'`` route.

It stands for no Pallas kernel: JAX's ``'bfloat16_3x'`` tier
(``pauxy_tpu/config.py:set_matmul_precision``) sends every float32 /
complex64 dot that is not pinned to HIGHEST through XLA's
``BF16_BF16_F32_X3`` algorithm. ``gemm`` launches ``csrc/gemm_bf16x3.cu``
on CUDA tensors (``plan`` stages each operand by its strides, cuts the
grid, and sends a product of at most 8 rows or columns to the skinny
route) and calls the plain version (``ops/gemm3``) on CPU tensors; any
other device, or a type the kernel does not take, raises.

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
or launch raises out of the product.
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

_SYMBOLS = {torch.float32: "pauxy_gemm_bf16x3_f32",
            torch.complex64: "pauxy_gemm_bf16x3_c64"}
TILE = 64          # rows and columns of D a block (csrc kTile)
MAX_GRID = 65535   # gridDim.y and gridDim.z
MAX_BLOCKS = 2 ** 31 - 1   # gridDim.x
SKINNY = 8         # rows (after transposition) of the skinny route
SKINNY_WARPS = 8   # warps a block of the skinny route (256 threads)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``skinny`` > 0: at most SKINNY rows after
    ``transposed`` (D^T = B^T A^T when N < M), a warp a column (a thread a
    column at K <= 32: mode + 2) with the columns or the batch (mode + 1)
    fastest, as B's strides run; ``skinny`` = 0: 64 x 64 tiles with A and
    B staged [row][k] (``*_kmaj``, K's stride along the threads) or
    [k][row], in 16-byte copies (``vec_*``) or one element a copy. At most
    ``batch_chunk`` matrices and ``row_chunk`` rows of A a launch."""
    skinny: int
    transposed: bool
    a_kmaj: bool
    b_kmaj: bool
    vec_a: bool
    vec_b: bool
    batch_chunk: int
    row_chunk: int


def _k_fast(s_row: int, s_k: int, rows: int, k: int) -> bool:
    """Whether K's stride is the smaller (size-1 dimensions aside): that
    dimension runs along the threads when the tile is staged."""
    sk = abs(s_k) if k > 1 else math.inf
    sr = abs(s_row) if rows > 1 else math.inf
    return sk <= sr


def _vectorised(shape: tuple, stride: tuple, aligned: bool, item: int,
                fast: int) -> bool:
    """Whether the 16-byte copies may stage a [B, rows or K, ...] operand:
    stride 1 along dimension ``fast``, the data 16-byte aligned and every
    other stride (of a dimension longer than 1) a whole number of 16-byte
    pieces, so every piece a copy starts is aligned."""
    per = 16 // item
    return (stride[fast] == 1 and aligned
            and all(s % per == 0 for d, (s, n) in enumerate(zip(stride, shape))
                    if d != fast and n > 1))


@functools.lru_cache(maxsize=4096)
def _plan(shape_a: tuple, stride_a: tuple, aligned_a: bool, shape_b: tuple,
          stride_b: tuple, aligned_b: bool, item: int) -> Plan:
    nb, m, k = shape_a
    n = shape_b[2]
    if min(m, n) <= SKINNY:
        transposed = n < m
        cols = m if transposed else n
        # B's batch and column strides after the transposition.
        s_batch, s_col = ((stride_a[0], stride_a[1]) if transposed
                          else (stride_b[0], stride_b[2]))
        batch_fast = nb > 1 and (cols == 1 or abs(s_batch) < abs(s_col))
        return Plan(skinny=1 + 2 * (k <= 32) + batch_fast,
                    transposed=transposed, a_kmaj=False, b_kmaj=False,
                    vec_a=False, vec_b=False,
                    batch_chunk=max(1, MAX_BLOCKS * SKINNY_WARPS
                                    // max(cols, 1)),
                    row_chunk=SKINNY)
    a_kmaj = _k_fast(stride_a[1], stride_a[2], m, k)
    b_kmaj = _k_fast(stride_b[2], stride_b[1], n, k)
    return Plan(skinny=0, transposed=False, a_kmaj=a_kmaj,
                b_kmaj=b_kmaj,
                vec_a=_vectorised(shape_a, stride_a, aligned_a, item,
                                  2 if a_kmaj else 1),
                vec_b=_vectorised(shape_b, stride_b, aligned_b, item,
                                  1 if b_kmaj else 2),
                batch_chunk=MAX_GRID, row_chunk=MAX_GRID * TILE)


def plan(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The staging and grid of ``gemm(a, b)``, a [B, m, k], b [B, k, n];
    derived once per shapes, strides and alignment."""
    return _plan(tuple(a.shape), a.stride(), a.data_ptr() % 16 == 0,
                 tuple(b.shape), b.stride(), b.data_ptr() % 16 == 0,
                 a.element_size())


def _plain_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` without torch's lazy negation (the kernel reads conjugation
    in place, not a negated view)."""
    return t.resolve_neg() if t.is_neg() else t


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
         alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha a @ b + beta c: a [B, m, k] and b [B, k, n] float32 or
    complex64 of one type, any strides (0 broadcasts); c broadcastable to
    [B, m, n], read only when beta != 0. A new contiguous [B, m, n]."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm3.gemm(a, b, c, alpha, beta)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gemm_bf16x3: tensors on {a.device} and "
                         f"{b.device}, want one CUDA device")
    if a.dtype not in _SYMBOLS or b.dtype != a.dtype:
        raise TypeError(f"gemm_bf16x3: needs float32 or complex64 operands "
                        f"of one type, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm_bf16x3: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, want [B, m, k] and [B, k, n]")
    nb, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((nb, m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    a, b = _plain_layout(a), _plain_layout(b)
    use_c = c is not None and beta != 0
    if use_c:
        if c.dtype != a.dtype or c.device != a.device:
            raise TypeError(f"gemm_bf16x3: c is {c.dtype} on {c.device}")
        c = _plain_layout(c.resolve_conj()).expand(nb, m, n)
    pl = plan(a, b)
    if pl.transposed:
        # D^T = B^T A^T: a small N becomes the skinny route's small M.
        a, b = b.transpose(1, 2), a.transpose(1, 2)
        c = c.transpose(1, 2) if use_c else None
        d = out.transpose(1, 2)
    else:
        d = out
    alpha, beta = complex(alpha), complex(beta)
    fn = getattr(cuda_build.library(), _SYMBOLS[a.dtype])
    rows, cols = a.shape[1], b.shape[2]
    whole = nb <= pl.batch_chunk and rows <= pl.row_chunk
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        for z in range(0, nb, pl.batch_chunk):
            zs = slice(z, z + pl.batch_chunk)
            for r in range(0, rows, pl.row_chunk):
                rs = slice(r, r + pl.row_chunk)
                az, bz, dz = ((a, b, d) if whole
                              else (a[zs, rs], b[zs], d[zs, rs]))
                cz = (c if whole else c[zs, rs]) if use_c else dz
                rc = fn(az.data_ptr(), bz.data_ptr(),
                        cz.data_ptr() if use_c else None, dz.data_ptr(),
                        az.shape[0], az.shape[1], cols, k, *az.stride(),
                        *bz.stride(), *cz.stride(), *dz.stride(),
                        alpha.real, alpha.imag, beta.real, beta.imag,
                        int(a.is_conj()), int(b.is_conj()), int(pl.a_kmaj),
                        int(pl.b_kmaj), int(pl.vec_a), int(pl.vec_b),
                        pl.skinny, stream)
                cuda_build.check(rc, "gemm_bf16x3")
                launches += 1
    return out


# aten's forms.
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gemm(a[None], b[None])[0]


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gemm(a, b)


def addmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, beta=1,
          alpha=1) -> torch.Tensor:
    return gemm(a[None], b[None], c.expand(a.shape[0], b.shape[1])[None],
                alpha, beta)[0]


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
        return mm(a, b)
    return torch.ops.aten.mm.out(
        a, b, out=a.new_empty((a.shape[0], b.shape[1])))


def _bmm(a, b):
    if _split(a, b):
        return bmm(a, b)
    return torch.ops.aten.bmm.out(
        a, b, out=a.new_empty((a.shape[0], a.shape[1], b.shape[2])))


def _addmm(c, a, b, *, beta=1, alpha=1):
    if _split(c, a, b):
        return addmm(c, a, b, beta=beta, alpha=alpha)
    return torch.ops.aten.addmm.out(
        c, a, b, beta=beta, alpha=alpha,
        out=a.new_empty((a.shape[0], b.shape[1])))


def _baddbmm(c, a, b, *, beta=1, alpha=1):
    if _split(c, a, b):
        return baddbmm(c, a, b, beta=beta, alpha=alpha)
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
