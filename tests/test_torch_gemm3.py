"""The 'bfloat16_3x' tier's 3-pass bf16 split GEMM and its route, on the CPU.

* The plain version (ops/gemm3) against a numpy model of XLA's
  BF16_BF16_F32_X3 (float32 rounded to bf16 to nearest even on the uint32
  bits, independent of torch's cast; x_lo = bf16(x - x_hi); the three
  products a_hi b_lo + a_lo b_hi + a_hi b_hi summed in float64), real and
  complex64 (four real products on the planes), at (m, k, n) = (7, 16, 7),
  (93, 93, 93), (257, 14, 257), a batch of 3 against a broadcast operand,
  transposed strides, conjugated operands, and addmm / baddbmm with alpha
  and beta != 1. Tolerance elementwise (2 k + 4) eps S + 4 eps |beta||C|,
  eps = 2^-23, S = |alpha| (|Ar| + |Ai|) (|Br| + |Bi|): the plain version
  sums at most 2 (3 k) exact bf16 products in float32 (each rounding <=
  eps / 2 of the running sum) and rounds alpha, beta and their sum once
  each.
* The tier's error class at [256, 512] x [512, 256] (standard normal)
  against float64, max |C - C_64| / max |C_64|: the split <= 2e-5, a TF32
  emulation (operands rounded to a 10-bit mantissa) >= 1e-4: the two lower
  tiers differ now.
* The route decision (config.split_route): "bfloat16_3x" on a CUDA device
  takes it; "float32", "bfloat16" and any tier on the CPU do not; a name
  off the ladder raises. set_matmul_precision installs and removes it on a
  card; full_precision() turns it off in its body and back on after, also
  when the body raises. On the CPU the port's and the JAX package's
  set_matmul_precision both answer "float32" for every ladder name.
* The route itself, installed on the CPU dispatch key (where the wrapper
  runs the plain version): aten mm / bmm / addmm / baddbmm (through @,
  einsum, linear, conj views) give the plain version's bits; float64 and
  products inside full_precision() go to torch's own kernel; nothing
  launches; removing it gives the ops back.
* The wrapper's plan: the staging of each operand by its strides (K's
  stride 1 -> [row][k], the rows' -> [k][row]) and TMA only where the
  base is 16-byte aligned and the other strides nest in 16-byte
  multiples (else one element a copy); a float32 view at stride 2 found
  as a plane of complex pairs (its plane from the storage offset, its
  base the complex one, the pair of every element inside the storage);
  the route by shape: at most 8 rows, or columns transposed, the skinny
  route, at most 32 columns (after a transposition that puts the small
  side there) the narrow tile, else the wide tile (64, 128 or, float32,
  256 columns; halved while the product has tiles for fewer than half the
  card's SMs).
* The launch bookkeeping on the CPU, the kernel call replaced by a
  recorder: the arguments a product hands the kernel (route, flags, a
  plane's base pointer, the transposition) and ``launches_by_route``
  summing to ``launches``; the route's ``.out`` overloads for the other
  types and inside ``config.full_precision()``.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu import config as jconfig
from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import gemm3, gemm3_cuda

torch.set_num_threads(1)

EPS = 2.0 ** -23
LADDER = ("float32", "bfloat16_3x", "bfloat16")
SHAPES = [(7, 16, 7), (93, 93, 93), (257, 14, 257)]


def bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = u.astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def tf32_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest value with a 10-bit mantissa (TF32)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = u.astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def x3_real(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """BF16_BF16_F32_X3 of float32 operands, the sums in float64."""
    ah = bf16_rne(a)
    al = bf16_rne((a - ah).astype(np.float32))
    bh = bf16_rne(b)
    bl = bf16_rne((b - bh).astype(np.float32))
    f = np.float64
    return (ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f)
            + ah.astype(f) @ bh.astype(f))


def x3_model(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if not np.iscomplexobj(a):
        return x3_real(a, b)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    br, bi = b.real.astype(np.float32), b.imag.astype(np.float32)
    return (x3_real(ar, br) - x3_real(ai, bi)
            + 1j * (x3_real(ar, bi) + x3_real(ai, br)))


def magnitude(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """S = (|Ar| + |Ai|) (|Br| + |Bi|): every product term's size."""
    def mag(x):
        return np.abs(x.real).astype(np.float64) + np.abs(x.imag)
    return mag(a) @ mag(b)


def operand(rng, shape, dtype):
    x = rng.normal(size=shape)
    if dtype == torch.complex64:
        x = x + 1j * rng.normal(size=shape)
    return torch.from_numpy(x).to(dtype)


def assert_within(got, want, s, k, c=None, beta=0.0):
    tol = (2 * k + 4) * EPS * s
    if c is not None:
        tol = tol + 4 * EPS * abs(beta) * np.abs(c)
    d = np.abs(got.numpy().astype(np.complex128) - want)
    assert (d <= tol).all(), f"max |d| / tol {float((d / tol).max()):.3g}"


@pytest.fixture(params=[torch.float32, torch.complex64],
                ids=["float32", "complex64"])
def dtype(request):
    return request.param


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_the_x3_model(dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = operand(rng, (m, k), dtype), operand(rng, (k, n), dtype)
    got = gemm3.mm(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    assert_within(got, x3_model(a.numpy(), b.numpy()),
                  magnitude(a.numpy(), b.numpy()), k)


def test_plain_batch_against_a_broadcast_operand(dtype):
    rng = np.random.default_rng(3)
    a = operand(rng, (3, 93, 16), dtype)
    b = operand(rng, (16, 7), dtype)
    got = gemm3.bmm(a, b.expand(3, 16, 7))
    assert b.expand(3, 16, 7).stride(0) == 0
    for i in range(3):
        assert_within(got[i], x3_model(a[i].numpy(), b.numpy()),
                      magnitude(a[i].numpy(), b.numpy()), 16)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_transposed_and_conjugated_operands(dtype, m, k, n):
    rng = np.random.default_rng(7 * m + k)
    at = operand(rng, (k, m), dtype)
    bt = operand(rng, (n, k), dtype)
    a, b = at.T, bt.T
    assert a.stride() == (1, m) and b.stride() == (1, k)
    if dtype == torch.complex64:
        a, b = a.conj(), b.conj()
        assert a.is_conj()
    want = x3_model(a.resolve_conj().numpy(), b.resolve_conj().numpy())
    assert_within(gemm3.mm(a, b), want,
                  magnitude(a.resolve_conj().numpy(),
                            b.resolve_conj().numpy()), k)


@pytest.mark.parametrize("form", ["addmm", "baddbmm"])
def test_plain_alpha_beta(dtype, form):
    rng = np.random.default_rng(11)
    alpha, beta = (0.75, -1.5) if dtype == torch.float32 else (0.5 - 2j,
                                                               1.25 + 0.5j)
    if form == "addmm":
        a, b = operand(rng, (93, 14), dtype), operand(rng, (14, 93), dtype)
        c = operand(rng, (93,), dtype)    # broadcast over the rows
        got = gemm3.addmm(c, a, b, beta=beta, alpha=alpha)
        an, bn, cn = a.numpy(), b.numpy(), np.broadcast_to(c.numpy(),
                                                           (93, 93))
    else:
        a, b = operand(rng, (3, 7, 16), dtype), operand(rng, (3, 16, 7),
                                                        dtype)
        c = operand(rng, (3, 7, 7), dtype)
        got = gemm3.baddbmm(c, a, b, beta=beta, alpha=alpha)
        an, bn, cn = a.numpy(), b.numpy(), c.numpy()
    want = alpha * x3_model(an, bn) + beta * cn.astype(np.complex128)
    s = abs(alpha) * np.stack([magnitude(x, y) for x, y in
                               zip(an.reshape(-1, *an.shape[-2:]),
                                   bn.reshape(-1, *bn.shape[-2:]))]
                              ).reshape(want.shape)
    assert_within(got, want, s, a.shape[-1], cn, beta)


def test_plain_refuses_other_types():
    x = torch.ones(2, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or complex64"):
        gemm3.mm(x, x)


def rel_to_float64(c: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(c - ref).max() / np.abs(ref).max())


def test_tier_error_class():
    rng = np.random.default_rng(2024)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 256)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    split = gemm3.mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    tf32 = tf32_rne(a).astype(np.float64) @ tf32_rne(b).astype(np.float64)
    e3, etf = rel_to_float64(split, ref), rel_to_float64(tf32, ref)
    assert e3 <= 2e-5, e3
    assert etf >= 1e-4, etf


@pytest.mark.parametrize("name", LADDER)
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_route_decision(name, device):
    want = name == "bfloat16_3x" and device != "cpu"
    assert config.split_route(name, device) is want
    assert config.split_route(name, torch.device(device)) is want


def test_route_decision_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PAUXY_TPU_MATMUL", "bfloat16_3x")
    assert config.split_route(None, "cuda")
    monkeypatch.setenv("PAUXY_TPU_MATMUL", "bf16x3")
    with pytest.raises(ValueError, match="bf16x3"):
        config.split_route(None, "cuda")


@pytest.fixture
def ladder_reset():
    """Back to "float32" (no route, rung "highest") after the test."""
    yield
    config.set_matmul_precision("float32", "cuda")
    assert not gemm3_cuda.route_installed()


def test_set_matmul_precision_installs_the_route(ladder_reset):
    # The registration is for CUDA tensors; it can be made without a card.
    for name in LADDER + LADDER[::-1]:
        assert config.set_matmul_precision(name, "cuda") == name
        assert gemm3_cuda.route_installed() is (name == "bfloat16_3x")
    config.set_matmul_precision("bfloat16_3x", "cuda")
    assert config.set_matmul_precision("bfloat16_3x", "cpu") == "float32"
    assert gemm3_cuda.route_installed()


def test_full_precision_turns_the_route_off(ladder_reset):
    config.set_matmul_precision("bfloat16_3x", "cuda")
    assert gemm3_cuda.route_live() and not config.pinned()
    with config.full_precision():
        assert not gemm3_cuda.route_live() and config.pinned()
        with config.full_precision():
            assert not gemm3_cuda.route_live()
        assert not gemm3_cuda.route_live()
    assert gemm3_cuda.route_live()
    with pytest.raises(RuntimeError, match="inside"):
        with config.full_precision():
            assert not gemm3_cuda.route_live()
            raise RuntimeError("inside")
    assert gemm3_cuda.route_live() and not config.pinned()
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("name", [None, *LADDER])
def test_cpu_answers_float32_in_both_packages(name):
    assert config.set_matmul_precision(name, "cpu") == "float32"
    assert jconfig.set_matmul_precision(name) == "float32"


@pytest.fixture
def cpu_route():
    """Installs the route on the CPU dispatch key (call it), removed after
    the test."""
    yield lambda: gemm3_cuda.install_route("CPU")
    gemm3_cuda.remove_route()


def _cases(dtype):
    rng = np.random.default_rng(5)
    a = operand(rng, (3, 7, 16), dtype)
    b = operand(rng, (16, 9), dtype)
    c = operand(rng, (9,), dtype)
    bb = operand(rng, (3, 16, 9), dtype)
    cc = operand(rng, (3, 7, 9), dtype)
    return {
        "mm": (lambda: a[0] @ b, lambda: gemm3.mm(a[0], b)),
        "matmul folded": (lambda: a @ b, lambda: gemm3.mm(a.reshape(21, 16),
                                                          b).reshape(3, 7, 9)),
        "bmm": (lambda: torch.bmm(a, bb), lambda: gemm3.bmm(a, bb)),
        "einsum": (lambda: torch.einsum("wik,wkj->wij", a, bb),
                   lambda: gemm3.bmm(a, bb)),
        "transposed": (lambda: a[1].T.T @ bb[2],
                       lambda: gemm3.mm(a[1], bb[2])),
        "addmm": (lambda: torch.addmm(c, a[0], b, beta=0.5, alpha=2.0),
                  lambda: gemm3.addmm(c, a[0], b, beta=0.5, alpha=2.0)),
        "linear": (lambda: torch.nn.functional.linear(a[0], b.T, c),
                   lambda: gemm3.addmm(c, a[0], b)),
        "baddbmm": (lambda: torch.baddbmm(cc, a, bb, beta=-1.0, alpha=3.0),
                    lambda: gemm3.baddbmm(cc, a, bb, beta=-1.0, alpha=3.0)),
        "conj": (lambda: a[0].conj() @ b, lambda: gemm3.mm(a[0].conj(), b)),
    }


@pytest.mark.parametrize("case", list(_cases(torch.float32)))
def test_route_gives_the_split(cpu_route, dtype, case):
    routed, plain = _cases(dtype)[case]
    native = routed()
    cpu_route()
    before = gemm3_cuda.launches
    got = routed()
    assert torch.equal(got, plain())
    assert not torch.equal(got, native)
    # Inside full_precision() the product is torch's own again.
    with config.full_precision():
        assert torch.equal(routed(), native)
    assert gemm3_cuda.launches == before


def test_route_passes_other_types_by(cpu_route):
    cpu_route()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(5, 6)))
    y = torch.from_numpy(rng.normal(size=(6, 4)))
    want = torch.ops.aten.mm.out(x, y, out=x.new_empty(5, 4))
    assert torch.equal(x @ y, want)
    z = x.to(torch.complex128)
    assert torch.equal(torch.bmm(z[None], z.T[None]),
                       torch.ops.aten.bmm.out(z[None], z.T[None],
                                              out=z.new_empty(1, 5, 5)))


def test_route_removed_gives_the_ops_back():
    rng = np.random.default_rng(13)
    a = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    ieee = a @ a
    gemm3_cuda.install_route("CPU")
    gemm3_cuda.install_route("CPU")      # twice: one registration
    try:
        assert not torch.equal(a @ a, ieee)
    finally:
        gemm3_cuda.remove_route()
    assert not gemm3_cuda.route_installed()
    assert torch.equal(a @ a, ieee)


def test_wrapper_on_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(17)
    a, b = operand(rng, (2, 9, 5), dtype), operand(rng, (2, 5, 4), dtype)
    c = operand(rng, (4,), dtype)
    assert torch.equal(gemm3_cuda.gemm(a, b, c, 2.0, 0.5),
                       gemm3.gemm(a, b, c, 2.0, 0.5))
    assert torch.equal(gemm3_cuda.addmm(c, a[0], b[0], beta=0.5, alpha=2.0),
                       gemm3.addmm(c, a[0], b[0], beta=0.5, alpha=2.0))


@pytest.mark.parametrize("kind", ["contiguous", "transposed", "permuted",
                                  "broadcast", "offset"])
def test_plan_stages_by_strides(dtype, kind):
    base = torch.zeros(4, 64, 64, dtype=dtype)
    if kind == "contiguous":
        a, b = base[:, :32, :48], base[:, :48, :16]
        want = (True, False, True, True)
    elif kind == "transposed":
        a = base.transpose(1, 2)[:, :32, :48]
        b = base.transpose(1, 2)[:, :48, :16]
        want = (False, True, True, True)
    elif kind == "permuted":
        p = torch.zeros(64, 4, 64, dtype=dtype).permute(1, 0, 2)
        a, b = p[:, :32, :48], p[:, :48, :16]
        want = (True, False, True, True)
    elif kind == "broadcast":
        a, b = base[:1, :32, :48].expand(4, 32, 48), base[0, :48, :16]
        b = b.expand(4, 48, 16)
        assert a.stride(0) == b.stride(0) == 0
        want = (True, False, True, True)
    else:
        flat = torch.zeros(4 * 64 * 64 + 1, dtype=dtype)
        a = flat[1:].view(4, 64, 64)[:, :32, :48]
        b = flat[1:].view(4, 64, 64)[:, :48, :16]
        want = (True, False, False, False)
    pl = gemm3_cuda.plan(a, b)
    assert (pl.a_kmaj, pl.b_kmaj, pl.tma_a, pl.tma_b) == want, pl
    assert (pl.route, pl.code, pl.transposed) == ("narrow", 16, False)


def test_plan_keeps_element_copies_for_unaligned_strides():
    """Lines that are no whole 16-byte pieces: TMA over groups of lines
    where the batch's lines fill whole groups, else a bulk copy a line."""
    a = torch.zeros(3, 16, 5)     # row stride 5: 20 bytes, 4 lines 80
    b = torch.zeros(3, 5, 10)     # k-lines of 40 bytes, 15 of them: odd
    pl = gemm3_cuda.plan(a, b)
    assert not pl.transposed
    assert pl.a_kmaj and not pl.b_kmaj and pl.tma_a and not pl.tma_b
    assert pl.flags_a & gemm3_cuda.GROUP4
    assert pl.flags_b & gemm3_cuda.ROWS                   # unit stride
    b12 = torch.zeros(3, 5, 12)
    assert gemm3_cuda.plan(a, b12).tma_b


@pytest.mark.parametrize("m,k,n,mode,transposed", [
    (1, 8649, 1, 2, False),     # batched dot products: a warp a column
    (8, 33, 512, 1, False),
    (257, 257, 7, 1, True),     # a small N: the transposed product
    (7, 7, 7, 3, False),        # K <= 32: a thread a column
    (9, 9, 9, 0, None)])        # the narrow tile
def test_plan_takes_the_skinny_route(m, k, n, mode, transposed):
    """At most 8 rows, or 8 columns of the transposed product, go to the
    skinny route; a 64 x 64 tile would be mostly padding."""
    a, b = torch.zeros(96, m, k), torch.zeros(96, k, n)
    pl = gemm3_cuda.plan(a, b)
    assert pl.skinny == mode
    if mode:
        assert pl.route == "skinny" and pl.transposed is transposed
        assert pl.batch_chunk * max(m, n) <= (2 ** 31 - 1) * 8
    else:
        assert (pl.route, pl.code) == ("narrow", 16)


def test_plan_runs_the_batch_fastest_where_b_is_contiguous():
    """The UEG's einsum hands over [z, 1, 7] x [z, 7, 512] views whose
    batch stride is 1: the pairs then run with the batch fastest."""
    a = torch.zeros(7, 1, 493).permute(2, 1, 0)
    b = torch.zeros(512, 7, 493).permute(2, 1, 0)
    assert b.stride() == (1, 493, 3451)
    assert gemm3_cuda.plan(a, b).skinny == 4
    assert gemm3_cuda.plan(a.contiguous(), b.contiguous()).skinny == 3


C64 = torch.complex64


@pytest.mark.parametrize("dt,m,k,n,batch,route,code,transposed", [
    (torch.float32, 1024, 512, 16384, 1, "tile", 256, False),  # the VHS
    (C64, 1024, 512, 16384, 1, "tile", 128, False),
    (C64, 257, 257, 14, 512, "narrow", 16, False),    # "xla" Taylor
    (C64, 16, 16, 7168, 1, "narrow", 16, True),       # a lattice shape
    (C64, 16384, 128, 16, 1, "narrow", 16, False),
    (C64, 16, 16, 128, 1024, "narrow", 16, True),
    (torch.float32, 200, 64, 30, 1, "narrow", 32, False),
    (torch.float32, 200, 64, 40, 1, "tile", 64, False),
    (C64, 93, 93, 93, 512, "tile", 128, False),        # thermal UEG
    (torch.float32, 1024, 2048, 512, 1, "tile", 64, False),   # few tiles
    (torch.float32, 1024, 2048, 2048, 1, "tile", 128, False),
    (torch.float32, 4096, 64, 4096, 1, "tile", 256, False),
    (torch.float32, 129, 17, 130, 1, "tile", 64, False),
    (torch.float32, 9, 9, 9, 1, "narrow", 16, False),
    (torch.float32, 8, 100, 100, 1, "skinny", 1, False),
    (C64, 100, 100, 3, 1, "skinny", 1, True)])
def test_plan_route_by_shape(dt, m, k, n, batch, route, code, transposed):
    """The route and the tile's columns by shape, before any launch: the
    small side of a short product in the columns, the narrowest tile
    that holds them, a wide tile halved while the product has tiles for
    fewer than half the card's SMs."""
    a = torch.zeros(batch, m, k, dtype=dt)
    b = torch.zeros(batch, k, n, dtype=dt)
    pl = gemm3_cuda.plan(a, b)
    assert (pl.route, pl.code, pl.transposed) == (route, code, transposed)
    assert pl.bn == (0 if route == "skinny" else code)
    assert pl.skinny == (code if route == "skinny" else 0)


@pytest.mark.parametrize("dt,widest", [(torch.float32, 256), (C64, 128)])
def test_plan_tile_columns_per_type(dt, widest):
    """float32 tiles reach 256 columns, complex64 (two accumulator
    planes) 128; the narrow tile takes 9 to 32 columns."""
    got = {}
    for n in (9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 4096):
        a = torch.zeros(32768, 64, dtype=dt)     # 256 row tiles
        got[n] = gemm3_cuda.plan(a, torch.zeros(64, n, dtype=dt)).code
    want = {9: 16, 16: 16, 17: 32, 32: 32, 33: 64, 64: 64, 65: 128,
            128: 128, 129: min(256, widest), 256: min(256, widest),
            4096: widest}
    assert got == want


def _flags(pl, side):
    return pl.flags_a if side == "a" else pl.flags_b


@pytest.mark.parametrize("kind,tma,extra", [
    ("contiguous", True, 0),
    ("rows of 93 (372 bytes)", True, gemm3_cuda.GROUP4),
    ("rows of 93, 3 x 201 lines", False, gemm3_cuda.ROWS),
    ("base 4 bytes past 16", False, gemm3_cuda.ROWS),
    ("broadcast batch", True, gemm3_cuda.BCAST),
    ("permuted batch", True, gemm3_cuda.SWAP),
    ("rows at stride 0", False, 0),
    ("complex rows of 93 (744 bytes)", True, gemm3_cuda.GROUP2),
    ("complex rows of 94", True, 0)])
def test_plan_tma_eligibility(kind, tma, extra):
    """TMA stages an operand whose fast stride is 1, base 16-byte aligned
    and other strides nested 16-byte multiples; rows that are no 16-byte
    multiple by groups of 2 or 4 lines where the batch's lines fill whole
    groups; at unit stride otherwise one bulk copy a row; anything else
    goes by element copies (no copy to a contiguous buffer first)."""
    dt = C64 if kind.startswith("complex") else torch.float32
    b = torch.zeros(4, 64, 300, dtype=dt)
    if kind == "contiguous":
        a = torch.zeros(4, 200, 64)
    elif kind == "rows of 93 (372 bytes)":
        a = torch.zeros(4, 200, 93)[:, :, :64]
    elif kind == "rows of 93, 3 x 201 lines":
        a = torch.zeros(3, 201, 93)[:, :, :64]
        b = torch.zeros(3, 64, 300)
    elif kind == "base 4 bytes past 16":
        a = torch.zeros(4 * 200 * 64 + 1)[1:].view(4, 200, 64)
    elif kind == "broadcast batch":
        a = torch.zeros(1, 200, 64).expand(4, 200, 64)
    elif kind == "permuted batch":
        a = torch.zeros(200, 4, 64).permute(1, 0, 2)
    elif kind == "rows at stride 0":
        a = torch.zeros(4, 1, 64).expand(4, 200, 64)
    elif kind == "complex rows of 93 (744 bytes)":
        a = torch.zeros(4, 200, 93, dtype=dt)[:, :, :64]
    else:
        a = torch.zeros(4, 200, 94, dtype=dt)[:, :, :64]
    pl = gemm3_cuda.plan(a, b)
    assert not pl.transposed and pl.route == "tile"
    assert pl.a_kmaj is (kind != "rows at stride 0")
    assert pl.tma_a is tma, pl
    assert pl.flags_a & (gemm3_cuda.BCAST | gemm3_cuda.SWAP
                         | gemm3_cuda.ROWS | gemm3_cuda.GROUP2
                         | gemm3_cuda.GROUP4) == extra
    if not tma:     # element copies read the strides as they are
        assert pl.strides[:3] == a.stride()
        assert pl.shift_a == 0


@pytest.mark.parametrize("view,side,plane", [
    ("real", "a", 0), ("imag", "a", 1), ("imag T", "b", 1),
    ("real T batched", "a", 0), ("imag batched", "b", 1)])
def test_plan_finds_the_planes_of_a_complex_tensor(view, side, plane):
    """A .real / .imag view (stride 2 in float32) is staged from its
    complex pairs at stride 1: the plane from the storage offset's
    parity, the base the complex tensor's (4 bytes back for .imag), both
    K-major and not, single and batched."""
    z = torch.zeros(300, 64, dtype=C64)
    z3 = torch.zeros(3, 64, 300, dtype=C64)
    x = torch.zeros(64, 300)
    if view == "real":
        a, b, t = z.real, x, z
    elif view == "imag":
        a, b, t = z.imag, x, z
    elif view == "imag T":
        a, b, t = torch.zeros(200, 64), z.imag.T, z
    elif view == "real T batched":
        a, b, t = z3.real.transpose(1, 2), torch.zeros(3, 64, 200), z3
    else:
        a, b, t = torch.zeros(3, 200, 64), z3.imag, z3
    pl = gemm3_cuda.plan(a, b)
    assert not pl.transposed
    flags = _flags(pl, side)
    assert flags & gemm3_cuda.PAIR and flags & gemm3_cuda.TMA
    assert bool(flags & gemm3_cuda.PLANE) is bool(plane)
    shift = pl.shift_a if side == "a" else pl.shift_b
    view_t = a if side == "a" else b
    assert view_t.data_ptr() - shift == t.data_ptr()
    assert shift == 4 * plane


def test_plan_pairs_only_inside_the_storage():
    """A stride-2 float32 view whose last element's pair would lie past
    its storage is no plane: it goes by element copies."""
    whole = torch.zeros(64 * 300 * 2).as_strided((64, 300), (600, 2))
    short = torch.zeros(64 * 300 * 2 - 1).as_strided((64, 300), (600, 2))
    a = torch.zeros(200, 64)
    assert gemm3_cuda.plan(a, whole).flags_b & gemm3_cuda.PAIR
    pl = gemm3_cuda.plan(a, short)
    assert not pl.flags_b & (gemm3_cuda.PAIR | gemm3_cuda.TMA)
    odd = torch.zeros(64, 301)[:, ::2]     # row stride 301: odd
    assert not gemm3_cuda.plan(a, odd).flags_b & gemm3_cuda.PAIR


@pytest.fixture
def recorder(monkeypatch):
    """The kernel call replaced by a recorder of its arguments (returns 0,
    a launch without error) on CPU tensors; counts restored after."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    saved = gemm3_cuda.launches, dict(gemm3_cuda.launches_by_route)
    monkeypatch.setattr(gemm3_cuda, "_fn", lambda dtype: fake)
    monkeypatch.setattr(gemm3_cuda, "_current", lambda dev: True)
    monkeypatch.setattr(gemm3_cuda, "_stream", lambda dev: 0)
    gemm3_cuda.launches = 0
    for r in gemm3_cuda.launches_by_route:
        gemm3_cuda.launches_by_route[r] = 0
    yield calls
    gemm3_cuda.launches = saved[0]
    gemm3_cuda.launches_by_route.update(saved[1])


def _record(a, b, c=None, alpha=1.0, beta=0.0):
    out = torch.empty((*a.shape[:-1], b.shape[-1]), dtype=a.dtype)
    gemm3_cuda._launch(a, b, c, complex(alpha), complex(beta), out)
    return out


def test_launches_by_route_sum_to_launches(recorder):
    c64 = torch.complex64
    _record(torch.zeros(1024, 512), torch.zeros(512, 8192))        # tile
    _record(torch.zeros(512, 257, 257, dtype=c64),
            torch.zeros(512, 257, 14, dtype=c64))                   # narrow
    _record(torch.zeros(16, 16, dtype=c64),
            torch.zeros(16, 7168, dtype=c64))                       # narrow
    _record(torch.zeros(300, 1, 64), torch.zeros(300, 64, 1))       # skinny
    _record(torch.zeros(70000, 2, 3), torch.zeros(70000, 3, 2))     # skinny
    assert gemm3_cuda.launches_by_route == {"tile": 1, "narrow": 2,
                                            "skinny": 1 + 1}
    assert sum(gemm3_cuda.launches_by_route.values()) \
        == gemm3_cuda.launches == len(recorder) == 5
    assert [args[-2] for args in recorder] == [256, 16, 16, 2, 3]


def test_launch_hands_over_the_plan(recorder):
    """What the kernel gets: a plane's complex base, the flags with
    conjugation, the operands swapped for a transposed product, D's and
    C's strides swapped with them, alpha and beta."""
    z = torch.zeros(200, 64, dtype=torch.complex64)
    b = torch.zeros(64, 300)
    _record(z.imag, b)
    a_ptr, b_ptr, c_ptr, d_ptr, batch, m, n, k = recorder[-1][:8]
    fa, fb, route = recorder[-1][-4:-1]
    assert a_ptr == z.data_ptr() and b_ptr == b.data_ptr()
    assert c_ptr is None and (batch, m, n, k) == (1, 200, 300, 64)
    assert fa & gemm3_cuda.PAIR and fa & gemm3_cuda.PLANE
    assert route == gemm3_cuda.plan(z.imag, b).code
    assert not fb & gemm3_cuda.CONJ
    # A transposed product (the small side in the columns), B conjugated.
    a = torch.zeros(16, 16, dtype=torch.complex64)
    bb = torch.zeros(16, 7168, dtype=torch.complex64).conj()
    c = torch.ones(16, 7168, dtype=torch.complex64)
    _record(a, bb, c, alpha=2.0, beta=0.5j)
    args = recorder[-1]
    assert args[0] == bb.data_ptr() and args[1] == a.data_ptr()
    assert args[5:8] == (7168, 16, 16)
    # sc (batch, row, column) and sd swapped with the operands.
    assert args[14:17] == (0, 1, 7168) and args[17:20] == (0, 1, 7168)
    assert args[20:24] == (2.0, 0.0, 0.0, 0.5)
    assert args[24] & gemm3_cuda.CONJ and not args[25] & gemm3_cuda.CONJ
    assert args[26] == 16


def test_launch_chunks_a_long_batch(recorder, monkeypatch):
    """Past the launch's limits (here lowered to 40000 tiles) the batch
    goes in chunks, each operand's pointer moved by its batch stride (a
    broadcast one stays)."""
    monkeypatch.setattr(gemm3_cuda, "MAX_BLOCKS", 40000)
    gemm3_cuda._plan.cache_clear()
    a = torch.zeros(70000, 16, 16)
    b = torch.zeros(16, 16).expand(70000, 16, 16)
    try:
        out = _record(a, b)
    finally:
        gemm3_cuda._plan.cache_clear()
    assert len(recorder) == 2 and gemm3_cuda.launches == 2
    (a0, b0, _, d0, n0), (a1, b1, _, d1, n1) = (r[:5] for r in recorder)
    assert n0 + n1 == 70000
    assert a1 - a0 == n0 * a.stride(0) * 4 and b1 == b0
    assert d1 - d0 == n0 * out.stride(0) * 4


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "baddbmm"])
def test_route_takes_out_for_other_types_and_pinned(cpu_route, op):
    """The leaner route still hands float64 / complex128 products to the
    op's .out overload, and float32 ones inside full_precision() too:
    nothing reaches the split GEMM or its counter."""
    cpu_route()
    rng = np.random.default_rng(21)
    before = gemm3_cuda.launches
    for dt in (torch.float64, torch.complex128, torch.float32):
        x = torch.from_numpy(rng.normal(size=(2, 5, 6))).to(dt)
        y = torch.from_numpy(rng.normal(size=(2, 6, 4))).to(dt)
        c = torch.from_numpy(rng.normal(size=(2, 5, 4))).to(dt)
        calls = {"mm": (torch.mm, (x[0], y[0]), torch.ops.aten.mm.out),
                 "bmm": (torch.bmm, (x, y), torch.ops.aten.bmm.out),
                 "addmm": (torch.addmm, (c[0], x[0], y[0]),
                           torch.ops.aten.addmm.out),
                 "baddbmm": (torch.baddbmm, (c, x, y),
                             torch.ops.aten.baddbmm.out)}
        fn, args, out_op = calls[op]
        want = out_op(*args, out=torch.empty(
            args[-2].shape[:-1] + args[-1].shape[-1:], dtype=dt))
        if dt is torch.float32:
            with config.full_precision():
                got = fn(*args)
        else:
            got = fn(*args)
        assert torch.equal(got, want)
    assert gemm3_cuda.launches == before


@pytest.mark.parametrize("kind,side,flag", [
    ("thermal A [512,93,93]", "a", gemm3_cuda.GROUP2),
    ("thermal B, a 128-column tile", "b", gemm3_cuda.ROWS),
    ("B [6,93,93] under a 64-column tile", "b", gemm3_cuda.GROUP2),
    ("Taylor V [512,257,257]", "a", gemm3_cuda.GROUP2),
    ("batch not stacked", "a", gemm3_cuda.ROWS),
    ("one matrix of 93 lines", "a", gemm3_cuda.ROWS)])
def test_plan_groups_lines(kind, side, flag):
    """Lines of no whole 16 bytes go by TMA over groups of 2 or 4 when the
    batch stacks its matrices' lines evenly, the lines fill whole groups
    and a [k][row] box line (the tile's columns and 16 bytes) stays within
    TMA's 256 floats; else by a bulk copy a line."""
    c64 = torch.complex64
    b = None
    if kind == "thermal A [512,93,93]" or kind.startswith("thermal B"):
        a = torch.zeros(512, 93, 93, dtype=c64)
        b = torch.zeros(512, 93, 93, dtype=c64)
    elif kind.startswith("B [6,93,93]"):
        a = torch.zeros(6, 130, 93, dtype=c64).conj()
        b = torch.zeros(6, 93, 93, dtype=c64)
    elif kind.startswith("Taylor"):
        a = torch.zeros(512, 257, 257, dtype=c64)
        b = torch.zeros(512, 257, 14, dtype=c64)
    elif kind == "batch not stacked":
        a = torch.zeros(4, 210, 93)[:, :200, :64]
    else:
        a = torch.zeros(93, 93, dtype=c64)
        b = torch.zeros(93, 60, dtype=c64)
    if b is None:
        b = torch.zeros(4, 64, 300)
    pl = gemm3_cuda.plan(a, b)
    assert not pl.transposed
    flags = _flags(pl, side)
    assert flags & (gemm3_cuda.GROUP2 | gemm3_cuda.GROUP4
                    | gemm3_cuda.ROWS) == flag, (pl, kind)
    assert bool(flags & gemm3_cuda.TMA) is (flag != gemm3_cuda.ROWS)
