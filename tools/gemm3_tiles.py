"""The split GEMM's device time by tile width on the products the paths give
it, and the route's host time at a lattice shape, on one CUDA card.

    python3 tools/gemm3_tiles.py

For each product (the Generic block's float32 products with A the real
plane of a complex64 tensor, the VHS shape in float32 and complex64, the
thermal UEG's [512, 93, 93] and the "xla" Taylor product complex64, and
the Generic block's small batched complex64 products) prints the route
``ops/gemm3_cuda.plan`` picks and the kernel's device ms (the profiler's,
``chip_smoke.device_ms``) at the tile width it picks and at the other wide
widths (the plan's width replaced before the launch), beside cuBLAS's
float32 product through ``torch.matmul`` (median wrapper ms). Then, at
[16, 16] x [16, 7168] complex64, the median wrapper ms of the wrapper, of
the route (``a @ b`` under 'bfloat16_3x') and of cuBLAS, and their host
ms a call (2000 calls queued without a synchronisation). The card's name
and power limit come first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def products() -> dict:
    c64 = torch.complex64

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, dtype=dtype, device="cuda")

    return {
        "plane [1024,2048] x [2048,512]": (r(1024, 2048, dtype=c64).real,
                                           r(512, 2048).T),
        "plane [1024,2048] x [2048,2048]": (r(1024, 2048, dtype=c64).real,
                                            r(2048, 2048).T),
        "plane [1024,512] x [512,16384]": (r(1024, 512, dtype=c64).real,
                                           r(16384, 512).T),
        "f32 [1024,512] x [512,16384]": (r(1024, 512), r(512, 16384)),
        "c64 [1024,512] x [512,16384]": (r(1024, 512, dtype=c64),
                                         r(512, 16384, dtype=c64)),
        "c64 [512,93,93] x [512,93,93]": (r(512, 93, 93, dtype=c64),
                                          r(512, 93, 93, dtype=c64)),
        "c64 [512,257,257] x [512,257,14]": (r(512, 257, 257, dtype=c64),
                                             r(512, 257, 14, dtype=c64)),
        "c64 [1024,16,16] x [1024,16,128]": (
            r(1024, 16, 16, dtype=c64),
            r(1024, 128, 16, dtype=c64).transpose(1, 2)),
        "c64 [1024,16,128]^H x [1024,128,16]": (
            r(1024, 128, 16, dtype=c64).transpose(1, 2).conj(),
            r(1024, 128, 16, dtype=c64)),
    }


def host_ms(fn, n: int = 2000) -> float:
    """Host ms a call: ``n`` calls queued, no synchronisation between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm3_tiles: no CUDA device")
    import chip_smoke as cs
    from pauxy_tpu_torch import config
    from pauxy_tpu_torch.ops import gemm3_cuda as g

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    plan = g._plan
    for name, (a, b) in products().items():
        picked = g.plan(a, b)
        widths = [picked.code] + [w for w in (64, 128, 256)
                                  if picked.route == "tile"
                                  and w != picked.code
                                  and not (w == 256 and a.is_complex())]
        by_width = {}
        for w in widths:
            g._plan = (lambda *key, w=w:
                       dataclasses.replace(plan(*key), code=w))
            try:
                by_width[w] = round(cs.device_ms(lambda: g.gemm(a, b),
                                                 "gemm_bf16x3"), 5)
            finally:
                g._plan = plan
        cublas = cs.median_ms({"lib": lambda: torch.matmul(
            a.resolve_conj(), b)}, reps=10)["lib"]
        print(json.dumps({"product": name, "route": picked.route,
                          "width": picked.code, "device_ms": by_width,
                          "cublas_ms": round(cublas, 5)}), flush=True)
    c64 = torch.complex64
    a = torch.randn(16, 16, dtype=c64, device="cuda")
    b = torch.randn(16, 7168, dtype=c64, device="cuda")
    out = cs.median_ms({"wrapper": lambda: g.mm(a, b),
                        "cublas": lambda: a @ b}, reps=50)
    out["host wrapper"] = host_ms(lambda: g.mm(a, b))
    out["host cublas"] = host_ms(lambda: a @ b)
    config.set_matmul_precision("bfloat16_3x", "cuda")
    try:
        out.update(cs.median_ms({"route": lambda: a @ b}, reps=50))
        out["host route"] = host_ms(lambda: a @ b)
    finally:
        config.set_matmul_precision("float32", "cuda")
    print(json.dumps({"lattice [16,16] x [16,7168] c64 ms":
                      {k: round(v, 5) for k, v in out.items()}}), flush=True)


if __name__ == "__main__":
    main()
