"""The order-6 Taylor series exp(V) phi with each complex product split
into three real batched products (3M, as the JAX package's ``"xla_3m"``
route computes it for a TPU), against the complex series the port runs
for ``"xla_3m"``, on one CUDA card.

    python3 tools/taylor_3m_ab.py

At the Generic bench shape's step (V [1024, 128, 128], phi [1024, 128, 32],
complex64, seeded) it prints the card's name and power limit, then one
JSON line: the median CUDA-event time of each series (``chip_smoke.
median_ms``, in turns) and their largest difference over the scale. The 3M
series lives only here: the port keeps the complex one.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def series_3m(vhs, phi, order: int = 6):
    """exp(vhs) phi to ``order`` with p1 = Vr Tr, p2 = Vi Ti,
    p3 = (Vr + Vi)(Tr + Ti), Re = p1 - p2, Im = p3 - p1 - p2."""
    import torch

    vr, vi = vhs.real, vhs.imag
    vs = vr + vi
    tr, ti = phi.real, phi.imag
    ar, ai = tr, ti
    for k in range(1, order + 1):
        p1 = torch.matmul(vr, tr)
        p2 = torch.matmul(vi, ti)
        p3 = torch.matmul(vs, tr + ti)
        tr, ti = (p1 - p2) / k, (p3 - p1 - p2) / k
        ar, ai = ar + tr, ai + ti
    return torch.complex(ar, ai)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke
    from pauxy_tpu_torch.propagation.generic import taylor_series

    rng = np.random.default_rng(3)
    w, m, c = 1024, 128, 32
    vhs = 0.1 / np.sqrt(m) * (rng.normal(size=(w, m, m))
                              + 1j * rng.normal(size=(w, m, m)))
    phi = rng.normal(size=(w, m, c)) + 1j * rng.normal(size=(w, m, c))
    vhs = torch.from_numpy(vhs).to("cuda", torch.complex64)
    phi = torch.from_numpy(phi).to("cuda", torch.complex64)

    def complex_series():
        return taylor_series(vhs, phi, 6, "xla_3m")

    out_c = complex_series()
    gap = float((series_3m(vhs, phi) - out_c).abs().max()
                / out_c.abs().max())
    t = chip_smoke.median_ms({"3m": lambda: series_3m(vhs, phi),
                              "complex": complex_series})
    print(chip_smoke.nvidia_smi())
    print(json.dumps({"w": w, "m": m, "c": c, "ms_3m": t["3m"],
                      "ms_complex": t["complex"], "max_abs_err": gap}))


if __name__ == "__main__":
    main()
