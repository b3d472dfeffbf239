"""Host memory and seconds of the port's out-of-core Cholesky through
h5lite (h5py hidden), for one checkout or several.

    python3 tools/h5lite_outcore.py                       # this checkout
    python3 tools/h5lite_outcore.py --root A --root B     # each in turn
    python3 tools/h5lite_outcore.py --nao 64 --rank 192 --rows 32

Each root runs in a fresh interpreter: ``from_pyscf.chunked_cholesky_outcore``
of ``chip_smoke.LowRankERI`` (a synthetic rank-``rank`` (pq|rs), seed 0)
into a new file in a temporary directory, under ``tracemalloc``, then the
in-core ``chunked_cholesky`` of the same provider. One JSON line a root:
its path, the traced peak and the dataset's and a chunk's bytes, the
out-of-core and in-core seconds and the largest difference between them.
Pass a root twice (``--root A --root B --root B --root A``) to see the
spread of the seconds; the peak does not vary.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib.util, json, os, shutil, sys, tempfile, time, tracemalloc
root, nao, rank, cmax, rows = sys.argv[1], *map(int, sys.argv[2:6])
sys.path.insert(0, root)
sys.modules["h5py"] = None
import numpy as np
spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", os.path.join({here!r}, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from pauxy_tpu_torch.utils import from_pyscf, h5lite
LowRankERI = smoke.LowRankERI
assert from_pyscf.__file__.startswith(os.path.join(root, "pauxy_tpu_torch"))
prov = LowRankERI(nao, rank)
work = tempfile.mkdtemp(prefix="h5lite_outcore_")
fn = os.path.join(work, "chol.h5")
tracemalloc.start()
t0 = time.perf_counter()
n = from_pyscf.chunked_cholesky_outcore(prov, fn, max_error=1e-8, cmax=cmax,
                                        chunk_rows=rows)
outcore = time.perf_counter() - t0
peak = tracemalloc.get_traced_memory()[1]
tracemalloc.stop()
t0 = time.perf_counter()
ref = from_pyscf.chunked_cholesky(prov, max_error=1e-8, cmax=cmax)
incore = time.perf_counter() - t0
with h5lite.File(fn, "r") as fh5:
    err = float(np.abs(fh5["chol_outcore"][()] - ref).max())
shutil.rmtree(work, ignore_errors=True)
print(json.dumps({{"root": root, "nao": nao, "rank": rank, "cmax": cmax,
                  "chunk_rows": rows, "vectors": n, "peak_bytes": peak,
                  "dataset_bytes": cmax * nao ** 3 * 8,
                  "chunk_bytes": rows * nao * nao * 8,
                  "outcore_s": outcore, "incore_s": incore,
                  "max_abs_diff": err}}))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="a checkout to import pauxy_tpu_torch from "
                         "(repeatable; default this one)")
    ap.add_argument("--nao", type=int, default=128)
    ap.add_argument("--rank", type=int, default=384)
    ap.add_argument("--cmax", type=int, default=10)
    ap.add_argument("--rows", type=int, default=64)
    args = ap.parse_args()
    code = CHILD.format(here=HERE)
    for root in args.root or [HERE]:
        res = subprocess.run(
            [sys.executable, "-c", code, os.path.abspath(root),
             str(args.nao), str(args.rank), str(args.cmax), str(args.rows)],
            capture_output=True, text=True, timeout=1800)
        if res.returncode:
            raise SystemExit(f"{root}: {res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
