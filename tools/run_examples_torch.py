#!/usr/bin/env python
"""Run every example input end-to-end on the PyTorch port with tiny
overrides (a smoke run of ``examples/*/input.json``).

The port's copy of ``tools/run_examples.py``: the same overrides (2
blocks, at most 8 walkers and 4 steps, beta at most 0.25; a Generic
example without its integrals gets an H4 chain from ``utils/sgto``), run
through ``pauxy_tpu_torch.qmc.calc.get_driver``. ``--cpu`` runs on the CPU
in double precision; without it, on the CUDA card in single precision.

Usage: python tools/run_examples_torch.py [--cpu] [--only NAME ...]
"""

import copy
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def shrink(opts: dict, name: str) -> dict:
    """The smoke run's overrides of one example's options (a copy); a
    Generic example without its integrals file gets the H4 chain's files
    written into the working directory."""
    opts = copy.deepcopy(opts)
    model = opts.get("model", opts.get("system", {}))
    if model.get("name", "Generic") == "Generic" and not os.path.exists(
            str(model.get("integrals", ""))):
        from pauxy_tpu_torch.utils.sgto import dump_afqmc

        dump_afqmc(4, 1.6, prefix=".")
        model["integrals"] = "afqmc.h5"
        model.setdefault("nup", 2)
        model.setdefault("ndown", 2)
        if "trial" in opts and "filename" not in opts["trial"]:
            opts["trial"]["filename"] = "wfn.h5"
        print(f"# {name}: generated H4 integrals via utils/sgto")
    qmc = opts["qmc"]
    for k in ("blocks", "nblocks"):
        if k in qmc:
            qmc[k] = 2
    qmc["nwalkers"] = min(int(qmc.get("nwalkers", 8)), 8)
    for k in ("num_steps", "nsteps"):
        if k in qmc:
            qmc[k] = min(int(qmc[k]), 4)
    if "beta" in qmc:
        qmc["beta"] = min(float(qmc["beta"]), 0.25)
    opts.setdefault("estimates", {})["filename"] = f"{name}.h5"
    return opts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kw = (dict(device="cpu", dtype="double") if "--cpu" in argv
          else dict(device=None, dtype="single"))
    only = argv[argv.index("--only") + 1:] if "--only" in argv else None
    import numpy as np

    from pauxy_tpu_torch.qmc.calc import get_driver

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    inputs = sorted(glob.glob(os.path.join(root, "examples", "*",
                                           "input.json")))
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        for path in inputs:
            name = os.path.basename(os.path.dirname(path))
            if only is not None and name not in only:
                continue
            try:
                with open(path) as fh:
                    opts = shrink(json.load(fh), name)
            except Exception as e:  # noqa: BLE001 — smoke reporter
                failures.append(name)
                print(f"FAIL {name} (integral bootstrap): "
                      f"{type(e).__name__}: {str(e)[:160]}")
                continue
            try:
                af = get_driver(opts, **kw)
                rows = np.asarray(af.run())
                assert np.isfinite(rows.real).all()
                print(f"OK {name}")
            except Exception as e:  # noqa: BLE001 — smoke reporter
                failures.append(name)
                print(f"FAIL {name}: {type(e).__name__}: {str(e)[:160]}")
    if failures:
        sys.exit(f"example failures: {failures}")
    print("ALL EXAMPLES OK")


if __name__ == "__main__":
    main()
