"""Run an AFQMC calculation from a JSON input file:

    python -m pauxy_tpu_torch input.json [--cpu]

The port's counterpart of ``bin/pauxy-tpu``. The run is on the CUDA card in
single precision; ``--cpu`` runs it on the CPU in double precision. The
driver writes its estimates file (``estimates.0.h5`` unless the input
names one) and the reblocked mixed estimates are printed at the end.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m pauxy_tpu_torch",
        description="Run an AFQMC calculation from a JSON input file.")
    parser.add_argument("input", help="JSON input file")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU in double precision")
    args = parser.parse_args(argv)

    from pauxy_tpu_torch.qmc.calc import setup_calculation

    kw = (dict(device="cpu", dtype="double") if args.cpu
          else dict(device=None, dtype="single"))
    driver = setup_calculation(args.input, **kw)
    driver.run()
    if hasattr(driver, "reporter") and driver.filename is not None:
        from pauxy_tpu_torch.analysis.blocking import analyse_energy
        from pauxy_tpu_torch.analysis.extraction import \
            extract_mixed_estimates

        frame = extract_mixed_estimates(driver.filename)
        if len(frame) > 4:
            print("# Reblocked estimates:")
            print(analyse_energy(frame, skip=max(1, len(frame) // 4)))
    return driver


if __name__ == "__main__":
    main()
