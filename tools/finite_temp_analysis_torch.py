#!/usr/bin/env python
"""Analyse finite-temperature AFQMC output: reblocked energies / particle
numbers per (beta, mu), optional chemical-potential fit.

The PyTorch port's copy of ``tools/finite_temp_analysis.py``, through
``pauxy_tpu_torch.analysis.thermal``.

    python tools/finite_temp_analysis_torch.py -f 'estimates.*.h5' [-s skip]
    python tools/finite_temp_analysis_torch.py -f ... -c -n 14.0   # fit mu(N=14)
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-f", nargs="+", dest="filenames", required=True)
    parser.add_argument("-s", "--skip", type=int, default=1)
    parser.add_argument("-c", "--chem-pot", dest="fit_chem_pot",
                        action="store_true",
                        help="fit the chemical potential from <N>(mu)")
    parser.add_argument("-n", "--nav", type=float, default=None,
                        help="target particle number for the mu fit")
    args = parser.parse_args(argv)

    from pauxy_tpu_torch.analysis import thermal

    files = []
    for f in args.filenames:
        files.extend(sorted(glob.glob(f)) if "*" in f else [f])
    data = thermal.analyse_energy(files, skip=args.skip)
    print(data.to_string(index=False))
    if args.fit_chem_pot:
        if args.nav is None:
            parser.error("--chem-pot requires --nav")
        mu = thermal.find_chem_pot(data, args.nav)
        print(f"# fitted chemical potential: {mu}")


if __name__ == "__main__":
    main()
