#!/usr/bin/env python
"""Momentum distribution / natural-orbital occupations from back-propagated
one-body density matrices.

The PyTorch port's copy of ``tools/mom_dist.py``: average the stored RDM
series, print n_k (diagonal) and the eigenvalues of the symmetrised
spin-summed density matrix.

    python tools/mom_dist_torch.py -f estimates.0.h5 [-s skip]
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-f", nargs="+", dest="filenames", required=True,
                        help="estimator files (glob patterns ok)")
    parser.add_argument("-s", "--skip", type=int, default=1,
                        help="number of blocks to skip (default 1)")
    args = parser.parse_args(argv)

    from pauxy_tpu_torch.analysis.rdm import average_rdm

    files = []
    for f in args.filenames:
        files.extend(glob.glob(f) if "*" in f else [f])
    for fn in files:
        ordm, _err = average_rdm(fn, skip=args.skip)
        nk = (ordm[0] + ordm[1]).diagonal()
        print(f"# {fn}")
        print(f"nk = {nk.real}")
        psym = ordm[0] + ordm[1]
        psym = 0.5 * (psym + psym.conj().T)
        w = np.linalg.eigvalsh(psym)
        print(f"eigval = {w[::-1]}")


if __name__ == "__main__":
    main()
