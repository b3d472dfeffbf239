#!/usr/bin/env python
"""Reblocking analysis of estimator output files.

The PyTorch port's copy of ``tools/reblock.py`` (pyblock-free), through
``pauxy_tpu_torch.analysis``.

    python tools/reblock_torch.py -s 10 -f estimates.0.h5 [more.h5 ...]
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-s", "--skip", type=int, default=0,
                        help="number of equilibration blocks to discard")
    parser.add_argument("-f", "--files", nargs="+", required=True)
    parser.add_argument("-b", "--back-propagated", action="store_true",
                        help="analyse back-propagated estimates")
    args = parser.parse_args(argv)

    import pandas as pd

    from pauxy_tpu_torch.analysis import blocking, extraction

    if args.back_propagated:
        frames = [extraction.extract_bp_estimates(f, skip=args.skip)
                  for f in args.files]
        frame = pd.concat(frames)
        print(frame.describe())
        return
    frames = [extraction.extract_mixed_estimates(f) for f in args.files]
    frame = pd.concat(frames)
    res = blocking.reblock_mixed(frame, skip=args.skip)
    pd.set_option("display.width", 200)
    print(res.to_string())


if __name__ == "__main__":
    main()
