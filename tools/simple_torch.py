#!/usr/bin/env python
"""One-shot reblocked analysis of one or more output files:
``python tools/simple_torch.py <start_time> '<glob>'``.

The PyTorch port's copy of ``tools/simple.py``, through
``pauxy_tpu_torch.analysis.blocking.analyse_estimates``.
"""

import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pandas as pd  # noqa: E402

from pauxy_tpu_torch.analysis import blocking  # noqa: E402

if __name__ == "__main__":
    start_time = float(sys.argv[1])
    files = sorted(glob.glob(sys.argv[2]))
    pd.options.display.float_format = "{:,.8e}".format
    out = blocking.analyse_estimates(files, start_time=start_time)
    print(out)
