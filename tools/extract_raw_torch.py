#!/usr/bin/env python
"""Print the raw mixed-estimate frame of an output file.

The PyTorch port's copy of ``tools/extract_raw.py`` (HDF5 through
``pauxy_tpu_torch.utils.h5lite.open_file``).

    python tools/extract_raw_torch.py estimates.0.h5
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pauxy_tpu_torch.analysis.extraction import extract_mixed_estimates  # noqa: E402

if __name__ == "__main__":
    data = extract_mixed_estimates(sys.argv[1])
    print(data.to_string(index=False))
