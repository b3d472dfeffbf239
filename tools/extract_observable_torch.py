#!/usr/bin/env python
"""Extract an observable (RDM / ITCF / raw estimator group) to .npy.

The PyTorch port's copy of ``tools/extract_observable.py``: the same
options and output, read through ``pauxy_tpu_torch.analysis`` (HDF5
through ``utils.h5lite.open_file``).

    python tools/extract_observable_torch.py -f estimates.0.h5 -o back_propagated:one_rdm
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-f", "--filename", required=True)
    parser.add_argument("-o", "--observable", default="back_propagated:one_rdm",
                        help="group:estimator, e.g. itcf:real_space_greens_function")
    parser.add_argument("--out", default=None, help="output .npy path")
    args = parser.parse_args(argv)

    import numpy as np

    from pauxy_tpu_torch.analysis import extraction

    group, _, name = args.observable.partition(":")
    if group == "back_propagated" and "rdm" in name:
        data = extraction.extract_rdm(args.filename, rdm_type=name)
    elif group == "itcf":
        # Rows are pushed already normalized (ITCFReporter.block_row);
        # the stored denominator is a liveness flag — blocks whose
        # measurement window did not complete are zero-filled. Select the
        # live rows (dividing again would shrink values by total weight).
        data, denom = extraction.extract_itcf(
            args.filename, name or "real_space_greens_function")
        data = data[np.abs(np.asarray(denom).ravel()) > 0]
    else:
        data = extraction.extract_data(args.filename, group, name, raw=True)
    out = args.out or (name + ".npy")
    np.save(out, data)
    print(f"# wrote {out} shape={np.asarray(data).shape}")


if __name__ == "__main__":
    main()
