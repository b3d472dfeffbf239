#!/usr/bin/env python
"""pyscf chkfile -> QMCPACK integral file + trial wavefunction + input.json
(requires pyscf).

The PyTorch port's copy of ``tools/pyscf/pyscf_to_afqmc.py``, through
``pauxy_tpu_torch.utils.from_pyscf`` (HDF5 through
``utils.h5lite.open_file``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", dest="input_scf", required=True,
                   help="pyscf scf chkfile")
    p.add_argument("-o", "--output", dest="output", default="afqmc.h5")
    p.add_argument("-w", "--wavefile", dest="wfn", default="wfn.h5")
    p.add_argument("-t", "--thresh", dest="thresh", type=float, default=1e-5)
    p.add_argument("-oao", "--ortho-ao", dest="oao", action="store_true")
    p.add_argument("-b", "--back-prop", dest="bp", action="store_true")
    p.add_argument("-j", "--json-input", dest="json_input",
                   default="input.json")
    opts = p.parse_args(argv)

    from pauxy_tpu_torch.utils.from_pyscf import dump_pauxy
    from pauxy_tpu_torch.utils.io import write_input

    dump_pauxy(chkfile=opts.input_scf, outfile=opts.output,
               chol_cut=opts.thresh, ortho_ao=opts.oao, wfn_file=opts.wfn)
    write_input(opts.json_input, opts.output, opts.wfn, bp=opts.bp)
    print(f"# Wrote {opts.output}, {opts.wfn}, {opts.json_input}.")


if __name__ == "__main__":
    main(sys.argv[1:])
