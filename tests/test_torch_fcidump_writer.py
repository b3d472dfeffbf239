"""The Hubbard FCIDUMP writer of the port (models/hubbard.fcidump,
fcidump_header), on the CPU in float64.

* The string equals the JAX package's byte for byte, for a real 4-site
  ring and a twisted (complex) 3x3 lattice, and for the header alone.
* It reads back through the port's utils/qmcpack.read_fcidump to the same
  one-body integrals, U on the diagonal of the two-body ones and nothing
  else, no core energy and the electron counts (as
  tests/test_analysis_cli.py's test_hubbard_fcidump_roundtrip holds JAX's).
* Without ``to_string`` it prints the string and returns None.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import hubbard as jhub
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models import hubbard as thub
from pauxy_tpu_torch.utils import qmcpack

torch.set_num_threads(1)

LATTICES = {
    "ring4": dict(nup=2, ndown=2, U=4.0, nx=4, ny=1),
    "twisted3x3": dict(nup=3, ndown=2, U=2.5, nx=3, ny=3,
                       ktwist=[0.01, -0.02]),
}


def _pair(name):
    kw = LATTICES[name]
    return (j_make_hubbard(**kw),
            make_hubbard(**kw, device="cpu", dtype="double"))


@pytest.mark.parametrize("name", list(LATTICES))
def test_fcidump_equals_jax(name):
    jham, tham = _pair(name)
    got = thub.fcidump(tham, to_string=True)
    assert got == jhub.fcidump(jham, to_string=True)
    assert ("(" in got) is (name == "twisted3x3")


@pytest.mark.parametrize("nel,norb,spin", [(4, 4, 0), (5, 9, 1), (0, 1, -2)])
def test_header_equals_jax(nel, norb, spin):
    assert (thub.fcidump_header(nel, norb, spin)
            == jhub.fcidump_header(nel, norb, spin))


@pytest.mark.parametrize("name", list(LATTICES))
def test_fcidump_reads_back(tmp_path, name):
    kw = LATTICES[name]
    _, ham = _pair(name)
    fn = str(tmp_path / "FCIDUMP")
    with open(fn, "w") as f:
        f.write(thub.fcidump(ham, to_string=True))
    h1e, eri, ecore, nelec, ms2 = qmcpack.read_fcidump(fn)
    m = ham.nbasis
    assert nelec == (kw["nup"], kw["ndown"])
    assert ms2 == kw["nup"] - kw["ndown"] and ecore == 0.0
    np.testing.assert_allclose(h1e, ham.T[0].numpy(), atol=1e-7)
    diag = np.zeros((m, m, m, m))
    for i in range(m):
        diag[i, i, i, i] = kw["U"]
    np.testing.assert_allclose(np.abs(eri - diag).max(), 0.0, atol=1e-12)


def test_fcidump_prints_without_to_string(capsys):
    _, ham = _pair("ring4")
    assert thub.fcidump(ham) is None
    assert capsys.readouterr().out == thub.fcidump(ham, to_string=True) + "\n"
