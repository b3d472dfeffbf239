"""Port parity: the CI helpers (``estimators/ci.py``, copied numpy) against
JAX's.

float64, the same systems on both sides (built by each package from the
same arrays):
  * dense_eri and one_body for Hubbard, Generic and the UEG: exact;
  * fci_hamiltonian (full space and a determinant subspace), simple_fci,
    one_rdm_from_fci: 1e-10, and the 2-site dimer's closed form;
  * simple_fci_bose_fermi on the Hubbard-Holstein dimer (JAX's system
    object, which the copy reads as numpy) against JAX and the reference's
    pinned -6.232530237466693: 1e-8;
  * the system's tensors may sit on any device (read to the host).
"""

import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import ci as jci
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models.hubbard_holstein import make_hubbard_holstein
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu_torch.estimators import ci as tci
from pauxy_tpu_torch.models import make_generic, make_hubbard, make_ueg

CPU = dict(device="cpu", dtype="double")


def systems():
    h1e, chol, enuc, _ = generate_hamiltonian(4, (2, 1), seed=9)
    return {
        "hubbard": (j_make_hubbard(nup=2, ndown=1, U=4.0, nx=3, ny=1),
                    make_hubbard(2, 1, U=4.0, nx=3, ny=1, **CPU)),
        "generic": (j_make_generic((2, 1), h1e, chol, enuc),
                    make_generic((2, 1), h1e, chol, enuc, **CPU)),
        "ueg": (j_make_ueg(nup=1, ndown=1, rs=1.0, ecut=0.5),
                make_ueg(1, 1, rs=1.0, ecut=0.5, **CPU)),
    }


@pytest.mark.parametrize("model", ["hubbard", "generic", "ueg"])
def test_fci_matches_jax(model):
    jham, tham = systems()[model]
    np.testing.assert_array_equal(tci.dense_eri(tham), jci.dense_eri(jham))
    np.testing.assert_array_equal(tci.one_body(tham), jci.one_body(jham))
    th, tbasis = tci.fci_hamiltonian(tham)
    jh, jbasis = jci.fci_hamiltonian(jham)
    assert tbasis == jbasis
    np.testing.assert_allclose(th, jh, rtol=1e-12, atol=1e-12)
    te, tv, _ = tci.simple_fci(tham, nroots=3)
    je, jv, _ = jci.simple_fci(jham, nroots=3)
    np.testing.assert_allclose(te, je, rtol=1e-10, atol=1e-10)
    m = tham.nbasis
    tp = tci.one_rdm_from_fci(tv[:, 0], tbasis, m)
    jp = jci.one_rdm_from_fci(tv[:, 0], jbasis, m)
    np.testing.assert_allclose(tp, jp, rtol=1e-12, atol=1e-12)
    assert tp[0].trace().real == pytest.approx(tham.nup, abs=1e-10)
    # A determinant subspace (the PHMSD trial's rediagonalisation).
    sub = tbasis[::2]
    np.testing.assert_allclose(tci.fci_hamiltonian(tham, basis=sub)[0],
                               jci.fci_hamiltonian(jham, basis=sub)[0],
                               rtol=1e-12, atol=1e-12)


def test_hubbard_dimer_exact():
    ham = make_hubbard(1, 1, U=4.0, nx=2, ny=1, xpbc=False, **CPU)
    e, _, _ = tci.simple_fci(ham)
    assert e[0] == pytest.approx(0.5 * (4.0 - np.sqrt(32.0)), abs=1e-10)


def test_bose_fermi_fci_matches_jax():
    ham = make_hubbard_holstein(nup=1, ndown=1, U=0.0, nx=2, ny=1, w0=0.8,
                                lmbda=0.5)
    te, _, (tdets, tbos) = tci.simple_fci_bose_fermi(ham, nboson_max=20)
    je, _, (jdets, jbos) = jci.simple_fci_bose_fermi(ham, nboson_max=20)
    assert (tdets, tbos) == (jdets, jbos)
    assert te[0] == pytest.approx(je[0], abs=1e-8)
    assert te[0] == pytest.approx(-6.232530237466693, abs=1e-8)


def test_tensors_on_any_device_are_read_to_the_host():
    """dense_eri and one_body read torch tensors through the host (the
    system may sit on the card); plain arrays pass through."""
    _, tham = systems()["generic"]
    chol = tham.chol.numpy()
    view = type("G", (), {"name": "Generic", "nbasis": 4,
                          "chol": torch.from_numpy(chol),
                          "H1": tham.H1})()
    np.testing.assert_allclose(
        tci.dense_eri(view), np.einsum("pqx,rsx->pqrs", chol, chol),
        rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(tci.one_body(view), tham.H1[0].numpy())
