"""Builder of a plane-wave uniform electron gas configuration.

The system is fixed by (nup, ndown, rs, ecut); nothing is drawn. The
program gets ``make_ueg`` and ``rhf_identity_trial`` (the nup / ndown
lowest plane waves); the reference (``reference/ueg.py``) builds its basis,
its q grid and its density operators again from the same four numbers. As
``AFQMC`` passes the electron gas no ``taylor_impl``, the mix's route goes
through ``PAUXY_TPU_TAYLOR_UEG``, set before ``AFQMC`` is built.
"""

from __future__ import annotations

from portbench.reference.ueg import UEGModel


class Built:
    def __init__(self, cfg, mix, seed, device, dtype):
        from pauxy_tpu_torch.models import make_ueg, rhf_identity_trial

        del seed
        self.cfg, self.mix, self.device = cfg, mix, device
        self.ham = make_ueg(cfg["nup"], cfg["ndown"], rs=cfg["rs"],
                            ecut=cfg["ecut"], device=device, dtype=dtype)
        self.trial = rhf_identity_trial(self.ham, device=device, dtype=dtype)
        self.nfields = self.ham.nfields
        self.propagator_options = {
            "matmul_precision": mix["matmul_precision"]}
        self.env = {"PAUXY_TPU_TAYLOR_UEG": mix["taylor_impl"]}

    def reference(self, dtype):
        c = self.cfg
        return UEGModel(c["nup"], c["ndown"], c["rs"], c["ecut"],
                        self.mix["dt"], device=self.device, dtype=dtype)


def build(cfg: dict, mix: dict, seed: int, device, dtype="single"):
    return Built(cfg, mix, seed, device, dtype)

