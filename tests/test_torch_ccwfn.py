"""The ported slice end to end on the CPU in f64: RHF -> Hamiltonian ->
ccwfn.solve_cc, against the frozen oracles and pycc_tpu's trajectory."""

import contextlib
import functools
import io
import logging

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu_torch
from pycc_tpu_torch.scf import run_rhf

from .common import H2O


@functools.lru_cache(maxsize=None)
def _wfn(basis, freeze_core=True):
    return run_rhf(H2O, basis, freeze_core=freeze_core)


def _solve(cc, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return cc.solve_cc(**kw)


@pytest.mark.parametrize("basis,model,freeze_core,oracle", [
    ("sto-3g", "CCSD", True, -0.070616830152761),
    ("cc-pvdz", "CCSD", True, -0.222029814166783),
    ("cc-pvdz", "CCD", False, -0.222559319034),
    ("cc-pvdz", "CC2", False, -0.215857544656),
])
def test_oracles(basis, model, freeze_core, oracle):
    cc = pycc_tpu_torch.ccwfn(_wfn(basis, freeze_core), model=model,
                              device="cpu")
    ecc = _solve(cc, e_conv=1e-12, r_conv=1e-12, maxiter=100)
    assert cc.converged
    assert abs(ecc - oracle) < 1e-11


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.energies = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("CC Iter") and "rms" in msg:
            self.energies.append(float(msg.split("Ecorr =")[1].split()[0]))


def _trajectory(logger_name, cc):
    h = _Lines()
    logger = logging.getLogger(logger_name)
    logger.addHandler(h)
    try:
        with pytest.warns(UserWarning, match="did NOT converge"):
            _solve(cc, e_conv=1e-12, r_conv=1e-12, maxiter=5)
    finally:
        logger.removeHandler(h)
    return h.energies


def test_first_iterations_follow_pycc_tpu():
    from .common import scf
    ref = _trajectory("pycc_tpu", pycc_tpu.ccwfn(scf("H2O", "cc-pvdz")))
    port = _trajectory("pycc_tpu_torch",
                       pycc_tpu_torch.ccwfn(_wfn("cc-pvdz"), device="cpu"))
    assert len(ref) == len(port) == 5
    assert max(abs(a - b) for a, b in zip(ref, port)) < 1e-10


def test_single_precision_lands_near_double():
    wfn = _wfn("cc-pvdz")
    e_dp = _solve(pycc_tpu_torch.ccwfn(wfn, device="cpu"), e_conv=1e-10, r_conv=1e-10)
    cc = pycc_tpu_torch.ccwfn(wfn, precision="SP", device="cpu")
    assert cc.t2.dtype == torch.float32
    e_sp = _solve(cc, e_conv=1e-8, r_conv=1e-7)
    assert abs(e_sp - e_dp) < 1e-6
