"""ccwfn(model="CCSD(T)") end to end on the CPU in f64, against the frozen
(T) oracles of the reference suite (tests/test_004_models.py)."""

import contextlib
import functools
import io

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu_torch.scf import run_rhf

from .common import H2O


@functools.lru_cache(maxsize=None)
def _wfn(basis):
    return run_rhf(H2O, basis, freeze_core=True)


def _solve(cc, e_conv=1e-12, r_conv=1e-12):
    with contextlib.redirect_stdout(io.StringIO()):
        return cc.solve_cc(e_conv=e_conv, r_conv=r_conv, maxiter=100)


def _triples(basis, precision="DP", e_conv=1e-12, r_conv=1e-12):
    cc = pycc_tpu_torch.ccwfn(_wfn(basis), model="CCSD(T)",
                              precision=precision, device="cpu")
    e = _solve(cc, e_conv, r_conv)
    return cc, e, e - float(cc.cc_energy(cc.t1, cc.t2))


@pytest.mark.parametrize("basis,oracle", [
    ("sto-3g", -0.000099957499645),
    ("cc-pvdz", -0.003861236558801),
])
def test_triples_oracles(basis, oracle):
    cc, e, et = _triples(basis)
    assert cc.converged
    assert abs(et - oracle) < 1e-11
    assert cc.ecc == e


def test_ccsd_part_is_the_ccsd_energy():
    cc, e, et = _triples("cc-pvdz")
    assert abs((e - et) - -0.222029814166783) < 1e-11


def test_single_precision_triples_land_near_double():
    _, _, et_dp = _triples("cc-pvdz")
    cc, _, et_sp = _triples("cc-pvdz", "SP", 1e-8, 1e-7)
    assert cc.converged and cc.t2.dtype == torch.float32
    assert abs(et_sp - et_dp) < 1e-6


def test_unconverged_solve_returns_ccsd_without_triples():
    cc = pycc_tpu_torch.ccwfn(_wfn("sto-3g"), model="CCSD(T)",
                              device="cpu")
    with pytest.warns(UserWarning, match="did NOT converge"):
        with contextlib.redirect_stdout(io.StringIO()):
            e = cc.solve_cc(e_conv=1e-12, r_conv=1e-12, maxiter=3)
    assert not cc.converged
    assert e == cc.ecc
