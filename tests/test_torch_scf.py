"""The port's host SCF (a copy of pycc_tpu.scf) against pycc_tpu's."""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.scf as jscf
import pycc_tpu_torch.scf as tscf
from pycc_tpu_torch.scf import integrals as tints

from .common import H2O, H2O_TEACH


@functools.lru_cache(maxsize=None)
def _pair(basis):
    return (jscf.run_rhf(H2O, basis, freeze_core=True),
            tscf.run_rhf(H2O, basis, freeze_core=True))


@pytest.mark.parametrize("basis", ["sto-3g", "cc-pvdz"])
def test_rhf_matches_pycc_tpu(basis):
    ref, port = _pair(basis)
    assert abs(port.energy() - ref.energy()) < 1e-12
    assert np.max(np.abs(port.eps - ref.eps)) < 1e-10
    assert np.max(np.abs(port.C - ref.C)) < 1e-10
    assert port.frzcpi() == ref.frzcpi() and port.doccpi() == ref.doccpi()


def test_rhf_h2o_teach_oracle():
    wfn = tscf.run_rhf(H2O_TEACH, "sto-3g")
    assert abs(wfn.energy() - -74.942079928192) < 1e-10


def test_native_eri_matches_python_engine():
    basis = tscf.BasisSet(tscf.Molecule(H2O), "sto-3g")
    assert np.max(np.abs(tints.eri(basis) - tints._eri_python(basis))) < 1e-12


def test_df_scf_is_not_ported():
    """The DF (integral-direct Cholesky) SCF, once refused, equals the
    exact SCF at a tight df_tol and keeps its AO factors."""
    wfn = tscf.run_rhf(H2O, "cc-pvdz", freeze_core=True, df=True,
                       df_tol=1e-10)
    assert abs(wfn.energy() - _pair("cc-pvdz")[1].energy()) < 1e-9
    assert wfn.B_ao is not None and wfn.B_tol == 1e-10
    nbf = wfn.basisset().nbf
    assert wfn.B_ao.shape[1:] == (nbf, nbf)
