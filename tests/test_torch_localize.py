"""The port's occupied-orbital localization (pycc_tpu_torch/scf/
localize.py) against pycc_tpu's: Pipek-Mezey and Foster-Boys from one
SCF, on H2O/cc-pVDZ and the (H2)_4 chain of tests/test_010, held to
1e-10 up to the sign of each column."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu.scf import integrals as jints
from pycc_tpu.scf import localize as jloc
from pycc_tpu.scf import run_rhf as jrun_rhf
from pycc_tpu_torch.scf import integrals as tints
from pycc_tpu_torch.scf import localize as tloc
from pycc_tpu_torch.scf import run_rhf

from .common import H2O, scf
from .test_010_local import H2_4


def _occ(wfn):
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    return np.array(wfn.Ca_subset("AO", "ACTIVE"))[:, :no]


def _same_up_to_sign(A, B):
    signs = np.sign(np.sum(A * B, axis=0))
    return np.max(np.abs(A - B * signs))


def _wfn(name):
    if name == "(H2)_4":
        return jrun_rhf(H2_4, "dz", freeze_core=False)
    return scf("H2O", "cc-pvdz", freeze_core=False)


@pytest.mark.parametrize("name", ["H2O", "(H2)_4"])
def test_pipek_mezey_matches_pycc_tpu(name):
    wfn = _wfn(name)
    C = _occ(wfn)
    S = np.asarray(wfn.S_ao)
    ref = jloc.pipek_mezey(C, S, wfn.basisset())
    port = tloc.pipek_mezey(C, S, wfn.basisset())
    assert _same_up_to_sign(ref, port) < 1e-10
    # a real rotation of the occupied space: orthonormal in S
    assert np.abs(port.T @ S @ port - np.eye(C.shape[1])).max() < 1e-10
    assert np.abs(port - C).max() > 1e-3


@pytest.mark.parametrize("name", ["H2O", "(H2)_4"])
def test_boys_matches_pycc_tpu(name):
    wfn = _wfn(name)
    C = _occ(wfn)
    ref = jloc.boys(C, jints.dipole(wfn.basisset()))
    port = tloc.boys(C, tints.dipole(wfn.basisset()))
    assert _same_up_to_sign(ref, port) < 1e-10


def test_port_scf_basis_gives_pm_the_same_atom_map():
    """The port's own basis object maps each AO to pycc_tpu's atom, so PM
    on the port's SCF localizes as pycc_tpu's does on its own."""
    jw = _wfn("H2O")
    tw = run_rhf(H2O, "cc-pvdz", freeze_core=False)
    assert np.array_equal(tloc.ao_atoms(tw.basisset()),
                          tloc.ao_atoms(jw.basisset()))
    ref = jloc.pipek_mezey(_occ(jw), np.asarray(jw.S_ao), jw.basisset())
    port = tloc.pipek_mezey(_occ(tw), np.asarray(tw.S_ao), tw.basisset())
    assert _same_up_to_sign(ref, port) < 1e-10
