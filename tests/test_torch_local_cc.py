"""The local filter path through the port: ccwfn(local=..., filter=True)
-> solve_cc -> cchbar -> cclambda.solve_lambda on the CPU.

The frozen energies of tests/test_010 (PNO, PNO with it2_opt, PNO++,
CPNO++, both PAO cases) at that suite's 1e-7, and the CCSD energy and
filtered Lambda pseudo-energy of one space against pycc_tpu's own run.
The filter path's dense residuals take the ladder through
`models/ccsd.vvvv_contract` (K1 on the card, its plain product here):
one ladder call an iteration, held here with a counting ladder."""

import contextlib
import functools
import io

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu_torch
from pycc_tpu.scf import run_rhf as jrun_rhf

from .common import scf
from .test_010_local import H2_4

# name: (molecule, basis, ccwfn keywords, E(CCSD), Lambda pseudo-energy)
ORACLES = {
    "pno": ("H2O", "cc-pvdz", dict(local="PNO", local_cutoff=1e-5,
                                   it2_opt=False),
            -0.218394869543943, -0.214461441319427),
    "pno_opt": ("H2O", "cc-pvdz", dict(local="PNO", local_cutoff=1e-5),
                -0.221156413159672, -0.217144045119534),
    "pnopp": ("H2O", "cc-pvdz", dict(local="PNO++", local_cutoff=1e-7,
                                     it2_opt=False),
              -0.216064367834782, -0.211938482158711),
    "cpnopp": ("H2O", "cc-pvdz", dict(local="CPNO++", local_cutoff=1e-7,
                                      it2_opt=False),
               -0.22303320613504354, -0.21890326836263854),
    "pao_h2_4_dz": ("(H2)_4", "dz", dict(local="PAO", local_cutoff=2e-2),
                    -0.108914240219735, None),
    "pao_h2o_631g": ("H2O", "6-31g", dict(local="PAO", local_cutoff=2e-2),
                     -0.149361947815815, None),
}


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _wfn(mol, basis):
    if mol == "(H2)_4":
        return jrun_rhf(H2_4, basis, freeze_core=False)
    return scf(mol, basis, freeze_core=False)


def _lambda(cc, conv=1e-12):
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    return _quiet(lam.solve_lambda, conv, conv, maxiter=100)


@pytest.mark.parametrize("name", list(ORACLES))
def test_010_filter_oracles(name):
    mol, basis, kw, e_ref, l_ref = ORACLES[name]
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(mol, basis), filter=True,
                device="cpu", **kw)
    calls = []

    def ladder(A, B):
        calls.append(1)
        return A @ B.T

    # the filter path's residual is the dense one, its ladder included
    residuals = cc.residuals
    cc.residuals = lambda F, t1, t2: residuals(F, t1, t2, ladder=ladder)
    e = _quiet(cc.solve_cc, 1e-12, 1e-12, maxiter=100)
    assert cc.converged and len(calls) == cc.niter
    assert abs(e - e_ref) < 1e-7
    if l_ref is not None:
        assert abs(_lambda(cc) - l_ref) < 1e-7


def test_filter_energy_and_lambda_match_pycc_tpu():
    mol, basis, kw, _, _ = ORACLES["pno"]
    wfn = _wfn(mol, basis)
    ref = _quiet(pycc_tpu.ccwfn, wfn, filter=True, **kw)
    e_ref = _quiet(ref.solve_cc, 1e-12, 1e-12, maxiter=100)
    jlam = pycc_tpu.cclambda(ref, _quiet(pycc_tpu.cchbar, ref))
    l_ref = _quiet(jlam.solve_lambda, 1e-12, 1e-12, maxiter=100)
    cc = _quiet(pycc_tpu_torch.ccwfn, wfn, filter=True, device="cpu", **kw)
    e = _quiet(cc.solve_cc, 1e-12, 1e-12, maxiter=100)
    assert abs(e - e_ref) < 1e-11
    assert abs(_lambda(cc) - l_ref) < 1e-11


def test_local_refuses_what_pycc_tpu_refuses():
    wfn = _wfn("H2O", "cc-pvdz")
    cc = _quiet(pycc_tpu_torch.ccwfn, wfn, local="PNO", filter=True,
                device="cpu")
    with pytest.raises(ValueError, match="canonical storage"):
        cc.solve_cc_mixed()
    with pytest.raises(ValueError, match="bf16_until"):
        cc.solve_cc(bf16_until=1e-3)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    with pytest.raises(ValueError, match="canonical storage"):
        lam.solve_lambda_mixed()
    import types
    resp = pycc_tpu_torch.ccresponse(types.SimpleNamespace(ccwfn=cc,
                                                           cclambda=lam))
    with pytest.raises(ValueError, match="canonical storage"):
        resp.solve_right_mixed("MU_Z", 0.0)
    for bad in (dict(local="LMO"), dict(local="PNO", local_mos="ER")):
        with pytest.raises(ValueError, match="not an allowed"):
            pycc_tpu_torch.ccwfn(wfn, device="cpu", **bad)
