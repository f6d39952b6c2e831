"""The port's Lambda residuals and solver against pycc_tpu's: the residuals
on the synthetic inputs of test_torch_cchbar (1e-12), the first Lambda
iterations on H2O/cc-pVDZ (1e-10), and the frozen pseudo-energies of
tests/test_005 through the port on the CPU (1e-11)."""

import contextlib
import functools
import io
import logging
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.cclambda
import pycc_tpu_torch
import pycc_tpu_torch.cclambda
from pycc_tpu_torch.models.ccsd import vvvv_contract_efab
from pycc_tpu_torch.scf import run_rhf

from .common import H2O
from .test_torch_cchbar import MODELS, NO, NV, gap, hbars, synthetic_inputs

# the packages export the solver classes under the module names
jlam = sys.modules["pycc_tpu.cclambda"]
tlam = sys.modules["pycc_tpu_torch.cclambda"]


def _sources():
    rng = np.random.default_rng(17)
    S1 = 0.01 * rng.standard_normal((NO, NV))
    S2 = 0.01 * rng.standard_normal((NO, NO, NV, NV))
    return S1, S2


@pytest.mark.parametrize("sources", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_lambda_residuals_match_pycc_tpu(model, sources):
    jH, tH, t1, t2, l1, l2 = synthetic_inputs()
    jhb, thb = hbars(model)
    S1 = S2 = None
    if sources:
        S1, S2 = _sources()
    j = jlam.lambda_residuals(
        model, jhb, jH.F, jH.ERI, jH.L, jnp.asarray(t1), jnp.asarray(t2),
        jnp.asarray(l1), jnp.asarray(l2), NO,
        None if S1 is None else jnp.asarray(S1),
        None if S2 is None else jnp.asarray(S2))
    t = tlam.lambda_residuals(
        model, thb, tH.F, tH.ERI, tH.L, torch.from_numpy(t1),
        torch.from_numpy(t2), torch.from_numpy(l1), torch.from_numpy(l2), NO,
        None if S1 is None else torch.from_numpy(S1),
        None if S2 is None else torch.from_numpy(S2))
    assert gap(j[0], t[0]) < 1e-12
    assert gap(j[1], t[1]) < 1e-12


@pytest.mark.parametrize("model", MODELS)
def test_lambda_residuals_from_F_match_pycc_tpu(model):
    jH, tH, t1, t2, l1, l2 = synthetic_inputs()
    j = jlam.lambda_residuals_from_F(
        model, jH.F, jH.ERI, jH.L, jnp.asarray(t1), jnp.asarray(t2),
        jnp.asarray(l1), jnp.asarray(l2), NO)
    t = tlam.lambda_residuals_from_F(
        model, tH.F, tH.ERI, tH.L, torch.from_numpy(t1), torch.from_numpy(t2),
        torch.from_numpy(l1), torch.from_numpy(l2), NO)
    assert gap(j[0], t[0]) < 1e-12
    assert gap(j[1], t[1]) < 1e-12


def test_goo_gvv_and_pseudoenergy_match_pycc_tpu():
    jH, tH, _, t2, _, l2 = synthetic_inputs()
    jt2, jl2 = jnp.asarray(t2), jnp.asarray(l2)
    tt2, tl2 = torch.from_numpy(t2), torch.from_numpy(l2)
    assert gap(jlam.build_Goo(jt2, jl2), tlam.build_Goo(tt2, tl2)) < 1e-12
    assert gap(jlam.build_Gvv(jt2, jl2), tlam.build_Gvv(tt2, tl2)) < 1e-12
    assert abs(float(jlam.pseudoenergy(jH.ERI, jl2, NO))
               - tlam.pseudoenergy(tH.ERI, tl2, NO).item()) < 1e-12


def test_vvvv_contract_efab_matches_einsum():
    rng = np.random.default_rng(5)
    no, nv = 3, 7
    tau = torch.from_numpy(rng.standard_normal((no, no, nv, nv)))
    W = torch.from_numpy(rng.standard_normal((nv, nv, nv, nv)))
    Wt = W.permute(2, 3, 0, 1).contiguous()
    out = vvvv_contract_efab(tau, Wt)
    ref = torch.einsum("ijef,efab->ijab", tau, W)
    assert (out - ref).abs().max().item() < 1e-12


@functools.lru_cache(maxsize=None)
def _wfn(basis):
    return run_rhf(H2O, basis, freeze_core=True)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _port_lambda(basis):
    cc = pycc_tpu_torch.ccwfn(_wfn(basis), device="cpu")
    ecc = _quiet(cc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    hb = _quiet(pycc_tpu_torch.cchbar, cc)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    lecc = _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12)
    return cc, hb, lam, ecc, lecc


@pytest.mark.parametrize("basis,oracle", [
    ("sto-3g", -0.068826452648939),
    ("cc-pvdz", -0.217838951550509),
])
def test_lambda_pseudoenergy_oracles(basis, oracle):
    _, _, lam, _, lecc = _port_lambda(basis)
    assert lam.converged
    assert abs(lecc - oracle) < 1e-11


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.energies = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("LCC Iter") and "rms" in msg:
            self.energies.append(float(msg.split("PseudoE =")[1].split()[0]))


def _trajectory(logger_name, lam):
    h = _Lines()
    logger = logging.getLogger(logger_name)
    logger.addHandler(h)
    try:
        with pytest.warns(UserWarning, match="did NOT converge"):
            _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12, maxiter=5)
    finally:
        logger.removeHandler(h)
    return h.energies


def test_first_lambda_iterations_follow_pycc_tpu():
    from .common import scf
    jcc = pycc_tpu.ccwfn(scf("H2O", "cc-pvdz"))
    _quiet(jcc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    ref = _trajectory("pycc_tpu",
                      pycc_tpu.cclambda(jcc, _quiet(pycc_tpu.cchbar, jcc)))
    cc, hb, _, _, _ = _port_lambda("cc-pvdz")
    port = _trajectory("pycc_tpu_torch", pycc_tpu_torch.cclambda(cc, hb))
    assert len(ref) == len(port) == 5
    assert max(abs(a - b) for a, b in zip(ref, port)) < 1e-10


def test_unconverged_lambda_keeps_the_extrapolated_iterate():
    cc, hb, _, _, _ = _port_lambda("sto-3g")
    lam = pycc_tpu_torch.cclambda(cc, hb)
    with pytest.warns(UserWarning, match="did NOT converge"):
        _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12, maxiter=2)
    assert not lam.converged and lam.niter == 2
    assert torch.isfinite(lam.l2).all()


def test_single_precision_post_convergence_lands_near_double():
    """precision='SP' runs HBAR, Lambda-CCSD(T), the densities and EOM in
    float32 and lands within 1e-6 of DP (the f32 noise floor)."""
    out = {}
    for prec, conv in (("DP", 1e-10), ("SP", 1e-7)):
        cc = pycc_tpu_torch.ccwfn(_wfn("cc-pvdz"), model="CCSD(T)",
                                  make_t3_density=True, precision=prec,
                                  device="cpu")
        e = _quiet(cc.solve_cc, e_conv=conv, r_conv=conv)
        hb = _quiet(pycc_tpu_torch.cchbar, cc)
        lam = pycc_tpu_torch.cclambda(cc, hb)
        lecc = _quiet(lam.solve_lambda, e_conv=conv, r_conv=conv)
        edens = _quiet(pycc_tpu_torch.ccdensity(cc, lam).compute_energy)
        eom = pycc_tpu_torch.cceom(hb)
        E, C = _quiet(eom.solve_eom, N=2, e_conv=1e-6, r_conv=1e-4)
        assert lam.converged and eom.converged
        assert lam.l2.dtype == C.dtype == cc.t2.dtype
        out[prec] = np.array([e, lecc, edens, *E])
    assert np.abs(out["SP"] - out["DP"]).max() < 1e-6
