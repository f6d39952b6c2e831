"""The port's CC3 over Cholesky/DF factors against pycc_tpu's on the CPU in
float64, on the H2O/STO-3G factors of tests/test_026: the factor-assembled
T1-dressed W's, the slab-form residuals, Lambda extras and one-pdm over
factors (1e-12 against pycc_tpu, and equal to the dense forms on the
factor-rebuilt ERI), and storage='df' CC3 solves, Lambda-CC3 and one-pdms
against dense storage (1e-9), from an SCF and from prepared factors."""

import contextlib
import functools
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu.models import cc3 as jcc3
from pycc_tpu.models.dfccsd import df_blocks as jdf_blocks
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models import cc3 as tcc3
from pycc_tpu_torch.models.dfccsd import df_blocks as tdf_blocks
from pycc_tpu_torch.scf import run_rhf

from .common import H2O


@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(H2O, "sto-3g", freeze_core=True)


@functools.lru_cache(maxsize=None)
def _setup():
    """test_026's inputs in both packages: factors of the MO ERI at
    tol=1e-14, the ERI and L rebuilt from them, and random t1/t2 (t2 not
    pair-symmetrised, so that the factor derivations hold term by term)."""
    H = build_hamiltonian(_wfn(), device="cpu")
    no = H.no
    nv = H.F.shape[0] - no
    B = np.asarray(cholesky_factor_eri(H.ERI.numpy(), tol=1e-14))
    rec = np.einsum("Ppr,Pqs->pqrs", B, B)
    L = 2.0 * rec - rec.swapaxes(2, 3)
    rng = np.random.default_rng(31)
    t1 = 0.05 * rng.standard_normal((no, nv))
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    F = H.F.numpy()
    jax_in = (jnp.asarray(F), jdf_blocks(jnp.asarray(B), no),
              jnp.asarray(t1), jnp.asarray(t2))
    port_in = (torch.tensor(F), tdf_blocks(torch.tensor(B), no),
               torch.tensor(t1), torch.tensor(t2))
    dense = (torch.tensor(rec), torch.tensor(L),
             torch.tensor(rec[no:, no:, no:, no:]).contiguous())
    return no, jax_in, port_in, dense


def gap(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("scan_layout", [False, True])
def test_cc3_intermediates_df_match_pycc_tpu(scan_layout):
    no, (_, jdfb, jt1, _), (_, tdfb, tt1, _), (rec, _, _) = _setup()
    ref = jcc3.cc3_intermediates_df(jdfb, jt1, no, scan_layout=scan_layout)
    out = tcc3.cc3_intermediates_df(tdfb, tt1, no, scan_layout=scan_layout)
    for a, b in zip(ref, out):
        assert gap(a, b) < 1e-12
    if not scan_layout:
        # and equal to the dense form on the factor-rebuilt ERI
        for a, b in zip(tcc3.cc3_intermediates(rec, tt1, no), out):
            assert (a - b).abs().max().item() < 1e-11


def test_cc3_scan_prep_df_matches_pycc_tpu():
    no, (jF, jdfb, jt1, jt2), (tF, tdfb, tt1, tt2), _ = _setup()
    ref = jcc3.cc3_scan_prep_df(jF, jdfb, jt1, jt2, no)
    out = tcc3.cc3_scan_prep_df(tF, tdfb, tt1, tt2, no)
    assert len(ref) == len(out) == 10
    for a, b in zip(ref, out):
        assert gap(a, b) < 1e-12


@pytest.mark.parametrize("real_time", [False, True])
def test_residuals_cc3_scan_df_match_pycc_tpu(real_time):
    """Against pycc_tpu's residuals over the same factors, and against the
    port's dense full-tensor residuals on the factor-rebuilt ERI."""
    no, (jF, jdfb, jt1, jt2), (tF, tdfb, tt1, tt2), dense = _setup()
    shift = 0.01 if real_time else 0.0
    jkw = dict(real_time=True, F_ref=jF) if real_time else {}
    tkw = dict(real_time=True, F_ref=tF) if real_time else {}
    ref = jcc3.residuals_cc3_scan_df(jF + shift, jdfb, jt1, jt2, no, **jkw)
    out = tcc3.residuals_cc3_scan_df(tF + shift, tdfb, tt1, tt2, no, **tkw)
    full = tcc3.residuals_cc3(tF + shift, *dense, tt1, tt2, no, **tkw)
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < 1e-12
        assert (b - c).abs().max().item() < 1e-11


def test_df_residual_row_chunked_equals_whole_row():
    """test_026's k-chunked row check (kc=2) on the port's DF prep, the
    real-time term included."""
    no, _, (tF, tdfb, tt1, tt2), _ = _setup()
    _, _, *prep = tcc3.cc3_scan_prep_df(tF, tdfb, tt1, tt2, no)
    Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, Vov = prep
    nv = tt1.shape[1]
    for rt, vov in ((False, Vov), (True, Vov + 0.01)):
        args = (Wabei_o, Wmbij_t, tt2, eps, Lo, Fme, Wamef, Wmnie, vov, no,
                rt)
        whole = (torch.zeros((no, nv), dtype=torch.float64),
                 torch.zeros((no, no, nv, nv), dtype=torch.float64))
        chunked = tuple(torch.zeros_like(x) for x in whole)
        for i in range(no):
            tcc3._cc3_row_xs(i, whole, *args)
            tcc3._cc3_row_xs_chunked(i, chunked, *args, 2)
        for a, b in zip(whole, chunked):
            assert (a - b).abs().max().item() < 1e-12, rt


def _solve(cc):
    with contextlib.redirect_stdout(io.StringIO()):
        return cc.solve_cc(e_conv=1e-11, r_conv=1e-11)


@functools.lru_cache(maxsize=None)
def _dense_energy():
    return _solve(pycc_tpu_torch.ccwfn(_wfn(), model="CC3", device="cpu"))


def test_df_cc3_solve_equals_dense():
    cc = pycc_tpu_torch.ccwfn(_wfn(), model="CC3", storage="df",
                              df_tol=1e-13, device="cpu")
    e = _solve(cc)
    assert cc.converged and cc.H.ERI is None
    assert abs(e - _dense_energy()) < 1e-9


def test_from_df_factors_cc3_equals_dense():
    """From prepared factors, without an SCF object."""
    H = build_hamiltonian(_wfn(), device="cpu")
    B = cholesky_factor_eri(H.ERI.numpy(), tol=1e-13)
    cc = pycc_tpu_torch.ccwfn.from_df_factors(np.asarray(B), H.F.numpy(),
                                              H.no, model="CC3",
                                              device="cpu")
    e = _solve(cc)
    assert cc.converged and cc.model == "CC3"
    assert abs(e - _dense_energy()) < 1e-9


# ---------------------------------------------------------------------------
# Lambda-CC3 and the CC3 one-pdm over factors
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lambdas():
    """test_026's l1 and l2 (l2 pair-symmetrised), numpy."""
    no, (_, _, jt1, jt2), _, _ = _setup()
    nv = jt1.shape[1]
    rng = np.random.default_rng(5)
    l1 = 0.05 * rng.standard_normal((no, nv))
    l2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    return l1, l2 + l2.transpose(1, 0, 3, 2)


def test_cc3_lambda_intermediates_df_match_pycc_tpu_and_dense():
    no, (_, jdfb, jt1, _), (_, tdfb, tt1, _), (rec, _, _) = _setup()
    ref = jcc3.cc3_lambda_intermediates_df(jdfb, jt1, no)
    out = tcc3.cc3_lambda_intermediates_df(tdfb, tt1, no)
    for a, b in zip(ref, out):
        assert gap(a, b) < 1e-12
    Wmbje, Wmbej, Wabef = tcc3.cc3_lambda_intermediates(rec, tt1, no)
    assert (Wmbje - out[0]).abs().max().item() < 1e-11
    assert (Wmbej - out[1]).abs().max().item() < 1e-11
    # the implicit Wvvvv through its one consumer, the Y1 'bide,deab' term
    nv = tt1.shape[1]
    Z = torch.tensor(np.random.default_rng(7).standard_normal(
        (nv, no, nv, nv)))
    assert (tcc3._wvvvv_y1(Z, out[2]) - tcc3._wvvvv_y1(Z, Wabef)).abs() \
        .max().item() < 1e-11


def test_cc3_lambda_prep_df_matches_pycc_tpu():
    no, (jF, jdfb, jt1, jt2), (tF, tdfb, tt1, tt2), _ = _setup()
    ref = jcc3.cc3_lambda_prep_df(jF, jdfb, jt1, jt2, no)
    out = tcc3.cc3_lambda_prep_df(tF, tdfb, tt1, tt2, no)
    assert len(ref) == len(out) == 13
    for a, b in zip(ref, out):
        assert gap(a, b) < 1e-12


@pytest.mark.parametrize("real_time", [False, True])
def test_cc3_lambda_extra_scan_df_matches_pycc_tpu_and_dense(real_time):
    no, (jF, jdfb, jt1, jt2), (tF, tdfb, tt1, tt2), (rec, L, _) = _setup()
    l1, l2 = _lambdas()
    shift = 0.01 if real_time else 0.0
    jkw = dict(real_time=True, F_ref=jF) if real_time else {}
    tkw = dict(real_time=True, F_ref=tF) if real_time else {}
    ref = jax.jit(jcc3.cc3_lambda_extra_scan_df,
                  static_argnames=("no", "real_time"))(
        jF + shift, jdfb, jt1, jt2, jnp.asarray(l1), jnp.asarray(l2),
        no=no, **jkw)
    out = tcc3.cc3_lambda_extra_scan_df(tF + shift, tdfb, tt1, tt2,
                                        torch.tensor(l1), torch.tensor(l2),
                                        no, **tkw)
    full = tcc3.cc3_lambda_extra(tF + shift, rec, L, tt1, tt2,
                                 torch.tensor(l1), torch.tensor(l2), no,
                                 **tkw)
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < 1e-12
        assert (b - c).abs().max().item() < 1e-11


def test_cc3_onepdm_over_factors_matches_pycc_tpu_and_dense():
    """cc3_onepdm_scan's DF branch against pycc_tpu's and against the
    port's dense full-tensor one-pdm on the factor-rebuilt ERI."""
    no, (jF, jdfb, jt1, jt2), (tF, tdfb, tt1, tt2), (rec, L, _) = _setup()
    l1, l2 = _lambdas()
    nv = tt1.shape[1]
    common = dict(no=no, nv=nv, nact=no + nv, model="CC3", t3_scan=None)
    jcc = types.SimpleNamespace(storage="df", dfb=jdfb,
                                H=types.SimpleNamespace(F=jF), **common)
    tcc = types.SimpleNamespace(storage="df", dfb=tdfb,
                                H=types.SimpleNamespace(F=tF), **common)
    dcc = types.SimpleNamespace(storage="full", H=types.SimpleNamespace(
        F=tF, ERI=rec, L=L), **common)
    ref = jcc3.cc3_onepdm_scan(jcc, jt1, jt2, jnp.asarray(l1),
                               jnp.asarray(l2))
    out = tcc3.cc3_onepdm_scan(tcc, tt1, tt2, torch.tensor(l1),
                               torch.tensor(l2))
    full = tcc3.cc3_onepdm(dcc, tt1, tt2, torch.tensor(l1), torch.tensor(l2))
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < 1e-12
        assert (b - c).abs().max().item() < 1e-11


@functools.lru_cache(maxsize=None)
def _cc3_lambda(storage):
    kw = dict(storage="df", df_tol=1e-13) if storage == "df" else {}
    cc = pycc_tpu_torch.ccwfn(_wfn(), model="CC3", device="cpu", **kw)
    _solve(cc)
    with contextlib.redirect_stdout(io.StringIO()):
        lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
        lecc = lam.solve_lambda(e_conv=1e-11, r_conv=1e-11)
    return cc, lam, lecc


def test_df_cc3_lambda_and_onepdm_equal_dense():
    """test_026 end to end through the port: the storage='df' Lambda-CC3
    pseudo-energy, l1 and CC3 one-pdm equal dense storage's."""
    (cc_f, lam_f, le_f), (cc_d, lam_d, le_d) = (_cc3_lambda("df"),
                                                _cc3_lambda("full"))
    assert lam_f.converged and lam_d.converged
    assert abs(le_f - le_d) < 1e-9
    assert (lam_f.l1 - lam_d.l1).abs().max().item() < 1e-7
    pdms = [pycc_tpu_torch.ccdensity(cc, lam, onlyone=True).compute_onepdm(
        cc.t1, cc.t2, lam.l1, lam.l2)
        for cc, lam in ((cc_f, lam_f), (cc_d, lam_d))]
    for a, b in zip(*pdms):
        assert (a - b).abs().max().item() < 1e-9
