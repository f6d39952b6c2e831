"""The DF real-time right-hand side with its ladders cut into a-blocks,
as at full width, against the dense right-hand side on the same
integrals.

Under complex amplitudes both ladders of the right-hand side assemble a
complex W (the T side's factor is dressed by the complex t1, the Lambda
side's Bd_ae too), so each goes in a-block by a-block as [Re W; Im W] on
a quarter of the real block budget (`dfhbar.ladder_apply`): at (no, nv)
= (24, 216) 36 blocks of 6 a each.  Here the budget is set small
(LADDER_MAX_ELEMS, monkeypatched) so that H2O/aug-cc-pVDZ (frozen core,
(4, 36)) takes 12 blocks of 3 on each side the same way; its factors are
the MO ERI's Cholesky at 1e-14, so the DF right-hand side equals the
dense one of the same molecule at 1e-10, at the converged state and off
it.  The ladder calls are counted by side.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
import pycc_tpu_torch.models.dfhbar as dfhbar
import pycc_tpu_torch.rt.lasers as tlas
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.ops.cholesky import cholesky_factor_eri
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O

pytestmark = pytest.mark.filterwarnings(
    "error:Casting complex values to real")

V_ARGS = (0.05, 0.0, 0.01, 0.05)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(H2O, "aug-cc-pvdz", freeze_core=True)


def _solve(cc):
    _quiet(cc.solve_cc, 1e-12, 1e-12)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    _quiet(lam.solve_lambda, 1e-12, 1e-12)
    return cc, lam


@functools.lru_cache(maxsize=None)
def _pair():
    dense = _solve(pycc_tpu_torch.ccwfn(_wfn(), device="cpu"))
    H = build_hamiltonian(_wfn(), device="cpu")
    B = cholesky_factor_eri(H.ERI, tol=1e-14, device="cpu")
    df = _solve(pycc_tpu_torch.ccwfn.from_df_factors(
        B, H.F, H.no, mu=torch.stack(H.mu), device="cpu"))
    return dense, df


def _rt(cc, lam, ladder=vvvv_nt_reference):
    return pycc_tpu_torch.rtcc(cc, lam, None, tlas.gaussian_laser(*V_ARGS),
                               ladder=ladder)


def test_blocked_df_rhs_equals_the_dense_rhs(monkeypatch):
    (dc, dl), (fc, fl) = _pair()
    no, nv = fc.no, fc.nv
    assert (no, nv) == (4, 36)
    # a real W would take 3 a-blocks of 12, a complex one takes 12 of 3
    monkeypatch.setattr(dfhbar, "LADDER_MAX_ELEMS", 12 * nv ** 3)
    calls = []

    def ladder(A, B, bf16=False):
        calls.append((tuple(A.shape), tuple(B.shape)))
        return vvvv_nt_reference(A, B, bf16)
    rt_d, rt_f = _rt(dc, dl), _rt(fc, fl, ladder)
    sides = {}
    for name in ("t_residuals", "lambda_residuals"):
        def counted(*args, _fn=getattr(rt_f, name), _name=name):
            n0 = len(calls)
            out = _fn(*args)
            sides[_name] = len(calls) - n0
            return out
        setattr(rt_f, name, counted)
    y0 = rt_d.collect_amps(dc.t1, dc.t2, dl.l1, dl.l2, 0)
    y1 = rt_f.collect_amps(fc.t1, fc.t2, fl.l1, fl.l2, 0)
    assert (y0 - y1).abs().max().item() < 1e-9
    rng = np.random.default_rng(11)
    noise = torch.from_numpy(rng.standard_normal(y0.shape)
                             + 1j * rng.standard_normal(y0.shape))
    for y in (y0, y0 + 0.01 * noise):
        calls.clear()
        f_df = rt_f.f(0.02, y)
        assert sides == {"t_residuals": 12, "lambda_residuals": 12}
        assert calls == [((2 * no * no, nv * nv), (2 * 3 * nv, nv * nv))] * 24
        assert (f_df - rt_d.f(0.02, y)).abs().max().item() < 1e-10
