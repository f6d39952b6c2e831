"""Real-time CC over Cholesky/DF factors in the port against pycc_tpu's.

On tests/test_025's exact factors of H2O/STO-3G (frozen core,
cholesky_factor_eri(tol=1e-14)): the DF right-hand side of CCD, CC2, CCSD
and CC3 equals pycc_tpu's to 1e-12 (converged and perturbed states) and
the port's dense right-hand side to 1e-10, a step's observables equal the
dense ones to 1e-9, Lambda from a field-dressed F over factors
(`cclambda.lambda_residuals_from_F_df`, `cclambda.residuals`) equals
pycc_tpu's, and each of the right-hand side's two complex ladders is one
ladder call an a-block.  A complex value cast to a real dtype anywhere on
these paths fails the test.
"""

import contextlib
import functools
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.cclambda
import pycc_tpu.rt.lasers as jlas
import pycc_tpu_torch
import pycc_tpu_torch.cclambda
import pycc_tpu_torch.rt.integrators as tint
import pycc_tpu_torch.rt.lasers as tlas
from pycc_tpu.hamiltonian import build_hamiltonian
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu.rt.integrators import rk4 as jrk4
from pycc_tpu.scf import run_rhf as jrun_rhf
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O

# the packages export the solver classes under the module names
jlam = sys.modules["pycc_tpu.cclambda"]
tlam = sys.modules["pycc_tpu_torch.cclambda"]

pytestmark = pytest.mark.filterwarnings(
    "error:Casting complex values to real")

V_ARGS = (0.05, 0.0, 0.01, 0.05)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _factors():
    wfn = jrun_rhf(H2O, "sto-3g", freeze_core=True)
    H = build_hamiltonian(wfn, host=True)
    B = np.asarray(cholesky_factor_eri(np.asarray(H.ERI), tol=1e-14))
    mu = np.stack([np.asarray(m) for m in H.mu])
    return B, np.asarray(H.F), H.no, mu


def _solve(pkg, cc):
    _quiet(cc.solve_cc, 1e-12, 1e-12)
    lam = pkg.cclambda(cc, _quiet(pkg.cchbar, cc))
    _quiet(lam.solve_lambda, 1e-12, 1e-12)
    return cc, lam


@functools.lru_cache(maxsize=None)
def _port_df(model, nblocks=None):
    B, F, no, mu = _factors()
    cc = pycc_tpu_torch.ccwfn.from_df_factors(B, F, no, model=model, mu=mu,
                                              df_nblocks=nblocks,
                                              device="cpu")
    return _solve(pycc_tpu_torch, cc)


@functools.lru_cache(maxsize=None)
def _port_dense(model):
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, "sto-3g", freeze_core=True),
                              model=model, device="cpu")
    return _solve(pycc_tpu_torch, cc)


@functools.lru_cache(maxsize=None)
def _ref_df(model):
    B, F, no, mu = _factors()
    cc = _quiet(pycc_tpu.ccwfn.from_df_factors, B, F, no, model=model,
                mu=mu)
    return _solve(pycc_tpu, cc)


def _rt(cc, lam, **kw):
    return pycc_tpu_torch.rtcc(cc, lam, None, tlas.gaussian_laser(*V_ARGS),
                               **kw)


def _y0(cc, lam):
    return np.asarray(pycc_tpu_torch.rtcc(cc, lam, None, None).collect_amps(
        cc.t1, cc.t2, lam.l1, lam.l2, 0))


def _perturbed(y0, seed=7):
    rng = np.random.default_rng(seed)
    return y0 + 0.01 * (rng.standard_normal(y0.shape)
                        + 1j * rng.standard_normal(y0.shape))


@pytest.mark.parametrize("model", ["CCD", "CC2", "CCSD", "CC3"])
def test_df_rhs_equals_pycc_tpu(model):
    tc, tl = _port_df(model)
    jc, jl = _ref_df(model)
    jrt = pycc_tpu.rtcc(jc, jl, None, jlas.gaussian_laser(*V_ARGS))
    trt = _rt(tc, tl)
    y0 = np.asarray(jrt.collect_amps(jc.t1, jc.t2, jl.l1, jl.l2,
                                     jnp.asarray(0.0 + 0.0j)))
    assert np.abs(y0 - _y0(tc, tl)).max() < 1e-11
    for y in (y0, _perturbed(y0)):
        ref = np.asarray(jrt.f(0.02, y))
        assert np.abs(trt.f(0.02, y) - ref).max() < 1e-12


@pytest.mark.parametrize("model", ["CC2", "CCSD", "CC3"])
def test_df_rhs_equals_dense(model):
    """tests/test_025's DF RHS = dense RHS (1e-10) through the port, at the
    converged state and off it."""
    fc, fl = _port_df(model)
    dc, dl = _port_dense(model)
    y0 = _y0(dc, dl)
    assert np.abs(y0 - _y0(fc, fl)).max() < 1e-9
    for y in (y0, _perturbed(y0)):
        assert np.abs(_rt(fc, fl).f(0.02, y) - _rt(dc, dl).f(0.02, y)).max() \
            < 1e-10


@pytest.mark.parametrize("model", ["CCSD", "CC3"])
def test_step_observables_df_equal_dense(model):
    """tests/test_025::test_step_observables_df (and the CC3 case's
    observables): one rk4 step, its Lagrangian and dipole, DF = dense at
    1e-9; the CCSD DF step equals pycc_tpu's DF step (CC3's dense
    observables are held to pycc_tpu's in test_torch_rt.py)."""
    fc, fl = _port_df(model)
    dc, dl = _port_dense(model)
    y0 = _y0(dc, dl)
    y_d, ret_d = _rt(dc, dl).step(tint.rk4(0.02), torch.from_numpy(y0), 0.0)
    y_f, ret_f = _rt(fc, fl).step(tint.rk4(0.02), torch.from_numpy(y0), 0.0)
    assert (y_d - y_f).abs().max() < 1e-9
    for k in ("ecc", "mu_x", "mu_y", "mu_z"):
        assert abs(ret_d[k] - ret_f[k]) < 1e-9
    if model == "CC3":
        return
    jc, jl = _ref_df(model)
    jrt = pycc_tpu.rtcc(jc, jl, None, jlas.gaussian_laser(*V_ARGS))
    y_j, ret_j = jrt.step(jrk4(0.02), y0, 0.0)
    assert np.abs(np.asarray(y_j) - y_f.numpy()).max() < 1e-12
    for k in ("ecc", "mu_x", "mu_y", "mu_z"):
        assert abs(ret_j[k] - ret_f[k]) < 1e-11


@pytest.mark.parametrize("model", ["CCD", "CC2", "CCSD", "CC3"])
def test_lambda_from_F_over_factors_equals_pycc_tpu(model):
    """lambda_residuals_from_F_df under a field-dressed complex F and
    complex amplitudes (real_time=True: CC3's field terms on) against
    pycc_tpu's; cclambda.residuals over factors (an item-11 raise before)
    is the same function at real_time=False."""
    tc, tl = _port_df(model)
    jc, jl = _ref_df(model)
    no = tc.no
    y = _perturbed(_y0(tc, tl), seed=19)
    t1, t2, l1, l2, _ = (np.ascontiguousarray(x)
                         for x in _rt(tc, tl).extract_amps(y))
    if model == "CCD":
        t1, l1 = 0.0 * t1, 0.0 * l1
    F = np.asarray(jc.H.F) + 0.003 * np.asarray(jc.H.mu[2])
    F = F + 0.002j * np.asarray(jc.H.mu[0])
    ref = jlam.lambda_residuals_from_F_df(
        model, jnp.asarray(F), jc.dfb, *(jnp.asarray(x)
                                         for x in (t1, t2, l1, l2)), no,
        real_time=True, F_ref=jc.H.F)
    args = [torch.from_numpy(x) for x in (F, t1, t2, l1, l2)]
    out = tlam.lambda_residuals_from_F_df(model, args[0], tc.dfb, *args[1:],
                                          no, real_time=True, F_ref=tc.H.F)
    for a, b in zip(ref, out):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12
    plain = tlam.lambda_residuals_from_F_df(model, args[0], tc.dfb,
                                            *args[1:], no)
    for a, b in zip(plain, tl.residuals(*args)):
        assert torch.equal(a, b)


def test_df_ladders_are_one_ladder_call_an_a_block():
    """Under complex amplitudes the DF right-hand side's two ladders (the
    T side's t1-dressed tau ladder, the Lambda side's Hvvvv ladder over
    the complex dressed factors) are each one `ladder` call an a-block, W
    going in as [Re W; Im W]; the result equals the default right-hand
    side's."""
    calls = []

    def ladder(A, B, bf16=False):
        calls.append((tuple(A.shape), tuple(B.shape)))
        return vvvv_nt_reference(A, B, bf16)
    cc, lam = _port_df("CCSD", nblocks=2)
    no, nv = cc.no, cc.nv
    y = _perturbed(_y0(cc, lam), seed=4)
    out = _rt(cc, lam, ladder=ladder).f(0.02, y)
    blk = nv // 2
    assert calls == [((2 * no * no, nv * nv), (2 * blk * nv, nv * nv))] * 4
    assert np.abs(out - _rt(cc, lam).f(0.02, y)).max() < 1e-13
