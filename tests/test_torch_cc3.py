"""The port's CC3 (models/cc3.py and its solvers) against pycc_tpu's on the
CPU in float64: the T1-dressed intermediates, the residuals, L3, the
Lambda-CC3 extras and the one-pdm on the synthetic inputs of
tests/test_009 (1e-12), each k-chunked row against the whole row, and the
tests/test_009 oracles through the port (E(CC3) and the Lambda
pseudo-energy to 1e-11, the CFOUR dipole to 1e-10)."""

import contextlib
import functools
import io
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.cclambda
import pycc_tpu.models.cc3 as jcc3
import pycc_tpu_torch
import pycc_tpu_torch.cclambda
from pycc_tpu.utils import mp2_guess as jmp2
from pycc_tpu.utils import synthetic_hamiltonian as jsynth
from pycc_tpu_torch.ccdensity import build_Moo, build_Mvv
from pycc_tpu_torch.models import cc3 as tcc3
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import integrals as tints
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils.synth import mp2_guess as tmp2
from pycc_tpu_torch.utils.synth import synthetic_hamiltonian as tsynth

from .common import H2O_TEACH

# the packages export the solver classes under the module names
jlam = sys.modules["pycc_tpu.cclambda"]
tlam = sys.modules["pycc_tpu_torch.cclambda"]


def gap(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@functools.lru_cache(maxsize=None)
def _inputs(no, nv, seed):
    """The same synthetic Hamiltonian and amplitudes in both packages:
    t1 = 0.01 + MP2's, and for Lambda l1 = 2 t1, l2 = 2 (2 t2 - t2^T), as
    tests/test_009 makes them."""
    jH = jsynth(no, nv, seed=seed)
    tH = tsynth(no, nv, seed=seed, device="cpu")
    jt1, jt2, _ = jmp2(jH)
    tt1, tt2, _ = tmp2(tH)
    jt1, tt1 = jt1 + 0.01, tt1 + 0.01
    jl = (2.0 * jt1, 2.0 * (2.0 * jt2 - jt2.swapaxes(2, 3)))
    tl = (2.0 * tt1, 2.0 * (2.0 * tt2 - tt2.swapaxes(2, 3)))
    return (jH, jt1, jt2) + jl, (tH, tt1, tt2) + tl


def _cc(H, no, nv):
    return types.SimpleNamespace(no=no, nv=nv, nact=no + nv, H=H,
                                 model="CC3")


def test_cc3_intermediates_match_pycc_tpu():
    (jH, jt1, *_), (tH, tt1, *_) = _inputs(4, 12, 5)
    for a, b in zip(jcc3.cc3_intermediates(jH.ERI, jt1, 4),
                    tcc3.cc3_intermediates(tH.ERI, tt1, 4)):
        assert gap(a, b) < 1e-12


def test_cc3_lambda_intermediates_match_pycc_tpu():
    (jH, jt1, *_), (tH, tt1, *_) = _inputs(4, 12, 5)
    for a, b in zip(jcc3.cc3_lambda_intermediates(jH.ERI, jt1, 4),
                    tcc3.cc3_lambda_intermediates(tH.ERI, tt1, 4)):
        assert gap(a, b) < 1e-12


@pytest.mark.parametrize("real_time", [False, True])
@pytest.mark.parametrize("form", ["residuals_cc3", "residuals_cc3_scan"])
def test_residuals_match_pycc_tpu(form, real_time):
    """Both forms against pycc_tpu's full-tensor residuals, with the
    real-time perturbation of a field-dressed F as test_009 takes it."""
    (jH, jt1, jt2, *_), (tH, tt1, tt2, *_) = _inputs(4, 12, 5)
    shift = 0.01 if real_time else 0.0
    jkw = dict(real_time=True, F_ref=jH.F) if real_time else {}
    tkw = dict(real_time=True, F_ref=tH.F) if real_time else {}
    ref = jcc3.residuals_cc3(jH.F + shift, jH.ERI, jH.L, jt1, jt2, 4, **jkw)
    out = getattr(tcc3, form)(tH.F + shift, tH.ERI, tH.L, tH.vvvv, tt1, tt2,
                              4, **tkw)
    assert gap(ref[0], out[0]) < 1e-12
    assert gap(ref[1], out[1]) < 1e-12


def test_residual_ladder_is_the_plain_product_on_the_cpu():
    (_, *_), (tH, tt1, tt2, *_) = _inputs(4, 12, 5)
    a = tcc3.residuals_cc3_scan(tH.F, tH.ERI, tH.L, tH.vvvv, tt1, tt2, 4)
    b = tcc3.residuals_cc3_scan(tH.F, tH.ERI, tH.L, tH.vvvv, tt1, tt2, 4,
                                ladder=vvvv_nt_reference)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_l3_full_matches_pycc_tpu():
    (jH, jt1, jt2, jl1, jl2), (tH, tt1, tt2, tl1, tl2) = _inputs(4, 10, 9)
    o, v = slice(0, 4), slice(4, None)
    jW = jcc3.cc3_intermediates(jH.ERI, jt1, 4)
    tW = tcc3.cc3_intermediates(tH.ERI, tt1, 4)
    ref = jcc3.l3_full(jH.F, jH.L, jl1, jl2, jH.F[o, v], jW[3], jW[2], 4)
    out = tcc3.l3_full(tH.F, tH.L, tl1, tl2, tH.F[o, v], tW[3], tW[2], 4)
    assert gap(ref, out) < 1e-12


@pytest.mark.parametrize("form", ["cc3_lambda_extra",
                                  "cc3_lambda_extra_scan"])
def test_lambda_extras_match_pycc_tpu(form):
    (jH, *j), (tH, *t) = _inputs(4, 10, 9)
    ref = jcc3.cc3_lambda_extra(jH.F, jH.ERI, jH.L, *j, 4)
    out = getattr(tcc3, form)(tH.F, tH.ERI, tH.L, *t, 4)
    assert gap(ref[0], out[0]) < 1e-12
    assert gap(ref[1], out[1]) < 1e-12


@pytest.mark.parametrize("form,pdm_chunk", [
    ("cc3_onepdm", None), ("cc3_onepdm_scan", None),
    ("cc3_onepdm_scan", 0.0)], ids=["full", "scan", "scan-chunked"])
def test_onepdm_matches_pycc_tpu(form, pdm_chunk, monkeypatch):
    """pdm_chunk=0 forces the k-chunked assembly of each pair's slabs."""
    (jH, *j), (tH, *t) = _inputs(4, 10, 9)
    if pdm_chunk is not None:
        monkeypatch.setattr(tcc3, "_PDM_CHUNK_ELEMS", pdm_chunk)
    ref = jcc3.cc3_onepdm(_cc(jH, 4, 10), *j)
    out = getattr(tcc3, form)(_cc(tH, 4, 10), *t)
    assert gap(ref[0], out[0]) < 1e-12
    assert gap(ref[1], out[1]) < 1e-12


def test_lambda_residuals_from_F_match_pycc_tpu():
    (jH, *j), (tH, *t) = _inputs(4, 10, 9)
    ref = jlam.lambda_residuals_from_F(
        "CC3", jH.F, jH.ERI, jH.L, *j, 4)
    out = tlam.lambda_residuals_from_F(
        "CC3", tH.F, tH.ERI, tH.L, *t, 4)
    assert gap(ref[0], out[0]) < 1e-12
    assert gap(ref[1], out[1]) < 1e-12


@pytest.mark.parametrize("pair", ["slab", "chunk"])
def test_pair_slabs_match_pycc_tpu(pair):
    """The T3 and L3 (i, j) pair slabs (whole, or the k-window [2, 4)),
    the real-time term included."""
    (jH, jt1, jt2, jl1, jl2), (tH, tt1, tt2, tl1, tl2) = _inputs(4, 10, 9)
    jp = jcc3.cc3_lambda_prep(jH.F, jH.ERI, jH.L, jt1, jt2, 4)
    tp = tcc3.cc3_lambda_prep(tH.F, tH.ERI, tH.L, tt1, tt2, 4)
    jV, tV = 0.01 * jnp.ones((4, 10)), 0.01 * torch.ones((4, 10),
                                                          dtype=torch.float64)
    for i, j in ((0, 3), (2, 2)):
        if pair == "slab":
            ref_t = jcc3._cc3_t3_slab_pair(i, j, jV, jp[4], jp[5], jt2,
                                           jp[9][:4], jp[9][4:], True)
            out_t = tcc3._cc3_t3_slab_pair(i, j, tV, tp[4], tp[5], tt2,
                                           tp[9][:4], tp[9][4:], True)
            ref_l = jcc3._l3_slab_ij(i, j, jp[10], jl1, jl2, jp[0], jp[3],
                                     jp[2], jp[9][:4], jp[9][4:])
            out_l = tcc3._l3_slab_ij(i, j, tp[10], tl1, tl2, tp[0], tp[3],
                                     tp[2], tp[9][:4], tp[9][4:])
        else:
            ref_t = jcc3._t3c_pair_chunk(i, j, 2, 2, jV, jp[4], jp[5], jt2,
                                         jp[9][:4], jp[9][4:], True)
            out_t = tcc3._t3c_pair_chunk(i, j, 2, 2, tV, tp[4], tp[5], tt2,
                                         tp[9][:4], tp[9][4:], True)
            ref_l = jcc3._l3_slab_ij_chunk(i, j, 2, 2, jp[10], jl1, jl2,
                                           jp[0], jp[3], jp[2], jp[9][:4],
                                           jp[9][4:])
            out_l = tcc3._l3_slab_ij_chunk(i, j, 2, 2, tp[10], tl1, tl2,
                                           tp[0], tp[3], tp[2], tp[9][:4],
                                           tp[9][4:])
        assert gap(ref_t, out_t) < 1e-12
        assert gap(ref_l, out_l) < 1e-12


@pytest.mark.parametrize("real_time", [False, True])
def test_row_slabs_match_pycc_tpu_and_stack_the_pair_slabs(real_time):
    """The whole-row T3 and L3 slabs (j,k,a,b,c) against pycc_tpu's, and
    each equal to the stack of its row's (i, j) pair slabs."""
    (jH, jt1, jt2, jl1, jl2), (tH, tt1, tt2, tl1, tl2) = _inputs(4, 10, 9)
    jp = jcc3.cc3_lambda_prep(jH.F, jH.ERI, jH.L, jt1, jt2, 4)
    tp = tcc3.cc3_lambda_prep(tH.F, tH.ERI, tH.L, tt1, tt2, 4)
    jF, tF = jH.F + 0.01, tH.F + 0.01
    tV = (tF - tH.F)[:4, 4:]
    eo, ev = tp[9][:4], tp[9][4:]
    for i in (0, 3):
        ref_t = jcc3._cc3_t3_slab(i, jF, jp[4], jp[5], jt2, jp[9][:4],
                                  jp[9][4:], real_time, jH.F, 4)
        out_t = tcc3._cc3_t3_slab(i, tF, tp[4], tp[5], tt2, eo, ev,
                                  real_time, tH.F, 4)
        ref_l = jcc3.l3_slab(i, jp[10], jl1, jl2, jp[0], jp[3], jp[2],
                             jp[9][:4], jp[9][4:])
        out_l = tcc3.l3_slab(i, tp[10], tl1, tl2, tp[0], tp[3], tp[2], eo,
                             ev)
        assert gap(ref_t, out_t) < 1e-12
        assert gap(ref_l, out_l) < 1e-12
        pairs_t = torch.stack([tcc3._cc3_t3_slab_pair(
            i, j, tV, tp[4], tp[5], tt2, eo, ev, real_time) for j in range(4)])
        pairs_l = torch.stack([tcc3._l3_slab_ij(
            i, j, tp[10], tl1, tl2, tp[0], tp[3], tp[2], eo, ev)
            for j in range(4)])
        assert (pairs_t - out_t).abs().max().item() < 1e-12
        assert (pairs_l - out_l).abs().max().item() < 1e-12


def _zeros(*shapes):
    return tuple(torch.zeros(s, dtype=torch.float64) for s in shapes)


@pytest.mark.parametrize("real_time", [False, True])
def test_residual_row_chunked_equals_whole_row(real_time):
    """`_cc3_row_xs_chunked` with kc=2 accumulates what `_cc3_row_xs`
    does, and both what pycc_tpu's row does, the real-time term
    included."""
    (jH, jt1, jt2, *_), (tH, tt1, tt2, *_) = _inputs(4, 10, 9)
    jp = jcc3.cc3_scan_prep(jH.F, jH.ERI, jH.L, jt1, jt2, 4)
    tp = tcc3.cc3_scan_prep(tH.F, tH.ERI, tH.L, tH.vvvv, tt1, tt2, 4)
    # (Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, Vov) after (r1, r2)
    jV, tV = jp[9] + 0.01, tp[9] + 0.01
    jargs = (jp[5], jp[6], jt2, jp[7], jp[8], jp[2], jp[3], jp[4], jV)
    targs = (tp[5], tp[6], tt2, tp[7], tp[8], tp[2], tp[3], tp[4], tV)
    ref = (jnp.zeros((4, 10)), jnp.zeros((4, 4, 10, 10)))
    whole = _zeros((4, 10), (4, 4, 10, 10))
    chunked = _zeros((4, 10), (4, 4, 10, 10))
    for i in range(4):
        ref = jcc3._cc3_row_xs(jnp.asarray(i), ref, *jargs, no=4,
                               real_time=real_time)
        tcc3._cc3_row_xs(i, whole, *targs, 4, real_time)
        tcc3._cc3_row_xs_chunked(i, chunked, *targs, 4, real_time, 2)
    for r, a, b in zip(ref, whole, chunked):
        assert gap(r, a) < 1e-12
        assert (a - b).abs().max().item() < 1e-12


@pytest.mark.parametrize("real_time", [False, True])
def test_lambda_t3_row_chunked_equals_whole_row(real_time):
    (jH, jt1, jt2, _, jl2), (tH, tt1, tt2, _, tl2) = _inputs(4, 10, 9)
    jp = jcc3.cc3_lambda_prep(jH.F, jH.ERI, jH.L, jt1, jt2, 4)
    tp = tcc3.cc3_lambda_prep(tH.F, tH.ERI, tH.L, tt1, tt2, 4)
    jV, tV = jp[12] + 0.01, tp[12] + 0.01
    shapes = ((4, 4, 10, 4), (4, 10, 10, 10), (4, 10))
    ref = tuple(jnp.zeros(s) for s in shapes)
    whole, chunked = _zeros(*shapes), _zeros(*shapes)
    for l in range(4):
        ref = jcc3._cc3_lambda_row_t3(jnp.asarray(l), ref, jp[4], jp[5], jt2,
                                      jl2, jp[9], jp[10], jp[11], jV, no=4,
                                      real_time=real_time)
        args = (tp[4], tp[5], tt2, tl2, tp[9], tp[10], tp[11], tV, 4,
                real_time)
        tcc3._cc3_lambda_row_t3(l, whole, *args)
        tcc3._cc3_lambda_row_t3_chunked(l, chunked, *args, 2)
    for r, a, b in zip(ref, whole, chunked):
        assert gap(r, a) < 1e-12
        assert (a - b).abs().max().item() < 1e-12


def test_lambda_l3_row_chunked_equals_whole_row():
    (jH, jt1, jt2, jl1, jl2), (tH, tt1, tt2, tl1, tl2) = _inputs(4, 10, 9)
    jp = jcc3.cc3_lambda_prep(jH.F, jH.ERI, jH.L, jt1, jt2, 4)
    tp = tcc3.cc3_lambda_prep(tH.F, tH.ERI, tH.L, tt1, tt2, 4)
    shapes = ((10, 4, 10, 10),) * 3 + ((4, 4, 4, 10),) * 3 + ((4, 4, 10, 10),)
    ref = tuple(jnp.zeros(s) for s in shapes)
    whole, chunked = _zeros(*shapes), _zeros(*shapes)
    for k in range(4):
        ref = jcc3._cc3_lambda_row_l3(jnp.asarray(k), ref, jt2, jl1, jl2,
                                      jp[0], jp[3], jp[2], jp[4], jp[5],
                                      jp[9], jp[10], no=4)
        args = (tt2, tl1, tl2, tp[0], tp[3], tp[2], tp[4], tp[5], tp[9],
                tp[10], 4)
        tcc3._cc3_lambda_row_l3(k, whole, *args)
        tcc3._cc3_lambda_row_l3_chunked(k, chunked, *args, 2)
    for r, a, b in zip(ref, whole, chunked):
        assert gap(r, a) < 1e-12
        assert (a - b).abs().max().item() < 1e-12


# ---------------------------------------------------------------------------
# tests/test_009 through the port: H2O_Teach/cc-pVDZ, all electrons
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(H2O_TEACH, "cc-pvdz", freeze_core=False)


def cc3_dipole(cc, lam):
    """mu . opdm + M(t1) . opdm_cc3 from the CC3 one-pdm, with the
    T1-transformed dipole blocks, as pycc_tpu's rtcc.dipole forms it."""
    dens = pycc_tpu_torch.ccdensity(cc, lam, onlyone=True)
    opdm, opdm_cc3 = dens.compute_onepdm(cc.t1, cc.t2, lam.l1, lam.l2)
    no, nv = cc.no, cc.nv
    out = []
    for mu in cc.H.mu:
        M = torch.zeros_like(mu)
        M[:no, :no] = build_Moo(no, nv, mu, cc.t1)
        M[no:, no:] = build_Mvv(no, nv, mu, cc.t1)
        out.append(float((mu * opdm).sum() + (M * opdm_cc3).sum()))
    return np.array(out)


def scf_dipole(wfn):
    mu_ao = tints.dipole(wfn.basisset())
    C, nd = wfn.Ca(), wfn.ndocc
    return np.array([wfn.molecule().nuclear_dipole()[ax]
                     + 2 * np.trace(C[:, :nd].T @ mu_ao[ax] @ C[:, :nd])
                     for ax in range(3)])


@functools.lru_cache(maxsize=None)
def _pipeline(t3_scan):
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu_torch.ccwfn(_wfn(), model="CC3", t3_scan=t3_scan,
                                  device="cpu")
        ecc = cc.solve_cc(1e-12, 1e-12)
        lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
        lecc = lam.solve_lambda(1e-12, 1e-12)
        mu = cc3_dipole(cc, lam)
    return cc, lam, ecc, lecc, mu


def test_cc3_energy_oracle():
    cc, _, ecc, _, _ = _pipeline(None)
    assert cc.converged
    assert abs(ecc - -0.227888246840310) < 1e-11      # Psi4
    assert abs(ecc - -0.2278882468404231) < 1e-11     # CFOUR


def test_cc3_lambda_oracle():
    _, lam, _, lecc, _ = _pipeline(None)
    assert lam.converged
    assert abs(lecc - -0.2233231845185215) < 1e-11    # CFOUR


def test_cc3_dipole_oracle():
    ref = np.array([0, 0, 0.7703875967]) - scf_dipole(_wfn())   # CFOUR
    mu = _pipeline(None)[4]
    assert abs(ref[1] - mu[1]) < 1e-10
    assert abs(ref[2] - mu[2]) < 1e-10


def test_t3_scan_equals_the_full_tensor_forms():
    """t3_scan=True (the slab forms of the residual, the Lambda extras and
    the one-pdm) against t3_scan=False through the whole pipeline."""
    _, lam_s, e_s, l_s, mu_s = _pipeline(True)
    _, lam_f, e_f, l_f, mu_f = _pipeline(False)
    assert abs(e_s - e_f) < 1e-12 and abs(l_s - l_f) < 1e-12
    assert np.abs(mu_s - mu_f).max() < 1e-12
    assert (lam_s.l2 - lam_f.l2).abs().max().item() < 1e-12
