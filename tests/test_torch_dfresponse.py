"""The port's linear response over Cholesky/DF factors
(models/dfresponse.py, ccresponse on a storage='df' ccwfn) against
pycc_tpu's on the CPU in float64, on tests/test_020's inputs: H2O/STO-3G
factors at tol 1e-14, random t1/t2 (t2 not pair-symmetrised) and a random
perturbation, real and complex.  Each residual agrees with pycc_tpu and
with the port's dense residual on the factor-rebuilt ERI to 1e-11; the
end-to-end storage='df' polarizability equals full storage's (1e-8), and
so does a complex (M_X) right and left solve."""

import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.ccresponse
import pycc_tpu_torch
import pycc_tpu_torch.ccresponse
from pycc_tpu_torch.cchbar import build_hbar
from pycc_tpu.models import dfhbar as jq
from pycc_tpu.models import dfresponse as jdr
from pycc_tpu.models.dfccsd import _eri_oovv as j_eri_oovv
from pycc_tpu_torch.models import dfhbar as tq
from pycc_tpu_torch.models import dfresponse as tdr
from pycc_tpu_torch.models.dfccsd import _eri_oovv as t_eri_oovv
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference

from .test_torch_dfhbar import _quiet, _solved, gap, rand, setup

# the packages export the solver classes under the module names
jcr = sys.modules["pycc_tpu.ccresponse"]
tcr = sys.modules["pycc_tpu_torch.ccresponse"]
OMEGA = 0.0656
KINDS = ["real", "complex"]


class _JCC:
    """What pycc_tpu's pertbar reads of a ccwfn."""

    def __init__(self, no, nact, t1, t2, storage):
        self.o, self.v = slice(0, no), slice(no, nact)
        self.t1, self.t2, self.storage = t1, t2, storage


@functools.lru_cache(maxsize=None)
def inputs(kind):
    """test_020's inputs (seed 7) in both packages: the DF-HBARs, the
    factor-assembled L and <oo|vv>, the pertbar blocks of a random
    symmetric perturbation (complex: plus i times a random antisymmetric
    one), and the port's dense HBAR, its aux and pertbar on the
    factor-rebuilt ERI."""
    no, nv, (jF, jdf, jt1, jt2), (tF, tdf, tt1, tt2), (ERI, L) = setup(7)
    nact = no + nv
    p = rand(nact, nact, seed=21)
    pert = p + p.T
    if kind == "complex":
        q = rand(nact, nact, seed=22)
        pert = pert + 1j * (q - q.T)
    jh = jax.jit(jq.build_hbar_df, static_argnums=(4,))(jF, jdf, jt1, jt2,
                                                        no)
    th = tq.build_hbar_df(tF, tdf, tt1, tt2, no)
    jA = vars(jcr.pertbar(jnp.asarray(pert), _JCC(no, nact, jt1, jt2, "df")))
    tcc = types.SimpleNamespace(o=slice(0, no), v=slice(no, nact), t1=tt1,
                                t2=tt2, storage="df")
    tA = tcr.pertbar(torch.tensor(pert), tcc)
    dense_hb = build_hbar("CCSD", tF, ERI, L, tt1, tt2, no)
    dA = tcr.pertbar(torch.tensor(pert), types.SimpleNamespace(
        o=tcc.o, v=tcc.v, t1=tt1, t2=tt2, storage="full"))
    return dict(no=no, nv=nv, jh=jh, th=th, jA=jA, tA=tA, dA=dA,
                jL=jq.loovv_df(jdf), tL=tq.loovv_df(tdf),
                jE=j_eri_oovv(jdf), tE=t_eri_oovv(tdf), jt=(jt1, jt2),
                tt=(tt1, tt2), dense=(dense_hb, tcr.build_response_aux(
                    dense_hb), L, ERI))


def _amplitudes(kind, no, nv, seed):
    a1, a2 = rand(no, nv, seed=seed), rand(no, no, nv, nv, seed=seed + 1)
    if kind == "complex":
        a1 = a1 + 1j * rand(no, nv, seed=seed + 2)
        a2 = a2 + 1j * rand(no, no, nv, nv, seed=seed + 3)
    return a1, a2


def _tdict(A):
    return {k: getattr(A, k) for k in ("Aov", "Aoo", "Avv", "Avo", "Aovoo",
                                       "Avvoo")}


@pytest.mark.parametrize("kind", KINDS)
def test_pertbar_over_factors_matches_pycc_tpu(kind):
    s = inputs(kind)
    assert "Avvvo" not in s["jA"] and not hasattr(s["tA"], "Avvvo")
    for k, v in _tdict(s["tA"]).items():
        assert gap(s["jA"][k], v) < 1e-12, k
        assert (getattr(s["dA"], k) - v).abs().max() < 1e-12, k


@pytest.mark.parametrize("kind", KINDS)
def test_rX_df_matches_pycc_tpu_and_dense(kind):
    s = inputs(kind)
    no, nv = s["no"], s["nv"]
    X1, X2 = _amplitudes(kind, no, nv, 30)
    ref = jax.jit(jdr.rX_df, static_argnums=(8,))(
        s["jh"], s["jL"], *s["jt"], s["jA"], OMEGA, jnp.asarray(X1),
        jnp.asarray(X2), no)
    calls = []

    def ladder(A, B):
        calls.append(A.shape)
        return vvvv_nt_reference(A, B)
    out = tdr.rX_df(s["th"], s["tL"], *s["tt"], _tdict(s["tA"]), OMEGA,
                    torch.tensor(X1), torch.tensor(X2), no, ladder=ladder)
    hb, aux, L, _ = s["dense"]
    full = tcr.r_X(hb, L, s["tt"][1], vars(s["dA"]), OMEGA, torch.tensor(X1),
                   torch.tensor(X2), no, aux)
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < 1e-11
        assert (b - c).abs().max() < 1e-11
    # one ladder call an a-block; a complex X2 as stacked real/imag rows
    assert calls == [((2 if kind == "complex" else 1) * no * no, nv * nv)]


@pytest.mark.parametrize("kind", KINDS)
def test_inY_df_matches_pycc_tpu_and_dense(kind):
    s = inputs(kind)
    no, nv = s["no"], s["nv"]
    X1, X2 = _amplitudes(kind, no, nv, 40)
    l1, l2 = rand(no, nv, seed=50), rand(no, no, nv, nv, seed=51)
    jargs = (s["jh"], s["jL"], s["jE"], *s["jt"], jnp.asarray(l1),
             jnp.asarray(l2), s["jA"])
    targs = (s["th"], s["tL"], s["tE"], *s["tt"], torch.tensor(l1),
             torch.tensor(l2), _tdict(s["tA"]))
    j1 = jax.jit(jdr.inY1_df, static_argnums=(11,))(
        *jargs, s["jA"]["pert_ov"], jnp.asarray(X1), jnp.asarray(X2), no)
    j2 = jax.jit(jdr.inY2_df, static_argnums=(10,))(
        *jargs, jnp.asarray(X1), jnp.asarray(X2), no)
    t1_ = tdr.inY1_df(*targs, s["tA"].Aov, torch.tensor(X1),
                      torch.tensor(X2), no)
    t2_ = tdr.inY2_df(*targs, torch.tensor(X1), torch.tensor(X2), no)
    assert gap(j1, t1_) < 1e-11 and gap(j2, t2_) < 1e-11
    hb, aux, L, ERI = s["dense"]
    Ad = vars(s["dA"])
    d1 = tcr.in_Y1(hb, L, s["tt"][1], torch.tensor(l1), torch.tensor(l2), Ad,
                   torch.tensor(X1), torch.tensor(X2), no, aux)
    d2 = tcr.in_Y2(hb, L, ERI, s["tt"][1], torch.tensor(l1),
                   torch.tensor(l2), Ad, torch.tensor(X1), torch.tensor(X2),
                   no, aux)
    assert (t1_ - d1).abs().max() < 1e-11 and (t2_ - d2).abs().max() < 1e-11
    # the g-blocked v^4 term: blocks of one g == one block
    assert (tdr._gaef_hvovv(s["th"], torch.tensor(l2), torch.tensor(X2), 1)
            - tdr._gaef_hvovv(s["th"], torch.tensor(l2), torch.tensor(X2),
                              nv)).abs().max() < 1e-13


@pytest.mark.parametrize("kind", KINDS)
def test_rY_df_matches_pycc_tpu_and_dense(kind):
    s = inputs(kind)
    no, nv = s["no"], s["nv"]
    Y1, Y2 = _amplitudes(kind, no, nv, 60)
    i1, i2 = _amplitudes(kind, no, nv, 70)
    ref = jax.jit(jdr.rY_df, static_argnums=(9,))(
        s["jh"], s["jL"], *s["jt"], jnp.asarray(i1), jnp.asarray(i2), OMEGA,
        jnp.asarray(Y1), jnp.asarray(Y2), no)
    out = tdr.rY_df(s["th"], s["tL"], *s["tt"], torch.tensor(i1),
                    torch.tensor(i2), OMEGA, torch.tensor(Y1),
                    torch.tensor(Y2), no)
    hb, aux, L, _ = s["dense"]
    full = tcr.r_Y(hb, L, s["tt"][1], torch.tensor(i1), torch.tensor(i2),
                   OMEGA, torch.tensor(Y1), torch.tensor(Y2), no, aux)
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < 1e-11
        assert (b - c).abs().max() < 1e-11


@functools.lru_cache(maxsize=None)
def _response(storage):
    cc, hb = _solved(storage)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12)
    return pycc_tpu_torch.ccresponse(
        pycc_tpu_torch.ccdensity(cc, lam, onlyone=True))


def test_df_polarizability_equals_full_storage():
    """test_020 end to end through the port: the storage='df' MU-MU
    polarizability tensor equals storage='full''s."""
    out = {s: _quiet(_response(s).linresp, "MU", "MU", OMEGA)
           for s in ("df", "full")}
    assert np.abs(out["df"] - out["full"]).max() < 1e-8
    resp = _response("df")
    assert resp._aux is None and not hasattr(resp.pertbar["MU_X"], "Avvvo")
    assert abs(resp.estimate_conditioning(OMEGA)
               - _response("full").estimate_conditioning(OMEGA)) < 1e-8


def test_df_complex_solves_equal_full_storage():
    """A complex perturbation (M_X) over factors: its right and left
    solves and the pseudoresponses equal full storage's, with every
    returned vector's residual recomputed."""
    out = {}
    for storage in ("df", "full"):
        resp = _response(storage)
        A = resp.pertbar["M_X"]
        X1, X2, px = _quiet(resp.solve_right, A, OMEGA)
        Y1, Y2, py = _quiet(resp.solve_left, A, OMEGA)
        assert X1.is_complex() and Y2.is_complex()
        r1, r2 = resp._r_X(resp._Adict(A), OMEGA, X1, X2)
        i1, i2 = resp._in_Y(A, X1, X2)
        s1, s2 = resp._r_Y(i1, i2, OMEGA, Y1, Y2)
        assert max(r1.abs().max(), r2.abs().max(), s1.abs().max(),
                   s2.abs().max()) < 1e-9
        out[storage] = (px, py, X2, Y2)
    df, full = out["df"], out["full"]
    assert abs(df[0] - full[0]) < 1e-8 and abs(df[1] - full[1]) < 1e-8
    assert (df[2] - full[2]).abs().max() < 1e-8
    assert (df[3] - full[3]).abs().max() < 1e-8
