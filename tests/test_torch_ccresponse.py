"""The port's linear response against pycc_tpu's: pertbar, the residuals,
the pseudoresponse, linresp_asym, the solvers and the conditioning probe
on the synthetic inputs of test_torch_cchbar with seeded perturbations,
real (MU-like, symmetric) and complex (M-like, i times antisymmetric), at
1e-12 (f64, only the summation order differs; the solvers at 1e-10); and
the tests/test_007 and test_013 oracles through the port on the CPU."""

import contextlib
import dataclasses
import functools
import io
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.ccresponse
import pycc_tpu_torch
import pycc_tpu_torch.ccresponse
from pycc_tpu_torch.models.ccsd import vvvv_contract, vvvv_contract_efab
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt, vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils.timing import Timers

from .common import H2O
from .test_torch_cchbar import NO, NV, gap, hbars, synthetic_inputs

# the packages export the driver classes under the module names
jresp = sys.modules["pycc_tpu.ccresponse"]
tresp = sys.modules["pycc_tpu_torch.ccresponse"]

MODELS = ["CCSD", "CC2"]
KINDS = ["real", "complex"]
# one pertbar key of each kind
KEY = {"real": "MU_Y", "complex": "M_Z"}
OMEGA = 0.077


@functools.lru_cache(maxsize=None)
def _operators():
    """Seeded mu (3 real symmetric), m and p (3 each, i times
    antisymmetric) and Q (6 real symmetric) over the active space."""
    rng = np.random.default_rng(23)
    n = NO + NV

    def sym():
        x = rng.standard_normal((n, n))
        return 0.1 * (x + x.T)

    def isym():
        x = rng.standard_normal((n, n))
        return 0.1j * (x - x.T)

    return (tuple(sym() for _ in range(3)), tuple(isym() for _ in range(3)),
            tuple(isym() for _ in range(3)), tuple(sym() for _ in range(6)))


def _amplitudes(kind, seed, scale=0.02):
    """Seeded (o, v) and pair-symmetric (o, o, v, v) vectors."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal(shape)
        if kind == "complex":
            x = x + 1j * rng.standard_normal(shape)
        return scale * x

    v1 = draw((NO, NV))
    v2 = draw((NO, NO, NV, NV))
    return v1, v2 + v2.transpose(1, 0, 3, 2)


@functools.lru_cache(maxsize=None)
def _responses(model):
    """(pycc_tpu's ccresponse, the port's) on the synthetic inputs."""
    jH, tH, t1, t2, l1, l2 = synthetic_inputs()
    jhb, thb = hbars(model)
    mu, m, p, Q = _operators()
    jH = dataclasses.replace(
        jH, mu=tuple(jnp.asarray(x) for x in mu),
        m=tuple(jnp.asarray(x) for x in m), p=tuple(jnp.asarray(x) for x in p),
        Q=tuple(jnp.asarray(x) for x in Q))
    tH = dataclasses.replace(
        tH, mu=tuple(torch.from_numpy(x) for x in mu),
        m=tuple(torch.from_numpy(x) for x in m),
        p=tuple(torch.from_numpy(x) for x in p),
        Q=tuple(torch.from_numpy(x) for x in Q))

    def wfn(H, t1, t2, **kw):
        return types.SimpleNamespace(
            H=H, t1=t1, t2=t2, no=NO, nv=NV, nact=NO + NV, model=model,
            o=slice(0, NO), v=slice(NO, NO + NV), storage="full", **kw)

    jcc = wfn(jH, jnp.asarray(t1), jnp.asarray(t2))
    tcc = wfn(tH, torch.from_numpy(t1), torch.from_numpy(t2), timers=Timers())
    jlam = types.SimpleNamespace(hbar=jhb, l1=jnp.asarray(l1),
                                 l2=jnp.asarray(l2))
    tlam = types.SimpleNamespace(hbar=thb, l1=torch.from_numpy(l1),
                                 l2=torch.from_numpy(l2))
    with contextlib.redirect_stdout(io.StringIO()):
        j = jresp.ccresponse(types.SimpleNamespace(ccwfn=jcc, cclambda=jlam))
        t = tresp.ccresponse(types.SimpleNamespace(ccwfn=tcc, cclambda=tlam))
    return j, t


def _pair(kind, seed):
    v1, v2 = _amplitudes(kind, seed)
    return ((jnp.asarray(v1), jnp.asarray(v2)),
            (torch.from_numpy(v1), torch.from_numpy(v2)))


def _gap_c(a, b):
    """max |a - b| over complex or real host/torch values."""
    return float(np.max(np.abs(np.asarray(a) - b.cpu().numpy())))


BLOCKS = ("Aov", "Aoo", "Avv", "Avo", "Aovoo", "Avvvo", "Avvoo")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_pertbar_blocks_match_pycc_tpu(model, kind):
    j, t = _responses(model)
    # 24 keys, 21 pertbars: Q_YX, Q_ZX and Q_ZY are Q_XY, Q_XZ and Q_YZ
    assert set(t.pertbar) == set(j.pertbar) and len(t.pertbar) == 24
    assert len({id(A) for A in t.pertbar.values()}) == 21
    jA, tA = j.pertbar[KEY[kind]], t.pertbar[KEY[kind]]
    for name in BLOCKS:
        a, b = getattr(jA, name), getattr(tA, name)
        assert b.is_complex() == (kind == "complex"), name
        assert _gap_c(a, b) < 1e-12, name


def test_pertbar_leaves_the_operators_unchanged():
    _, t = _responses("CCSD")
    mu, m, p, Q = _operators()
    for ours, theirs in ((t.H.mu, mu), (t.H.m, m), (t.H.p, p), (t.H.Q, Q)):
        for a, b in zip(ours, theirs):
            assert np.array_equal(a.numpy(), b)
    # and a pertbar made anew leaves its operator as it was
    pert = t.H.m[0].clone()
    tresp.pertbar(pert, t.ccwfn)
    assert torch.equal(pert, t.H.m[0])


def test_a_hamiltonian_without_operators_makes_no_pertbars():
    """The Hamiltonian's empty value for an operator is (), not None."""
    _, tH, t1, t2, l1, l2 = synthetic_inputs()
    _, thb = hbars("CCSD")
    assert tH.mu == tH.m == tH.p == tH.Q == ()
    cc = types.SimpleNamespace(H=tH, t1=torch.from_numpy(t1),
                               t2=torch.from_numpy(t2), no=NO, nv=NV,
                               o=slice(0, NO), v=slice(NO, NO + NV))
    lam = types.SimpleNamespace(hbar=thb, l1=torch.from_numpy(l1),
                                l2=torch.from_numpy(l2))
    resp = tresp.ccresponse(types.SimpleNamespace(ccwfn=cc, cclambda=lam))
    assert resp.pertbar == {}
    assert resp.estimate_conditioning(OMEGA) > 0


@pytest.mark.parametrize("model", MODELS)
def test_response_aux_and_denominators_match_pycc_tpu(model):
    j, t = _responses(model)
    for name in ("Hvovv_s", "Hooov_s", "Hovvo_s"):
        assert gap(j._aux[name], t._aux[name]) < 1e-12, name
    assert gap(j.Dia, t.Dia) < 1e-12 and gap(j.Dijab, t.Dijab) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_r_X_matches_pycc_tpu(model, kind):
    j, t = _responses(model)
    (jX1, jX2), (tX1, tX2) = _pair(kind, 31)
    jr = jresp.r_X(j.hbar, j.ccwfn.H.L, j.ccwfn.t2, j._Adict(j.pertbar[KEY[kind]]),
                   OMEGA, jX1, jX2, NO, j._aux)
    tr = tresp.r_X(t._hb(), t.ccwfn.H.L, t.ccwfn.t2,
                   t._Adict(t.pertbar[KEY[kind]]), OMEGA, tX1, tX2, NO,
                   t._aux)
    assert tr[1].is_complex() == (kind == "complex")
    assert _gap_c(jr[0], tr[0]) < 1e-12
    assert _gap_c(jr[1], tr[1]) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_in_Y1_and_in_Y2_match_pycc_tpu(model, kind):
    j, t = _responses(model)
    (jX1, jX2), (tX1, tX2) = _pair(kind, 37)
    jc, tc = j.ccwfn, t.ccwfn
    jA, tA = j._Adict(j.pertbar[KEY[kind]]), t._Adict(t.pertbar[KEY[kind]])
    jl, tl = j.cclambda, t.cclambda
    j1 = jresp.in_Y1(j.hbar, jc.H.L, jc.t2, jl.l1, jl.l2, jA, jX1, jX2, NO,
                     j._aux)
    t1_ = tresp.in_Y1(t._hb(), tc.H.L, tc.t2, tl.l1, tl.l2, tA, tX1, tX2, NO,
                      t._aux)
    j2 = jresp.in_Y2(j.hbar, jc.H.L, jc.H.ERI, jc.t2, jl.l1, jl.l2, jA, jX1,
                     jX2, NO, j._aux)
    t2_ = tresp.in_Y2(t._hb(), tc.H.L, tc.H.ERI, tc.t2, tl.l1, tl.l2, tA, tX1,
                      tX2, NO, t._aux)
    assert _gap_c(j1, t1_) < 1e-12
    assert _gap_c(j2, t2_) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_r_Y_matches_pycc_tpu(model, kind):
    j, t = _responses(model)
    (jY1, jY2), (tY1, tY2) = _pair(kind, 41)
    (jI1, jI2), (tI1, tI2) = _pair(kind, 43)
    jr = jresp.r_Y(j.hbar, j.ccwfn.H.L, j.ccwfn.t2, jI1, jI2, OMEGA, jY1, jY2,
                   NO, j._aux)
    tr = tresp.r_Y(t._hb(), t.ccwfn.H.L, t.ccwfn.t2, tI1, tI2, OMEGA, tY1,
                   tY2, NO, t._aux)
    assert _gap_c(jr[0], tr[0]) < 1e-12
    assert _gap_c(jr[1], tr[1]) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_pseudoresponse_and_linresp_asym_match_pycc_tpu(kind):
    j, t = _responses("CCSD")
    (jX1, jX2), (tX1, tX2) = _pair(kind, 47)
    (jY1, jY2), (tY1, tY2) = _pair(kind, 53)
    key = KEY[kind]
    jp = complex(j.pseudoresponse(j.pertbar[key], jX1, jX2))
    tp = complex(t.pseudoresponse(t.pertbar[key], tX1, tX2))
    assert abs(jp - tp) < 1e-12
    for a in (key, "MU_X", "P*_Y", "Q_XZ"):
        jl = complex(j.linresp_asym(a, jX1, jX2, jY1, jY2))
        tl = complex(t.linresp_asym(a, tX1, tX2, tY1, tY2))
        assert abs(jl - tl) < 1e-12, a


def test_pseudoresponse_takes_the_conjugate():
    _, t = _responses("CCSD")
    A = t.pertbar["M_X"]
    _, (X1, X2) = _pair("complex", 59)
    ref = -4.0 * ((A.Avo.conj().T * X1).sum()
                  + (A.Avvoo.conj() * (2.0 * X2 - X2.swapaxes(2, 3))).sum())
    assert abs(complex(t.pseudoresponse(A, X1, X2)) - complex(ref)) < 1e-14
    assert abs(complex(ref)) > 1e-3


# (the synthetic CCSD HBAR is too far from diagonal for the Jacobi + DIIS
# iteration to converge; the CC2 one converges in ~80 iterations)
@pytest.mark.parametrize("kind", KINDS)
def test_solvers_and_linresp_match_pycc_tpu(kind):
    j, t = _responses("CC2")
    key = KEY[kind]
    kw = dict(e_conv=1e-12, r_conv=1e-12, cond_check=False)
    with contextlib.redirect_stdout(io.StringIO()):
        jX1, jX2, jpx = j.solve_right(j.pertbar[key], OMEGA, **kw)
        jY1, jY2, jpy = j.solve_left(j.pertbar[key], OMEGA, **kw)
    tX1, tX2, tpx = t.solve_right(t.pertbar[key], OMEGA, **kw)
    assert t.converged and t.ccwfn.timers.count["response.right_iteration"]
    tY1, tY2, tpy = t.solve_left(t.pertbar[key], OMEGA, **kw)
    assert t.converged and isinstance(tpy, complex)
    assert tX2.dtype == (torch.complex128 if kind == "complex"
                         else torch.float64)
    assert abs(jpx - tpx) < 1e-10 and abs(jpy - tpy) < 1e-10
    for a, b in ((jX1, tX1), (jX2, tX2), (jY1, tY1), (jY2, tY2)):
        assert _gap_c(a, b) < 1e-10
    jl = complex(j.linresp_asym("MU_X", jX1, jX2, jY1, jY2))
    tl = complex(t.linresp_asym("MU_X", tX1, tX2, tY1, tY2))
    assert abs(jl - tl) < 1e-10


def test_warm_start_keeps_the_complex_dtype():
    _, t = _responses("CC2")
    A = t.pertbar["M_X"]
    X1, X2, p0 = t.solve_right(A, OMEGA, 1e-11, 1e-11, cond_check=False)
    X1w, X2w, p1 = t.solve_right(A, OMEGA, 1e-11, 1e-11, X1_init=X1,
                                 X2_init=X2, cond_check=False)
    assert X2w.dtype == torch.complex128 and t.niter <= 2
    assert abs(p0 - p1) < 1e-10


@pytest.mark.parametrize("omega", [OMEGA, 0.5])
def test_conditioning_probe_matches_pycc_tpu(omega):
    j, t = _responses("CCSD")
    sj = j.estimate_conditioning(omega)
    st = t.estimate_conditioning(omega)
    assert abs(sj - st) < 1e-10 * max(1.0, abs(sj))
    assert t.estimate_conditioning(omega) == st      # cached


@pytest.mark.parametrize("kind", KINDS)
def test_residual_ladders_take_the_plain_product_when_asked(kind):
    _, t = _responses("CCSD")
    A = t._Adict(t.pertbar[KEY[kind]])
    _, (X1, X2) = _pair(kind, 61)
    cc, hb = t.ccwfn, t._hb()
    l1, l2 = t.cclambda.l1, t.cclambda.l2
    calls = []

    def ladder(a, b):
        calls.append(tuple(a.shape))
        return vvvv_nt_reference(a, b)

    k1 = tresp.r_X(hb, cc.H.L, cc.t2, A, OMEGA, X1, X2, NO, t._aux)
    pl = tresp.r_X(hb, cc.H.L, cc.t2, A, OMEGA, X1, X2, NO, t._aux,
                   ladder=ladder)
    assert (k1[1] - pl[1]).abs().max() < 1e-14
    tresp.r_Y(hb, cc.H.L, cc.t2, X1, X2, OMEGA, X1, X2, NO, t._aux,
              ladder=ladder)
    tresp.in_Y1(hb, cc.H.L, cc.t2, l1, l2, A, X1, X2, NO, t._aux,
                ladder=ladder)
    rows = NO * NO * (2 if kind == "complex" else 1)
    # r_X, r_Y: one product each (complex: real and imaginary rows
    # stacked); in_Y1: its two l2 ladders stacked
    assert calls == [(rows, NV * NV), (rows, NV * NV),
                     (2 * NO * NO, NV * NV)]


@pytest.mark.parametrize("efab", [False, True])
def test_complex_ladder_is_one_stacked_product(efab):
    rng = np.random.default_rng(67)
    tau = (rng.standard_normal((3, 3, 5, 5))
           + 1j * rng.standard_normal((3, 3, 5, 5)))
    W = rng.standard_normal((5, 5, 5, 5))
    calls = []

    def ladder(a, b):
        calls.append((tuple(a.shape), a.dtype))
        return vvvv_nt_reference(a, b)

    tt, tW = torch.from_numpy(tau), torch.from_numpy(W)
    if efab:
        out = vvvv_contract_efab(tt, tW.permute(2, 3, 0, 1).contiguous(),
                                 ladder)
        ref = np.einsum("ijef,efab->ijab", tau, W)
    else:
        out = vvvv_contract(tt, tW, ladder)
        ref = np.einsum("ijef,abef->ijab", tau, W)
    assert calls == [((18, 25), torch.float64)]
    assert out.dtype == torch.complex128
    assert np.max(np.abs(out.numpy() - ref)) < 1e-12
    # on CPU tensors K1's wrapper takes the same plain product
    launches = vvvv_nt.launches
    k1 = vvvv_contract(tt, tW)
    assert vvvv_nt.launches == launches
    assert np.max(np.abs(k1.numpy() - np.einsum("ijef,abef->ijab", tau, W))) \
        < 1e-12


def test_complex_W_names_the_real_time_item():
    """A complex W (real-time CC's Lambda ladder; it raised for item 11
    before) is one ladder call on stacked operands, (2 o^2, v^2) x
    (2 v^2, v^2), for a complex W or its `StackedComplex` layout, and
    equals pycc_tpu's vvvv_contract on the same inputs."""
    from pycc_tpu.models.ccsd import vvvv_contract as jvvvv_contract
    from pycc_tpu_torch.ops.kernels.vvvv import stack_complex
    rng = np.random.default_rng(31)
    tau = (rng.standard_normal((3, 3, 4, 4))
           + 1j * rng.standard_normal((3, 3, 4, 4)))
    W = (rng.standard_normal((4, 4, 4, 4))
         + 1j * rng.standard_normal((4, 4, 4, 4)))
    ref = np.asarray(jvvvv_contract(jnp.asarray(tau), jnp.asarray(W)))
    assert np.max(np.abs(ref - np.einsum("ijef,abef->ijab", tau, W))) < 1e-12
    for tW in (torch.from_numpy(W), stack_complex(torch.from_numpy(W))):
        calls = []

        def ladder(a, b):
            calls.append((tuple(a.shape), tuple(b.shape), a.dtype))
            return vvvv_nt_reference(a, b)
        out = vvvv_contract(torch.from_numpy(tau), tW, ladder)
        assert calls == [((18, 16), (32, 16), torch.float64)]
        assert out.dtype == torch.complex128
        assert np.max(np.abs(out.numpy() - ref)) < 1e-12


# ---------------------------------------------------------------------------
# the reference suite's response oracles, through the port on the CPU
# ---------------------------------------------------------------------------

def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _pipeline(basis, conv):
    """A converged all-electron H2O ccwfn, its Lambda and ccdensity."""
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, basis, freeze_core=False),
                              device="cpu")
    _quiet(cc.solve_cc, conv, conv, 200)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    _quiet(lam.solve_lambda, conv, conv)
    return cc, lam, pycc_tpu_torch.ccdensity(cc, lam)


def test_linresp_polarizability_oracle():
    """tests/test_007::test_linresp_polarizability."""
    _, _, dens = _pipeline("aug-cc-pvdz", 1e-12)
    resp = pycc_tpu_torch.ccresponse(dens)
    tensor = resp.linresp("MU", "MU", 0.0656)
    polar = np.diag(tensor)
    assert abs(polar[0] - 9.92992070420665) < 1e-8
    assert abs(polar[1] - 13.443740151331559) < 1e-8
    assert abs(polar[2] - 11.342765745046526) < 1e-8
    assert abs(np.mean(polar) - 11.572142200333) < 1e-8
    assert np.abs(tensor - np.diag(polar)).max() < 1e-6


def test_conditioning_probe_and_warning_oracle():
    """tests/test_007::test_conditioning_probe_and_warning."""
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, "sto-3g", freeze_core=True),
                              device="cpu")
    _quiet(cc.solve_cc, 1e-12, 1e-12)
    hbar = _quiet(pycc_tpu_torch.cchbar, cc)
    lam = pycc_tpu_torch.cclambda(cc, hbar)
    _quiet(lam.solve_lambda, 1e-12, 1e-12)
    E, _ = _quiet(pycc_tpu_torch.cceom(hbar).solve_eom, N=1, e_conv=1e-10,
                  r_conv=1e-8)
    resp = pycc_tpu_torch.ccresponse(types.SimpleNamespace(ccwfn=cc,
                                                           cclambda=lam))
    e0 = float(np.asarray(E)[0])
    assert resp.estimate_conditioning(e0 - 1e-3) < 1e-2
    assert resp.estimate_conditioning(0.0656) > 1e-1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resp.solve_right(resp.pertbar["MU_X"], e0 - 1e-3, e_conv=1e-10,
                         r_conv=1e-10)
    assert any("near-singular" in str(r.message) for r in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resp.solve_right(resp.pertbar["MU_X"], 0.0656, e_conv=1e-10,
                         r_conv=1e-10)
    assert not any("near-singular" in str(r.message) for r in rec)


def test_pertcheck_operators_oracle():
    """tests/test_013::test_pertcheck_operators (MU, M, M*, P, P*, Q)."""
    _, _, dens = _pipeline("sto-3g", 1e-13)
    check = pycc_tpu_torch.ccresponse(dens).pertcheck(0.01)
    ref = {
        "MU_X_0.010000": 0.059711553704, "MU_Y_0.010000": 7.341419446523,
        "MU_Z_0.010000": 3.071438076138, "MU_X_-0.010000": 0.056273457658,
        "M_X_0.010000": 0.607770924164, "M_Y_0.010000": 0.710225214533,
        "M_Z_0.010000": 0.775111802368, "M*_X_-0.010000": 0.586575382108,
        "P_X_-0.010000": 0.097163221394, "P_Y_-0.010000": 2.169072875250,
        "P_Z_-0.010000": 1.497365713340, "P*_X_0.010000": 0.103276788499,
        "Q_XX_0.010000": 5.942498696750, "Q_YZ_0.010000": 19.240803761856,
        "Q_ZZ_0.010000": 0.250165812115, "Q_XY_-0.010000": 0.192591582644,
    }
    assert len(check) == 48      # 24 keys at +-omega
    for k, v in ref.items():
        assert abs(complex(check[k]).real - v) < 1e-10, k
