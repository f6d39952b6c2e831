"""The port's DF-HBAR (models/dfhbar.py) against pycc_tpu's on the CPU in
float64, on tests/test_019's inputs: H2O/STO-3G factors at Cholesky tol
1e-14 and random t1/t2 (t2 not pair-symmetrised, so that every factor
derivation holds term by term).  Each block and consumer agrees with
pycc_tpu and with the port's dense HBAR on the factor-rebuilt ERI to
1e-11 (test_019's tolerance); `ladder_apply`'s a-blocks agree with the
plain product; and test_019's end-to-end checks run through the port:
the DF Lambda pseudo-energy oracle (1e-9) and the DF EOM-CCSD roots equal
to full storage's (1e-7).

`setup` and `gap` here are shared by test_torch_dfdensity.py and
test_torch_dfresponse.py."""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu.models import dfhbar as jq
from pycc_tpu.models.dfccsd import df_blocks as jdf_blocks
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu_torch.cceom import sigma_block_df
from pycc_tpu_torch.cchbar import build_hbar as tbuild_hbar
from pycc_tpu_torch.cclambda import lambda_residuals as tlambda_residuals
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models import dfhbar as tq
from pycc_tpu_torch.models.dfccsd import df_blocks as tdf_blocks
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O

TOL = 1e-11
BLOCKS = ("Hov", "Hvv", "Hoo", "Hoooo", "Hooov", "Hovvo", "Hovov", "Hovoo")


@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(H2O, "sto-3g", freeze_core=True)


@functools.lru_cache(maxsize=None)
def setup(seed=11):
    """test_019's inputs in both packages (numpy in, each package's
    tensors out): F, the factors (tol 1e-14), random t1/t2, and the
    port's dense ERI and L rebuilt from the factors."""
    H = build_hamiltonian(_wfn(), device="cpu")
    no = H.no
    nv = H.F.shape[0] - no
    B = np.asarray(cholesky_factor_eri(H.ERI.numpy(), tol=1e-14))
    rec = np.einsum("Ppr,Pqs->pqrs", B, B)
    rng = np.random.default_rng(seed)
    t1 = 0.05 * rng.standard_normal((no, nv))
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    F = H.F.numpy()
    jin = (jnp.asarray(F), jdf_blocks(jnp.asarray(B), no), jnp.asarray(t1),
           jnp.asarray(t2))
    tin = (torch.tensor(F), tdf_blocks(torch.tensor(B), no),
           torch.tensor(t1), torch.tensor(t2))
    ERI = torch.tensor(rec)
    dense = (ERI, 2.0 * ERI - ERI.swapaxes(2, 3))
    return no, nv, jin, tin, dense


def gap(a, b):
    """max |pycc_tpu's a - the port's b| (a jax array, b a tensor)."""
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@functools.lru_cache(maxsize=None)
def hbars(model="CCSD"):
    """(pycc_tpu's DFHBar, the port's DFHBar, the port's dense HBar on the
    factor-rebuilt ERI) for `setup`'s inputs."""
    no, _, (jF, jdf, jt1, jt2), (tF, tdf, tt1, tt2), (ERI, L) = setup()
    return (jax.jit(jq.build_hbar_df, static_argnums=(4, 5))(
                jF, jdf, jt1, jt2, no, model),
            tq.build_hbar_df(tF, tdf, tt1, tt2, no, model=model),
            tbuild_hbar(model, tF, ERI, L, tt1, tt2, no))


@pytest.mark.parametrize("model", ["CCSD", "CC2"])
def test_dfhbar_blocks_match_pycc_tpu_and_dense(model):
    jh, th, dense = hbars(model)
    for name in BLOCKS:
        assert gap(getattr(jh, name), getattr(th, name)) < TOL, name
        assert (getattr(dense, name) - getattr(th, name)).abs().max() < TOL
    for name in ("Bd_ae", "Bd_mi"):
        assert gap(getattr(jh, name), getattr(th, name)) < TOL, name


def test_hvovv_consumers_match_pycc_tpu_and_dense():
    no, nv, *_ = setup()
    jh, th, dense = hbars()
    C1, l1 = rand(no, nv, seed=1), rand(no, nv, seed=2)
    C2, Gvv = rand(no, no, nv, nv, seed=3), rand(nv, nv, seed=4)
    Hvovv = dense.Hvovv
    cases = [
        ("zvv_c1_hvovv", C1, 2.0 * torch.einsum("amef,mf->ae", Hvovv,
                                                torch.tensor(C1))
         - torch.einsum("amfe,mf->ae", Hvovv, torch.tensor(C1))),
        ("r1_c2_hvovv", C2, 2.0 * torch.einsum("imef,amef->ia",
                                               torch.tensor(C2), Hvovv)
         - torch.einsum("imef,amfe->ia", torch.tensor(C2), Hvovv)),
        ("r1_gvv_hvovv", Gvv, -2.0 * torch.einsum("ef,eifa->ia",
                                                  torch.tensor(Gvv), Hvovv)
         + torch.einsum("ef,eiaf->ia", torch.tensor(Gvv), Hvovv)),
        ("r2_l1_hvovv", l1, 2.0 * torch.einsum("ie,ejab->ijab",
                                               torch.tensor(l1), Hvovv)
         - torch.einsum("ie,ejba->ijab", torch.tensor(l1), Hvovv)),
    ]
    for name, x, ref in cases:
        out = getattr(tq, name)(th, torch.tensor(x))
        assert gap(getattr(jq, name)(jh, jnp.asarray(x)), out) < TOL, name
        assert (out - ref).abs().max() < TOL, name


@pytest.mark.parametrize("model", ["CCSD", "CC2"])
def test_hvvvo_consumers_match_pycc_tpu_and_dense(model):
    no, nv, (jF, _, jt1, jt2), (tF, _, tt1, tt2), _ = setup()
    jh, th, dense = hbars(model)
    l2, C1 = rand(no, no, nv, nv, seed=5), rand(no, nv, seed=6)
    cc2 = model == "CC2"
    jHov = jF[:no, no:] if cc2 else jh.Hov
    tHov = tF[:no, no:] if cc2 else th.Hov
    out = tq.r1_l2_hvvvo(th, tt1, tt2, torch.tensor(l2), tHov, cc2=cc2)
    ref = jq.r1_l2_hvvvo(jh, jt1, jt2, jnp.asarray(l2), jHov, cc2=cc2)
    assert gap(ref, out) < TOL
    dense_ref = torch.einsum("imef,efam->ia", torch.tensor(l2), dense.Hvvvo)
    assert (out - dense_ref).abs().max() < TOL
    if not cc2:
        out = tq.s2_c1_hvvvo(th, tt1, tt2, torch.tensor(C1), th.Hov)
        ref = jq.s2_c1_hvvvo(jh, jt1, jt2, jnp.asarray(C1), jh.Hov)
        assert gap(ref, out) < TOL
        dense_ref = torch.einsum("ie,abej->ijab", torch.tensor(C1),
                                 dense.Hvvvo)
        assert (out - dense_ref).abs().max() < TOL


@pytest.mark.parametrize("form", ["efab", "abef"])
def test_hvvvv_ladders_match_pycc_tpu_and_dense(form):
    no, nv, (_, _, _, jt2), (_, _, _, tt2), _ = setup()
    jh, th, dense = hbars()
    x2 = rand(no, no, nv, nv, seed=7)
    name = "hvvvv_x2_df" if form == "efab" else "hvvvv_x2_abef_df"
    ref = getattr(jq, name)(jh, jt2, jnp.asarray(x2))
    out = getattr(tq, name)(th, tt2, torch.tensor(x2))
    assert gap(ref, out) < TOL
    sub = "ijef,efab->ijab" if form == "efab" else "ijef,abef->ijab"
    dense_ref = 0.5 * torch.einsum(sub, torch.tensor(x2), dense.Hvvvv)
    assert (out - dense_ref).abs().max() < TOL
    # the default single a-block == two blocks
    two = getattr(tq, name)(th, tt2, torch.tensor(x2), nblocks=2)
    assert (two - out).abs().max() < 1e-14


def _counting():
    """A ladder that records the shapes of its calls and computes the
    plain product."""
    calls = []

    def ladder(A, B):
        calls.append((tuple(A.shape), tuple(B.shape)))
        return vvvv_nt_reference(A, B)
    return ladder, calls


# (name, BL = BR, BL as a transposed (e, a) view, nblocks); na = 7
LADDER_CASES = [
    ("same-one-block", True, False, 1),
    ("same-ragged", True, False, 3),
    ("other-even", False, False, 7),
    ("other-ea-ragged", False, True, 2),
]


@pytest.mark.parametrize("case", LADDER_CASES,
                         ids=[c[0] for c in LADDER_CASES])
@pytest.mark.parametrize("kind", ["real", "complex-x2", "complex-BL"])
def test_ladder_apply_equals_the_plain_product(case, kind):
    """Every a-block of `ladder_apply` is one ladder call; the blocks,
    ragged or not, in either factor layout, and with a complex x2 or left
    factor, give the plain product sum_ef x2 sum_P BL BR."""
    _, same, ea, nblocks = case
    naux, na, ne, nf, nb = 9, 7, 5, 4, 6
    if same:
        nb, nf = na, ne
    BL = rand(naux, na, ne, seed=8)
    BR = BL if same else rand(naux, nb, nf, seed=9)
    x2 = rand(2, 3, 3, ne, nf, seed=10)
    if kind == "complex-x2":
        x2 = x2 + 1j * rand(2, 3, 3, ne, nf, seed=11)
    if kind == "complex-BL":
        BL = BL + 1j * rand(naux, na, ne, seed=12)
    # ea: BL handed over as the (e, a) layout's transposed view
    tBL = (torch.tensor(np.ascontiguousarray(BL.swapaxes(1, 2))).transpose(
        1, 2) if ea else torch.tensor(BL))
    tBR, tx2 = torch.tensor(BR), torch.tensor(x2)
    ladder, calls = _counting()
    out = tq.ladder_apply(tBL, tBR, tx2, nblocks=nblocks, ladder=ladder)
    ref = np.einsum("kijef,Pae,Pbf->kijab", x2, BL, BR)
    assert out.shape == (2, 3, 3, na, nb)
    assert np.abs(out.numpy() - ref).max() < 1e-12
    blk = -(-na // nblocks)
    per_ladder = len(range(0, na, blk))
    assert len(calls) == per_ladder * (2 if kind == "complex-BL" else 1)
    rows = 2 * 18 if kind == "complex-x2" else 18
    assert all(a == (rows, ne * nf) for a, _ in calls)
    one = tq.ladder_apply(tBL, tBR, tx2, nblocks=1, ladder=vvvv_nt_reference)
    assert (one - out).abs().max() < 1e-12


def test_ladder_apply_with_a_complex_right_factor_names_item_11():
    BL = torch.zeros((2, 3, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="item 11"):
        tq.ladder_apply(BL, BL.to(torch.complex128),
                        torch.zeros((1, 3, 3), dtype=torch.float64))


@pytest.mark.parametrize("model,sources", [
    ("CCD", False), ("CC2", False), ("CCSD", False), ("CCSD", True)])
def test_lambda_residuals_df_match_pycc_tpu_and_dense(model, sources):
    no, nv, (jF, _, jt1, jt2), (tF, _, tt1, tt2), (ERI, L) = setup()
    jh, th, dense = hbars("CC2" if model == "CC2" else "CCSD")
    if model == "CCD":
        jt1, tt1 = 0.0 * jt1, 0.0 * tt1
        jh, th = (jq.build_hbar_df(jF, jh.df, jt1, jt2, no),
                  tq.build_hbar_df(tF, th.df, tt1, tt2, no))
        dense = tbuild_hbar("CCD", tF, ERI, L, tt1, tt2, no)
    l1 = rand(no, nv, seed=13)
    l2 = rand(no, no, nv, nv, seed=14)
    l2 = l2 + l2.transpose(1, 0, 3, 2)
    S = (rand(no, nv, seed=15), rand(no, no, nv, nv, seed=16)) if sources \
        else (None, None)
    jS = [None if x is None else jnp.asarray(x) for x in S]
    tS = [None if x is None else torch.tensor(x) for x in S]
    ref = jq.lambda_residuals_df(jh, jt1, jt2, jnp.asarray(l1),
                                 jnp.asarray(l2), no, *jS, model=model, F=jF)
    out = tq.lambda_residuals_df(th, tt1, tt2, torch.tensor(l1),
                                 torch.tensor(l2), no, *tS, model=model, F=tF)
    full = tlambda_residuals(model, dense, tF, ERI, L, tt1, tt2,
                             torch.tensor(l1), torch.tensor(l2), no, *tS)
    for a, b, c in zip(ref, out, full):
        assert gap(a, b) < TOL
        assert (b - c).abs().max() < TOL


def test_cc2_lambda_residuals_need_f():
    no, nv, *_ = setup()
    _, th, _ = hbars("CC2")
    z1, z2 = torch.zeros((no, nv)), torch.zeros((no, no, nv, nv))
    with pytest.raises(ValueError, match="Fock"):
        tq.lambda_residuals_df(th, z1, z2, z1, z2, no, model="CC2")


def test_sigmas_df_match_pycc_tpu():
    no, nv, (_, _, jt1, jt2), (_, _, tt1, tt2), _ = setup()
    jh, th, _ = hbars()
    C1, C2 = rand(no, nv, seed=17), rand(no, no, nv, nv, seed=18)
    jL, tL = jq.loovv_df(jh.df), tq.loovv_df(th.df)
    assert gap(jL, tL) < TOL
    ref1 = jq.sigma1_df(jh, jnp.asarray(C1), jnp.asarray(C2), jL, no)
    ref2 = jq.sigma2_df(jh, jnp.asarray(C1), jnp.asarray(C2), jL, jt1, jt2,
                        no)
    out1 = tq.sigma1_df(th, torch.tensor(C1), torch.tensor(C2), tL, no)
    out2 = tq.sigma2_df(th, torch.tensor(C1), torch.tensor(C2), tL, tt1, tt2,
                        no)
    assert gap(ref1, out1) < TOL
    assert gap(ref2, out2) < TOL


def test_sigma_block_df_is_the_per_vector_sigma_with_one_ladder_a_block():
    """A block of 3 vectors: each row equals the single-vector sigma, and
    the block's ladder is one call an a-block, on 3 o^2 stacked rows."""
    no, nv, _, (_, _, tt1, tt2), _ = setup()
    _, th, _ = hbars()
    tL = tq.loovv_df(th.df)
    C1, C2 = rand(3, no, nv, seed=19), rand(3, no, no, nv, nv, seed=20)
    C = torch.tensor(np.concatenate([C1.reshape(3, -1), C2.reshape(3, -1)],
                                    axis=1))
    ladder, calls = _counting()
    S = sigma_block_df(th, C, tL, tt1, tt2, no, nblocks=2, ladder=ladder)
    assert calls == [((3 * no * no, nv * nv), (nv, nv * nv))] * 2
    for k in range(3):
        s1 = tq.sigma1_df(th, torch.tensor(C1[k]), torch.tensor(C2[k]), tL, no)
        s2 = tq.sigma2_df(th, torch.tensor(C1[k]), torch.tensor(C2[k]), tL,
                          tt1, tt2, no)
        ref = torch.cat([s1.reshape(-1), s2.reshape(-1)])
        assert (S[k] - ref).abs().max() < 1e-12


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def _solved(storage, model="CCSD"):
    """A converged CPU ccwfn of H2O/STO-3G (DF at tol 1e-13) and its
    cchbar."""
    kw = dict(storage="df", df_tol=1e-13) if storage == "df" else {}
    cc = pycc_tpu_torch.ccwfn(_wfn(), model=model, device="cpu", **kw)
    _quiet(cc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    return cc, _quiet(pycc_tpu_torch.cchbar, cc)


def test_df_lambda_and_eom_oracles():
    """test_019 end to end through the port: the DF Lambda pseudo-energy
    against the frozen oracle, and the 3 DF EOM-CCSD roots against full
    storage's."""
    cc, hb = _solved("df")
    assert isinstance(hb.hbar, tq.DFHBar) and cc.H.ERI is None
    for name in BLOCKS:
        assert getattr(hb, name) is getattr(hb.hbar, name)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    lecc = _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12)
    assert lam.converged and abs(lecc - -0.068826452648939) < 1e-9

    eom = pycc_tpu_torch.cceom(hb)
    E, C = _quiet(eom.solve_eom, N=3, e_conv=1e-8, r_conv=1e-7)
    eom_full = pycc_tpu_torch.cceom(_solved("full")[1])
    E_ref, _ = _quiet(eom_full.solve_eom, N=3, e_conv=1e-8, r_conv=1e-7)
    assert eom.converged and eom_full.converged
    assert np.abs(E - E_ref).max() < 1e-7
    # the residual of each root, recomputed from the returned Ritz vectors
    S = eom.sigma(eom.ritz)
    w = torch.tensor(E)[:, None]
    assert torch.linalg.norm(S - w * eom.ritz, dim=1).max() < 1e-6


@pytest.mark.parametrize("method", ["CIS", "HBAR_SS", "UNIT"])
def test_df_eom_guesses_equal_full_storage(method):
    eps_df, g_df = pycc_tpu_torch.cceom(_solved("df")[1]).guess(3, method)
    eps, g = pycc_tpu_torch.cceom(_solved("full")[1]).guess(3, method)
    assert np.abs(np.real(eps_df) - np.real(eps)).max() < 1e-9
    assert g_df.shape == g.shape == (3,) + tuple(_solved("df")[0].t1.shape)


@pytest.mark.parametrize("model", ["CCD", "CC2"])
def test_df_lambda_ccd_and_cc2_equal_dense(model):
    out = {}
    for storage in ("df", "full"):
        cc, hb = _solved(storage, model)
        lam = pycc_tpu_torch.cclambda(cc, hb)
        out[storage] = (_quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12),
                        lam.l1, lam.converged)
    assert out["df"][2] and out["full"][2]
    assert abs(out["df"][0] - out["full"][0]) < 1e-9
    assert (out["df"][1] - out["full"][1]).abs().max() < 1e-7


def test_df_cchbar_takes_the_ccsd_form_for_ccsd_t():
    cc, hb = _solved("df", "CCSD(T)")
    _, ref = _solved("df", "CCSD")
    for name in BLOCKS:
        assert (getattr(hb, name) - getattr(ref, name)).abs().max() < 1e-9
