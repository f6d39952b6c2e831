"""Mixed precision and checkpoint/resume in the port, against pycc_tpu and
through tests/test_027's oracles on the CPU.

Every mixed solver (solve_cc_mixed on full, blocked and DF storage, CC3
over factors, solve_lambda_mixed, solve_right/left_mixed, solve_eom_mixed)
lands on its pure-float64 fixed point at test_027's tolerances; a killed
solve resumes from its checkpoint (with the DIIS ring, on the exact
trajectory); checkpoints cross between the packages both ways; a save
that fails leaves the last checkpoint intact; `_cast_stage` puts
everything a residual reads into the stage's dtype and back, bit for bit,
from the float64 masters.  test_027's split DF residual is not ported, and
its host-subspace EOM case becomes the device_subspace=True no-op.
"""

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.utils.checkpoint as jchk
import pycc_tpu_torch
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils import checkpoint as tchk

from .common import H2O, scf

E_CCSD_STO3G = -0.070616830152761   # frozen Psi4 (reference test_002)


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


@functools.lru_cache(maxsize=None)
def _wfn(freeze_core=True):
    return run_rhf(H2O, "sto-3g", freeze_core=freeze_core)


def _cc(storage="full", freeze_core=True, **kw):
    if storage == "df":
        kw.setdefault("df_tol", 1e-12)
    return pycc_tpu_torch.ccwfn(_wfn(freeze_core), storage=storage,
                                device="cpu", **kw)


def _gap(a, b):
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["full", "blocked"])
def test_mixed_matches_oracle(storage):
    with _quiet():
        cc = _cc(storage)
        e = cc.solve_cc_mixed(1e-12, 1e-12)
    assert abs(e - E_CCSD_STO3G) < 1e-11
    assert [s[:2] for s in cc.stages] == [("floor", "torch.float32"),
                                          ("refine", "torch.float64")]
    assert cc.t2.dtype == torch.float64


def test_mixed_refinement_drops_the_floors_antisymmetric_roundoff():
    """The float32 floor leaves roundoff in the pair-antisymmetric part of
    t2, which the symmetrised residual never corrects but which moves its
    fixed point: without the projection of `_cast_stage` this solve ended
    2.1e-11 from the oracle (H2O/cc-pVDZ, blocked, a bf16 stage first)."""
    wfn = run_rhf(H2O, "cc-pvdz", freeze_core=True)
    with _quiet():
        cc = pycc_tpu_torch.ccwfn(wfn, storage="blocked", device="cpu")
        e = cc.solve_cc_mixed(1e-11, 1e-11, sp_kwargs={"bf16_until": 1e-3})
    t2 = cc.t2
    assert torch.equal(t2, t2.permute(1, 0, 3, 2)) or \
        float((t2 - t2.permute(1, 0, 3, 2)).abs().max()) < 1e-15
    assert abs(e - -0.222029814166783) < 1e-12


def test_mixed_df_matches_pure_f64():
    with _quiet():
        e64 = _cc("df").solve_cc(1e-12, 1e-12)
        emx = _cc("df").solve_cc_mixed(1e-12, 1e-12)
    assert abs(emx - e64) < 1e-11
    assert abs(emx - E_CCSD_STO3G) < 1e-9


def test_mixed_bf16_floor_stage():
    """sp_kwargs={'bf16_until': ...}: K1's three modes on one solve (bf16,
    then float32, then float64), on the pure-float64 fixed point."""
    with _quiet():
        cc = _cc("blocked")
        e = cc.solve_cc_mixed(1e-12, 1e-12, sp_kwargs={"bf16_until": 1e-3})
    assert abs(e - E_CCSD_STO3G) < 1e-11


def test_mixed_lambda_matches_pure_f64():
    with _quiet():
        cc64 = _cc("df")
        cc64.solve_cc(1e-12, 1e-12)
        le64 = pycc_tpu_torch.cclambda(
            cc64, pycc_tpu_torch.cchbar(cc64)).solve_lambda(1e-12, 1e-12)
        cc = _cc("df")
        cc.solve_cc_mixed(1e-12, 1e-12)
        lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
        lemx = lam.solve_lambda_mixed(1e-12, 1e-12)
    assert lam.converged
    assert abs(lemx - le64) < 1e-11
    assert abs(lam.e_sp_floor - le64) < 1e-4
    assert lam.l2.dtype == cc.t2.dtype == torch.float64


def _response(storage):
    cc = _cc(storage)
    cc.solve_cc(1e-12, 1e-12)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(1e-12, 1e-12)
    return cc, pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(cc, lam))


def test_mixed_response_matches_pure_f64():
    om = 0.0656
    with _quiet():
        cc, resp = _response("full")
        X1, _, px = resp.solve_right(resp.pertbar["MU_X"], om, 1e-12, 1e-12)
        Y1, _, py = resp.solve_left(resp.pertbar["MU_X"], om, 1e-12, 1e-12)
        X1m, _, pxm = resp.solve_right_mixed("MU_X", om, e_conv=1e-12,
                                             r_conv=1e-12, sp_conv=1e-5)
        Y1m, _, pym = resp.solve_left_mixed("MU_X", om, e_conv=1e-12,
                                            r_conv=1e-12, sp_conv=1e-5)
    assert abs(pxm - px) < 1e-10
    assert abs(pym - py) < 1e-10
    assert _gap(X1m, X1) < 1e-10
    assert _gap(Y1m, Y1) < 1e-10
    assert resp.pertbar["MU_X"].Avo.dtype == torch.float64
    assert cc.t1.dtype == torch.float64


@pytest.mark.parametrize("om", [0.0, 0.1])
def test_mixed_response_df_matches_pure_f64(om):
    with _quiet():
        _, resp = _response("df")
        X1, _, px = resp.solve_right(resp.pertbar["MU_X"], om, 1e-12, 1e-12)
        X1m, _, pxm = resp.solve_right_mixed("MU_X", om, e_conv=1e-12,
                                             r_conv=1e-12, sp_conv=1e-5)
    assert abs(pxm - px) < 1e-10
    assert _gap(X1m, X1) < 1e-10


def test_mixed_cc3_df():
    with _quiet():
        e64 = _cc("df", model="CC3").solve_cc(1e-12, 1e-12)
        emx = _cc("df", model="CC3").solve_cc_mixed(1e-12, 1e-12)
    assert abs(emx - e64) < 1e-11


def _sp_lambda():
    cc = _cc(precision="SP")
    cc.solve_cc(1e-7, 1e-7)
    return cc, pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))


def _sp_response():
    cc, lam = _sp_lambda()
    lam.solve_lambda(1e-7, 1e-7)
    return pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(cc, lam))


@pytest.mark.parametrize("call", [
    lambda: _cc(precision="SP").solve_cc_mixed(),
    lambda: _sp_lambda()[1].solve_lambda_mixed(),
    lambda: _sp_response().solve_right_mixed("MU_X", 0.0656),
    lambda: pycc_tpu_torch.cceom(
        pycc_tpu_torch.cchbar(_sp_lambda()[0])).solve_eom_mixed(N=1),
], ids=["cc", "lambda", "response", "eom"])
def test_mixed_requires_dp(call):
    with _quiet(), pytest.raises(ValueError, match="DP"):
        call()


def _eom_pair(**kw):
    cc = _cc(freeze_core=False)
    cc.solve_cc(1e-12, 1e-12)
    E64, _ = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(cc)).solve_eom(
        N=kw.get("N", 3), e_conv=1e-9, r_conv=1e-7)
    eom = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(cc))
    Emx, _ = eom.solve_eom_mixed(e_conv=1e-9, r_conv=1e-7, **kw)
    return eom, Emx, E64


def test_mixed_eom_matches_pure_f64():
    with _quiet():
        eom, Emx, E64 = _eom_pair(N=3)
    assert eom.converged
    assert np.allclose(Emx, E64, atol=1e-8)
    assert np.allclose(eom.e_sp_floor, E64, atol=1e-3)
    assert (np.abs(Emx - E64).max()
            < np.abs(eom.e_sp_floor - E64).max() + 1e-8)


def test_mixed_eom_device_subspace():
    """The subspace always lives on the device: device_subspace=True is
    the same solve, False (pycc_tpu's host subspace) is refused."""
    with _quiet():
        eom, Emx, E64 = _eom_pair(N=2, device_subspace=True)
    assert eom.converged
    assert np.allclose(Emx, E64, atol=1e-8)
    with pytest.raises(ValueError, match="device_subspace"):
        eom.solve_eom(N=1, device_subspace=False)


def test_eom_array_guess_drops_pair_antisymmetric_doubles():
    """Seeds whose doubles carry a pair-antisymmetric part (float32
    roundoff in solve_eom_mixed's floor Ritz vectors, here 1e-3 of it)
    refine to the roots, not to spurious ones near 0: the sigma nearly
    annihilates that part (before the projection these seeds gave roots of
    1e-8)."""
    with _quiet():
        cc = _cc(freeze_core=False)
        cc.solve_cc(1e-12, 1e-12)
        eom = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(cc))
        E0, _ = eom.solve_eom(N=3, e_conv=1e-9, r_conv=1e-7)
        no, nv = cc.no, cc.nv
        seeds = eom.ritz.numpy().copy()
        Z = np.random.default_rng(0).standard_normal((3, no, no, nv, nv))
        seeds[:, no * nv:] += 1e-3 * (Z - Z.transpose(0, 2, 1, 4, 3)).reshape(
            3, -1)
        E, _ = eom.solve_eom(N=3, e_conv=1e-9, r_conv=1e-7, guess=seeds)
    assert eom.converged
    assert np.allclose(E, E0, atol=1e-8)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_solve_cc_kill_and_resume(tmp_path):
    """Killed after 4 iterations (maxiter=4), resumed in a fresh object:
    with the ring the resumed trajectory is the uninterrupted one, and
    resuming to convergence lands on the oracle."""
    pa, pb = str(tmp_path / "full.npz"), str(tmp_path / "killed.npz")
    with _quiet():
        with pytest.warns(UserWarning):
            _cc().solve_cc(1e-12, 1e-12, maxiter=8, chk=pa, chk_every=1,
                           chk_ring=True)
        with pytest.warns(UserWarning):
            _cc().solve_cc(1e-12, 1e-12, maxiter=4, chk=pb, chk_every=1,
                           chk_ring=True)
        with pytest.warns(UserWarning):
            _cc().solve_cc(1e-12, 1e-12, maxiter=8, chk=pb, chk_every=1,
                           chk_ring=True, resume=True)
    da, db = np.load(pa), np.load(pb)
    assert int(da["niter"]) == int(db["niter"]) == 8
    assert np.abs(da["t2"] - db["t2"]).max() < 1e-12
    assert abs(float(da["ecc"]) - float(db["ecc"])) < 1e-12
    with _quiet():
        ec = _cc().solve_cc(1e-12, 1e-12, chk=pb, resume=True)
    assert abs(ec - E_CCSD_STO3G) < 1e-11


def test_resume_with_another_ring_depth_warns(tmp_path):
    """A ring saved at another depth than max_diis is dropped with a
    warning; the amplitudes resume and the solve converges."""
    p = str(tmp_path / "ring.npz")
    with _quiet(), pytest.warns(UserWarning):
        _cc().solve_cc(1e-12, 1e-12, maxiter=4, chk=p, chk_every=1,
                       chk_ring=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        e = _cc().solve_cc(1e-12, 1e-12, max_diis=4, chk=p, resume=True)
    assert "ring depth 8 != current max_diis ring depth 4" in buf.getvalue()
    assert abs(e - E_CCSD_STO3G) < 1e-11


def test_pycc_tpu_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint pycc_tpu writes after 4 iterations, with its ring,
    resumes in the port to iteration 8 on pycc_tpu's own trajectory."""
    pa, pb = str(tmp_path / "jax8.npz"), str(tmp_path / "jax4.npz")
    wfn = scf("H2O", "sto-3g")
    with _quiet():
        with pytest.warns(UserWarning):
            pycc_tpu.ccwfn(wfn).solve_cc(1e-12, 1e-12, maxiter=8, chk=pa,
                                         chk_every=1, chk_ring=True)
        with pytest.warns(UserWarning):
            pycc_tpu.ccwfn(wfn).solve_cc(1e-12, 1e-12, maxiter=4, chk=pb,
                                         chk_every=1, chk_ring=True)
        with pytest.warns(UserWarning):
            _cc().solve_cc(1e-12, 1e-12, maxiter=8, chk=pb, chk_every=1,
                           chk_ring=True, resume=True)
    da, db = np.load(pa), np.load(pb)
    assert int(db["niter"]) == 8
    assert np.abs(da["t2"] - db["t2"]).max() < 1e-12
    assert abs(float(da["ecc"]) - float(db["ecc"])) < 1e-12


def test_port_checkpoint_loads_in_pycc_tpu(tmp_path):
    p = str(tmp_path / "port.npz")
    with _quiet(), pytest.warns(UserWarning):
        cc = _cc()
        cc.solve_cc(1e-12, 1e-12, maxiter=3, chk=p, chk_every=1,
                    chk_ring=True)
    d = jchk.load_amps(p)
    assert int(d["niter"]) == 3 and int(d["diis_count"]) == 3
    assert set(d) == {"t1", "t2", "niter", "ecc", "diis_amps", "diis_errs",
                      "diis_count"}
    assert np.asarray(d["t2"]).shape == tuple(cc.t2.shape)
    with _quiet():
        e = pycc_tpu.ccwfn(scf("H2O", "sto-3g")).solve_cc(
            1e-12, 1e-12, chk=p, chk_ring=True, resume=True)
    assert abs(e - E_CCSD_STO3G) < 1e-11


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the previous checkpoint intact
    and loadable."""
    p = str(tmp_path / "a.npz")
    tchk.save_amps(p, t1=torch.ones(2, 3), niter=1)

    def broken(fh, **arrays):
        fh.write(b"PK\x03\x04 truncated")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", broken)
    with pytest.raises(OSError, match="disk full"):
        tchk.save_amps(p, t1=torch.zeros(2, 3), niter=2)
    d = tchk.load_amps(p, device="cpu")
    assert int(d["niter"]) == 1 and torch.equal(d["t1"], torch.ones(2, 3))


def test_solve_lambda_resume(tmp_path):
    p = str(tmp_path / "lam.npz")
    with _quiet():
        cc = _cc()
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu_torch.cchbar(cc)
        le_full = pycc_tpu_torch.cclambda(cc, hbar).solve_lambda(1e-12,
                                                                 1e-12)
        with pytest.warns(UserWarning):
            pycc_tpu_torch.cclambda(cc, hbar).solve_lambda(
                1e-12, 1e-12, maxiter=3, chk=p, chk_every=1, chk_ring=True)
        le_res = pycc_tpu_torch.cclambda(cc, hbar).solve_lambda(
            1e-12, 1e-12, chk=p, chk_ring=True, resume=True)
    assert set(np.load(p).files) >= {"l1", "l2", "niter"}
    assert abs(le_res - le_full) < 1e-11


def test_solve_eom_resume(tmp_path):
    p = str(tmp_path / "eom.npz")
    with _quiet():
        cc = _cc(freeze_core=False)
        cc.solve_cc(1e-12, 1e-12)
        hbar = pycc_tpu_torch.cchbar(cc)
        E_full, _ = pycc_tpu_torch.cceom(hbar).solve_eom(N=2, e_conv=1e-8,
                                                         r_conv=1e-6)
        with pytest.warns(UserWarning):
            pycc_tpu_torch.cceom(hbar).solve_eom(N=2, e_conv=1e-8,
                                                 r_conv=1e-6, maxiter=2,
                                                 chk=p)
        E_res, _ = pycc_tpu_torch.cceom(hbar).solve_eom(
            N=2, e_conv=1e-8, r_conv=1e-6, chk=p, resume=True)
    assert set(np.load(p).files) == {"C", "E", "niter"}
    assert np.allclose(E_res, E_full, atol=1e-8)


def test_mixed_stage_aware_resume(tmp_path):
    """Interrupted in the refinement, a mixed solve resumes straight into
    it: the floor record carries the floor amplitudes and e_sp_floor."""
    base = str(tmp_path / "mx")
    with _quiet():
        e_ref = _cc().solve_cc_mixed(1e-12, 1e-12)
        cc1 = _cc()
        with pytest.warns(UserWarning):
            cc1.solve_cc_mixed(1e-12, 1e-12, chk=base, chk_every=1,
                               refine_maxiter=2)
    assert os.path.exists(base + ".floor.npz")
    with _quiet():
        cc2 = _cc()
        e2 = cc2.solve_cc_mixed(1e-12, 1e-12, chk=base, chk_every=1,
                                resume=True)
    assert [s[0] for s in cc2.stages] == ["refine"]
    assert cc2.e_sp_floor == cc1.e_sp_floor
    assert abs(e2 - e_ref) < 1e-11
    assert abs(e2 - E_CCSD_STO3G) < 1e-11


# ---------------------------------------------------------------------------
# the precision stages
# ---------------------------------------------------------------------------

def _stage_items(cc):
    items = {"F": cc.H.F, "Dia": cc.Dia, "Dijab": cc.Dijab, "t1": cc.t1,
             "t2": cc.t2}
    items.update({"mu%d" % k: x for k, x in enumerate(cc.H.mu)})
    items.update({"Q%d" % k: x for k, x in enumerate(cc.H.Q)})
    items.update({"m%d" % k: x for k, x in enumerate(cc.H.m)})
    items.update({"p%d" % k: x for k, x in enumerate(cc.H.p)})
    if cc.storage == "full":
        items.update(ERI=cc.H.ERI, L=cc.H.L, vvvv=cc.vvvv())
    elif cc.storage == "blocked":
        items.update(zip(cc.blocks._fields, cc.blocks), vvvv=cc.vvvv())
    else:
        items.update(zip(cc.dfb._fields, cc.dfb))
    return items


@pytest.mark.parametrize("storage", ["full", "blocked", "df"])
def test_cast_stage_round_trip(storage):
    """_cast_stage(float32) leaves everything a residual, Lambda or sigma
    reads in float32 (m and p in complex64), and drops the stage caches;
    the residual comes out float32.  _cast_stage(float64) restores every
    item bit for bit from the masters."""
    cc = _cc(storage)
    before = {k: v.clone() for k, v in _stage_items(cc).items()}
    cc._ensure_mixed_masters()
    cc.S1 = cc.S2 = torch.zeros(1)
    cc._cast_stage(torch.float32)
    assert "S1" not in cc.__dict__ and "S2" not in cc.__dict__
    for k, x in _stage_items(cc).items():
        want = torch.complex64 if before[k].is_complex() else torch.float32
        assert x.dtype == want, k
    r1, r2 = cc.residuals(cc.H.F, cc.t1, cc.t2)
    assert r1.dtype == r2.dtype == torch.float32
    cc._cast_stage(torch.float64)
    after = _stage_items(cc)
    for k, x in before.items():
        if k in ("t1", "t2"):
            # the iterate itself went through float32
            continue
        assert after[k].dtype == x.dtype and torch.equal(after[k], x), k
