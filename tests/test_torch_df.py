"""The port's DF (Cholesky) storage against pycc_tpu's on the CPU in f64:
the factorizations, the factor residuals and energy on the same factors
and amplitudes, DF-SCF, the DF oracles, the first iterations of a DF
solve, and the from_df_factors entry."""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu_torch
from pycc_tpu.models import dfccsd as jdf
from pycc_tpu.ops import cholesky as jchol
from pycc_tpu.scf import df as jscf_df
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models import dfccsd as tdf
from pycc_tpu_torch.ops import cholesky as tchol
from pycc_tpu_torch.scf import df as tscf_df
from pycc_tpu_torch.scf import integrals as tints
from pycc_tpu_torch.scf import run_rhf

from .common import H2O
from .test_torch_ccwfn import _trajectory


@functools.lru_cache(maxsize=None)
def _wfn(basis, df=False, df_tol=1e-10):
    return run_rhf(H2O, basis, freeze_core=True, df=df, df_tol=df_tol)


def _solve(cc, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return cc.solve_cc(**kw)


def _rebuild(B):
    return torch.einsum("Ppr,Pqs->pqrs", B, B)


def test_hamiltonian_without_the_eri_keeps_f_and_the_properties():
    full = build_hamiltonian(_wfn("sto-3g"), device="cpu")
    lean = build_hamiltonian(_wfn("sto-3g"), device="cpu", eri=False)
    assert lean.ERI is None and lean.L is None and lean.vvvv is None
    assert torch.equal(lean.F, full.F) and lean.no == full.no
    for a, b in zip(lean.mu + lean.m + lean.p + lean.Q,
                    full.mu + full.m + full.p + full.Q):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tol", [1e-4, 1e-8])
def test_cholesky_factor_eri_reconstructs_the_eri(tol):
    ERI = build_hamiltonian(_wfn("cc-pvdz"), device="cpu").ERI
    B = tchol.cholesky_factor_eri(ERI, tol=tol, device="cpu")
    assert B.dtype == torch.float64 and B.device.type == "cpu"
    assert (_rebuild(B) - ERI).abs().max().item() < 10 * tol
    assert B.shape[0] < ERI.shape[0] ** 2      # actually compressed
    ref = jchol.cholesky_factor_eri(ERI.numpy(), tol=tol)
    assert B.shape == ref.shape


@functools.lru_cache(maxsize=None)
def _synthetic(no, nv, naux=30, seed=5):
    """Symmetric random factors, a Fock matrix with spread orbital
    energies, and random amplitudes (t2 with the pair symmetry), numpy."""
    rng = np.random.default_rng(seed)
    n = no + nv
    B = 0.1 * rng.standard_normal((naux, n, n))
    B = 0.5 * (B + B.swapaxes(1, 2))
    eps = np.concatenate([np.linspace(-2.0, -0.5, no),
                          np.linspace(0.3, 3.0, nv)])
    F = np.diag(eps) + 1e-3 * rng.standard_normal((n, n))
    F = 0.5 * (F + F.T)
    t1 = 0.05 * rng.standard_normal((no, nv))
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    return B, F, t1, t2 + t2.transpose(1, 0, 3, 2)


def _both(no, nv):
    B, F, t1, t2 = _synthetic(no, nv)
    jax_in = (jnp.asarray(F), jdf.df_blocks(jnp.asarray(B), no),
              jnp.asarray(t1), jnp.asarray(t2))
    port_in = (torch.tensor(F), tdf.df_blocks(torch.tensor(B), no),
               torch.tensor(t1), torch.tensor(t2))
    return jax_in, port_in


@pytest.mark.parametrize("name", ["residuals_ccsd_df", "residuals_ccd_df",
                                  "residuals_cc2_df"])
@pytest.mark.parametrize("nblocks", [None, 3])
def test_residuals_match_pycc_tpu(name, nblocks):
    no, nv = 3, 10
    (jF, jdfb, jt1, jt2), (F, dfb, t1, t2) = _both(no, nv)
    r1_ref, r2_ref = getattr(jdf, name)(jF, jdfb, jt1, jt2, no,
                                        nblocks=nblocks)
    r1, r2 = getattr(tdf, name)(F, dfb, t1, t2, no, nblocks=nblocks)
    assert np.abs(r1.numpy() - np.asarray(r1_ref)).max() < 1e-12
    assert np.abs(r2.numpy() - np.asarray(r2_ref)).max() < 1e-12


@pytest.mark.parametrize("nblocks", [3, 4, 10])
def test_ladder_blocks_equal_one_block(nblocks):
    no, nv = 3, 10
    _, (F, dfb, t1, t2) = _both(no, nv)
    one = tdf.ladder_df(dfb, t1, t2, nblocks=1)
    assert (tdf.ladder_df(dfb, t1, t2, nblocks=nblocks)
            - one).abs().max().item() < 1e-13


def test_ladder_is_the_dressed_dense_ladder():
    """0.5 tau <ab|ef> - t1 Zmbij of the dense equations, on the
    factor-rebuilt ERI."""
    no, nv = 3, 10
    _, (F, dfb, t1, t2) = _both(no, nv)
    B, _, _, _ = _synthetic(no, nv)
    ERI = _rebuild(torch.tensor(B))
    o, v = slice(0, no), slice(no, None)
    tau = t2 + torch.einsum("ia,jb->ijab", t1, t1)
    ref = (0.5 * torch.einsum("ijef,abef->ijab", tau, ERI[v, v, v, v])
           - torch.einsum("ma,mbef,ijef->ijab", t1, ERI[o, v, v, v], tau))
    assert (tdf.ladder_df(dfb, t1, t2) - ref).abs().max().item() < 1e-13


def test_ladder_blocks_follow_the_budget():
    # (H2O)_6/aug-cc-pVDZ: 9 blocks of 24 at the port's budget, and
    # pycc_tpu's 36 blocks of 6 at its own
    assert tdf._ladder_blocks(216, 2798) == 9
    assert tdf._ladder_blocks(216, 2798, max_elems=2 ** 26) == \
        jdf._ladder_blocks(216, 2798) == 36
    assert tdf._ladder_blocks(19, 30) == 1


def test_cc_energy_matches_pycc_tpu():
    no, nv = 3, 10
    (jF, jdfb, jt1, jt2), (F, dfb, t1, t2) = _both(no, nv)
    ref = float(jdf.cc_energy_df(jF, jdfb, jt1, jt2, no))
    assert abs(float(tdf.cc_energy_df(F, dfb, t1, t2, no)) - ref) < 1e-12


@functools.lru_cache(maxsize=None)
def _ao_factors(tol):
    basis = _wfn("cc-pvdz").basisset()
    return basis, tscf_df.cholesky_factor_ao(basis, tol=tol)


def test_ao_cholesky_matches_pycc_tpu_and_the_dense_eri():
    basis, B = _ao_factors(1e-8)
    ref = jscf_df.cholesky_factor_ao(basis, tol=1e-8)
    rec = np.einsum("Pab,Pcd->abcd", B, B)
    assert np.abs(rec - np.einsum("Pab,Pcd->abcd", ref, ref)).max() < 1e-8
    assert np.abs(rec - tints.eri(basis)).max() < 1e-7


def test_recompress_factors_keep_the_integrals():
    basis, B_ao = _ao_factors(1e-9)
    C = np.asarray(_wfn("cc-pvdz").Ca_subset("AO", "ACTIVE"))
    B_mo = tscf_df.factors_to_mo(B_ao, C)
    B2 = tchol.recompress_factors(B_mo, tol=1e-9, device="cpu")
    ref = jchol.recompress_factors(jscf_df.factors_to_mo(B_ao, C), tol=1e-9)
    assert B2.shape[0] <= B_mo.shape[0]
    rec = _rebuild(B2).numpy()
    assert np.abs(rec - np.einsum("Ppr,Pqs->pqrs", B_mo, B_mo)).max() < 1e-8
    assert np.abs(rec - np.einsum("Ppr,Pqs->pqrs", ref, ref)).max() < 1e-8


def test_df_scf_matches_pycc_tpu():
    port = _wfn("cc-pvdz", df=True)
    ref = pycc_tpu.scf.run_rhf(H2O, "cc-pvdz", freeze_core=True, df=True,
                               df_tol=1e-10)
    assert abs(port.energy() - ref.energy()) < 1e-10
    assert abs(port.energy() - _wfn("cc-pvdz").energy()) < 1e-9
    assert port.B_tol == 1e-10 and port.B_ao.shape == ref.B_ao.shape
    assert port.timers.count["rhf.ao_cholesky"] == 1


@pytest.mark.parametrize("basis,scf_df,tol,oracle,within", [
    ("sto-3g", False, 1e-12, -0.070616830152761, 1e-10),
    ("cc-pvdz", True, 1e-10, -0.222029814166783, 1e-9),
])
def test_df_oracles(basis, scf_df, tol, oracle, within):
    cc = pycc_tpu_torch.ccwfn(_wfn(basis, df=scf_df), storage="df",
                              df_tol=tol, device="cpu")
    assert cc.df_direct == scf_df and cc.H.ERI is None
    e = _solve(cc, e_conv=1e-12, r_conv=1e-12)
    assert cc.converged and abs(e - oracle) < within


def test_first_df_iterations_follow_pycc_tpu():
    ref_wfn = pycc_tpu.scf.run_rhf(H2O, "cc-pvdz", freeze_core=True,
                                   df=True, df_tol=1e-10)
    ref = _trajectory("pycc_tpu", pycc_tpu.ccwfn(ref_wfn, storage="df",
                                                 df_tol=1e-10))
    port = _trajectory("pycc_tpu_torch", pycc_tpu_torch.ccwfn(
        _wfn("cc-pvdz", df=True), storage="df", df_tol=1e-10, device="cpu"))
    assert len(ref) == len(port) == 5
    assert max(abs(a - b) for a, b in zip(ref, port)) < 1e-10


def _full_factors(cc):
    """The (naux, nact, nact) factor matrix reassembled from its blocks."""
    Boo, Bov, Bvv = cc.dfb
    return torch.cat([torch.cat([Boo, Bov], dim=2),
                      torch.cat([Bov.transpose(1, 2), Bvv], dim=2)], dim=1)


def test_from_df_factors_round_trip():
    wfn = _wfn("sto-3g")
    cc = pycc_tpu_torch.ccwfn(wfn, storage="df", df_tol=1e-11, device="cpu")
    e1 = _solve(cc, e_conv=1e-11, r_conv=1e-11)
    cc2 = pycc_tpu_torch.ccwfn.from_df_factors(
        _full_factors(cc).numpy(), cc.H.F.numpy(), cc.no,
        escf=wfn.energy(), device="cpu")
    assert cc2.eref == wfn.energy() and cc2.naux == cc.naux
    e2 = _solve(cc2, e_conv=1e-11, r_conv=1e-11)
    assert abs(e1 - e2) < 1e-12
    assert abs(e1 - -0.070616830152761) < 1e-9


def test_df_refuses_what_pycc_tpu_refuses():
    with pytest.raises(NotImplementedError, match="item 12"):
        pycc_tpu_torch.ccwfn(_wfn("sto-3g"), storage="df", local="PNO",
                             device="cpu")
    with pytest.raises(ValueError, match="CCSDT"):
        pycc_tpu_torch.ccwfn.from_df_factors(np.zeros((1, 3, 3)), np.eye(3),
                                             1, model="CCSDT", device="cpu")
    with pytest.raises(Exception, match="CCSDT"):
        pycc_tpu.ccwfn.from_df_factors(np.zeros((1, 3, 3)), np.eye(3), 1,
                                       model="CCSDT")
