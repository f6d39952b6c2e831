"""The port's native local solvers (lccwfn.py, lccwfn_local.py,
lccwfn_screened.py) against pycc_tpu's on the CPU.

On one pair space carried across (`Local.from_numpy` on pycc_tpu's
stacks, H in pycc_tpu's localized orbitals) every precomputed stack and
every local residual (CCD, CCSD, CC2; unscreened and pair-screened)
equals pycc_tpu's to 1e-12.  Then the reference suite's cross-checks of
tests/test_010 run through the port: the native CCD/CCSD energies equal
the filter path's (and pycc_tpu's), native CC2 equals its dense
backend, and the pair-screened cases and their refusal hold.
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.lccwfn_local as jleq
import pycc_tpu.lccwfn_screened as jseq
import pycc_tpu_torch
import pycc_tpu_torch.hamiltonian as tham
import pycc_tpu_torch.lccwfn_local as tleq
import pycc_tpu_torch.lccwfn_screened as tseq
from pycc_tpu_torch.local import Local

from .common import scf

KW = dict(local="PNO", local_cutoff=1e-5, it2_opt=False)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _wfn():
    return scf("H2O", "cc-pvdz", freeze_core=False)


@functools.lru_cache(maxsize=None)
def _carried():
    """pycc_tpu's filter-path ccwfn (its H and Local, with the pair-pair
    overlaps) and the port's H and Local over the same orbitals and
    stacks."""
    ref = _quiet(pycc_tpu.ccwfn, _wfn(), filter=True, **KW)
    ref.Local.overlaps()
    H = tham.build_hamiltonian(_wfn(), C=ref.C, device="cpu")
    L = ref.Local
    lo = Local.from_numpy(np.asarray(L.Qp), np.asarray(L.Lp),
                          np.asarray(L.epsp), np.asarray(L.dim), H, ref.no,
                          ref.nv)
    lo.overlaps()
    return ref, H, lo


def _amps(ref, seed=3):
    rng = np.random.default_rng(seed)
    no, D = ref.no, ref.Local.D2
    t1 = 0.01 * rng.standard_normal((no, D))
    t2 = 0.01 * rng.standard_normal((no, no, D, D))
    return t1, t2 + t2.transpose(1, 0, 3, 2)


def _gap(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@functools.lru_cache(maxsize=None)
def _pre(kind):
    ref, H, lo = _carried()
    no, nv = ref.no, ref.nv
    if kind == "local":
        return (jleq.precompute_ccsd(ref.H, ref.Local, no, nv),
                tleq.precompute_ccsd(H, lo, no, nv))
    return (jseq.precompute_ccsd_screened(ref.H, ref.Local, no, nv, 1e-3),
            tseq.precompute_ccsd_screened(H, lo, no, nv, 1e-3))


@pytest.mark.parametrize("kind", ["local", "screened"])
def test_precomputed_stacks_match_pycc_tpu(kind):
    jpre, tpre = _pre(kind)
    assert set(jpre) == set(tpre)
    for key, a in jpre.items():
        b = tpre[key]
        if isinstance(b, torch.Tensor) and b.is_floating_point():
            assert tuple(b.shape) == tuple(np.shape(a)), key
            assert _gap(a, b) < 1e-12, key
        elif isinstance(b, torch.Tensor):      # index maps and masks
            assert np.array_equal(np.asarray(a), b.numpy()), key
        else:
            assert a == b, key
    if kind == "screened":
        P = tpre["P"]
        assert 0 < P < tpre["no"] ** 2


@pytest.mark.parametrize("model", ["CCD", "CCSD", "CC2"])
def test_local_residuals_match_pycc_tpu(model):
    ref, _, _ = _carried()
    jpre, tpre = _pre("local")
    t1, t2 = _amps(ref)
    if model == "CCD":
        r_j = (jleq.residuals_ccd_local(jpre, jnp.asarray(t2)),)
        r_t = (tleq.residuals_ccd_local(tpre, torch.from_numpy(t2)),)
        e_j = jleq.energy_ccd_local(jpre, jnp.asarray(t2))
        e_t = tleq.energy_ccd_local(tpre, torch.from_numpy(t2))
    else:
        fj = (jleq.residuals_ccsd_local if model == "CCSD"
              else jleq.residuals_cc2_local)
        ft = (tleq.residuals_ccsd_local if model == "CCSD"
              else tleq.residuals_cc2_local)
        r_j = fj(jpre, jnp.asarray(t1), jnp.asarray(t2))
        r_t = ft(tpre, torch.from_numpy(t1), torch.from_numpy(t2))
        e_j = jleq.energy_ccsd_local(jpre, jnp.asarray(t1), jnp.asarray(t2))
        e_t = tleq.energy_ccsd_local(tpre, torch.from_numpy(t1),
                                     torch.from_numpy(t2))
    for a, b in zip(r_j, r_t):
        assert _gap(a, b) < 1e-12
    assert abs(float(e_j) - float(e_t)) < 1e-12


@pytest.mark.parametrize("model", ["CCD", "CCSD"])
def test_screened_residuals_match_pycc_tpu(model):
    ref, _, _ = _carried()
    jpre, tpre = _pre("screened")
    t1, t2 = _amps(ref, seed=4)
    if model == "CCD":
        r_j = (jseq.residuals_ccd_screened(jpre, jnp.asarray(t2)),)
        r_t = (tseq.residuals_ccd_screened(tpre, torch.from_numpy(t2)),)
    else:
        r_j = jseq.residuals_ccsd_screened(jpre, jnp.asarray(t1),
                                           jnp.asarray(t2))
        r_t = tseq.residuals_ccsd_screened(tpre, torch.from_numpy(t1),
                                           torch.from_numpy(t2))
    for a, b in zip(r_j, r_t):
        assert _gap(a, b) < 1e-12
    assert abs(float(jseq.energy_ccsd_screened(jpre, jnp.asarray(t1),
                                               jnp.asarray(t2)))
               - float(tseq.energy_ccsd_screened(
                   tpre, torch.from_numpy(t1), torch.from_numpy(t2)))) < 1e-12


@functools.lru_cache(maxsize=None)
def _filter_energy(model):
    sim = _quiet(pycc_tpu_torch.ccwfn, _wfn(), model=model, filter=True,
                 device="cpu", **KW)
    return _quiet(sim.solve_cc, 1e-12, 1e-12, maxiter=100)


@functools.lru_cache(maxsize=None)
def _native(model, pair_cutoff=None, dense=False):
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), model=model, device="cpu",
                pair_cutoff=pair_cutoff, **KW)
    if dense:
        cc.lccwfn._use_local_eqs = False
    e = _quiet(cc.lccwfn.solve_lcc, 1e-12, 1e-12, maxiter=100)
    return cc.lccwfn, e


@pytest.mark.parametrize("model", ["CCD", "CCSD"])
def test_010_native_equals_the_filter_path(model):
    lw, e = _native(model)
    assert abs(_filter_energy(model) - e) < 1e-12
    # padded slots of the local amplitudes stay exactly zero
    d = np.asarray(lw.Local.dim)
    t2 = lw.t2.reshape(lw.no * lw.no, lw.Local.D2, lw.Local.D2)
    for ij, dij in enumerate(d):
        assert torch.all(t2[ij, dij:] == 0) and torch.all(t2[ij, :, dij:] == 0)


def test_native_ccsd_equals_pycc_tpu():
    ref = _quiet(pycc_tpu.ccwfn, _wfn(), model="CCSD", **KW)
    e_ref = _quiet(ref.lccwfn.solve_lcc, 1e-12, 1e-12, maxiter=100)
    assert abs(_native("CCSD")[1] - e_ref) < 1e-11


def test_010_native_local_cc2_matches_dense_backend():
    """The native pair-space CC2 equals the dense-backend local CC2 (the
    canonical CC2 residual, projected pair by pair)."""
    _, e_n = _native("CC2")
    _, e_d = _native("CC2", dense=True)
    assert abs(e_n - e_d) < 1e-12


def test_010_pair_screened_ccd_exact_at_zero_cutoff():
    _, e0 = _native("CCD")
    lw, e1 = _native("CCD", 0.0)
    assert lw._pre["P"] == lw.no ** 2
    assert abs(e1 - e0) < 1e-14


def _weak_rows_frozen(lw):
    no, nv = lw.no, lw.nv
    pidx = lw._pre["pidx"].numpy().reshape(-1)
    QLp = lw.Local.QLp.numpy()
    eri = -lw.H.ERI[lw.o, lw.o, lw.v, lw.v].numpy().reshape(no * no, nv, nv)
    t2_mp2 = np.einsum("pva,pvw,pwb->pab", QLp, eri, QLp) \
        / lw._Dloc.numpy()
    weak = pidx < 0
    assert weak.any()
    return np.max(np.abs(lw.t2.numpy()[weak] - t2_mp2[weak]))


def test_010_pair_screened_ccd_weak_pairs_frozen_at_mp2():
    _, e0 = _native("CCD")
    lw, e = _native("CCD", 1e-3)
    assert lw._pre["P"] < lw.no ** 2
    assert 0 < abs(e - e0) < 2e-2
    assert _weak_rows_frozen(lw) < 1e-13


def test_010_pair_screened_ccsd_exact_at_zero_cutoff():
    _, e0 = _native("CCSD")
    lw, e1 = _native("CCSD", 0.0)
    assert lw._pre["P"] == lw.no ** 2
    assert abs(e1 - e0) < 1e-12


def test_010_pair_screened_ccsd_weak_pairs_frozen_at_mp2():
    _, e0 = _native("CCSD")
    lw, e = _native("CCSD", 1e-3)
    assert lw._pre["P"] < lw.no ** 2
    assert 0 < abs(e - e0) < 2e-2
    assert _weak_rows_frozen(lw) < 1e-13
    assert bool(torch.isfinite(lw.t1).all())


def test_010_pair_screened_rejects_unsupported_combinations():
    with pytest.raises(ValueError, match="pair_cutoff"):
        pycc_tpu_torch.ccwfn(_wfn(), model="CC2", local="PNO",
                             local_cutoff=1e-5, pair_cutoff=1e-4,
                             device="cpu")
    with pytest.raises(ValueError, match="pair_cutoff"):
        pycc_tpu_torch.ccwfn(_wfn(), model="CCD", pair_cutoff=1e-4,
                             device="cpu")
    with pytest.raises(ValueError, match="pair_cutoff"):
        pycc_tpu_torch.ccwfn(_wfn(), local="PNO", pair_cutoff=1e-4,
                             filter=True, device="cpu")


def test_lccwfn_mesh_names_item_13():
    ref, H, lo = _carried()
    from pycc_tpu_torch.lccwfn import lccwfn
    with pytest.raises(NotImplementedError, match="item 13b"):
        lccwfn(slice(0, ref.no), slice(ref.no, None), ref.no, ref.nv, H,
               "PNO", "CCSD", 0.0, lo, mesh=object())
