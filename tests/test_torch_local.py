"""The port's local-correlation spaces (pycc_tpu_torch/local.py) against
pycc_tpu's on the CPU.

Each pair of the PNO, PNO++, CPNO++ and PAO spaces keeps the dimension
pycc_tpu gives it, and spans the same space.  On one space carried
across (`Local.from_numpy` on pycc_tpu's padded stacks, the port's H
rebuilt in pycc_tpu's localized orbitals by `build_hamiltonian(C=)`),
the filters and both local MP2 solvers equal pycc_tpu's to 1e-12.  The
DLPNO-MP2 oracles of tests/test_028 hold through the port's own spaces.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.hamiltonian as jham
import pycc_tpu_torch
import pycc_tpu_torch.hamiltonian as tham
from pycc_tpu.scf import run_rhf as jrun_rhf
from pycc_tpu_torch.local import _EPS_PAD, Local

from .common import scf
from .test_010_local import H2_4

# (name, molecule, basis, local, cutoff, it2_opt)
SPACES = {
    "PNO": ("H2O", "cc-pvdz", "PNO", 1e-5, False),
    "PNO-opt": ("H2O", "cc-pvdz", "PNO", 1e-5, True),
    "PNO++": ("H2O", "cc-pvdz", "PNO++", 1e-7, False),
    "CPNO++": ("H2O", "cc-pvdz", "CPNO++", 1e-7, False),
    "PAO": ("H2O", "6-31g", "PAO", 2e-2, True),
    "PAO-(H2)_4": ("(H2)_4", "dz", "PAO", 2e-2, True),
}


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _wfn(mol, basis):
    if mol == "(H2)_4":
        return _h2_4(basis)
    return scf(mol, basis, freeze_core=False)


@functools.lru_cache(maxsize=None)
def _h2_4(basis):
    return jrun_rhf(H2_4, basis, freeze_core=False)


@functools.lru_cache(maxsize=None)
def _pair(key):
    """pycc_tpu's and the port's filter-path ccwfn of one space."""
    mol, basis, local, cutoff, it2 = SPACES[key]
    wfn = _wfn(mol, basis)
    kw = dict(local=local, local_cutoff=cutoff, it2_opt=it2, filter=True)
    ref = _quiet(pycc_tpu.ccwfn, wfn, **kw)
    port = _quiet(pycc_tpu_torch.ccwfn, wfn, device="cpu", **kw)
    return wfn, ref, port


@functools.lru_cache(maxsize=None)
def _carried(key="PNO"):
    """The port's H in pycc_tpu's localized orbitals and a Local over
    pycc_tpu's padded stacks."""
    wfn, ref, _ = _pair(key)
    H = tham.build_hamiltonian(wfn, C=ref.C, device="cpu")
    L = ref.Local
    lo = Local.from_numpy(np.asarray(L.Qp), np.asarray(L.Lp),
                          np.asarray(L.epsp), np.asarray(L.dim), H, ref.no,
                          ref.nv, local=L.local)
    return ref, H, lo


@pytest.mark.parametrize("key", list(SPACES))
def test_pair_dimensions_match_pycc_tpu(key):
    _, ref, port = _pair(key)
    rd, pd = np.asarray(ref.Local.dim), np.asarray(port.Local.dim)
    assert np.array_equal(rd, pd), (rd, pd)
    assert (port.Local.D1, port.Local.D2) == (ref.Local.D1, ref.Local.D2)
    # each pair spans pycc_tpu's space: the projectors Q Q^T agree
    Qr, Qp = np.asarray(ref.Local.Qp), port.Local.Qp.numpy()
    Pr = np.einsum("pva,pwa->pvw", Qr, Qr)
    Pp = np.einsum("pva,pwa->pvw", Qp, Qp)
    assert np.abs(Pr - Pp).max() < 1e-8


@pytest.mark.parametrize("key", ["PNO", "PAO"])
def test_padded_slots_are_zero_and_carry_the_sentinel(key):
    _, _, port = _pair(key)
    lo = port.Local
    for ij in range(lo.no * lo.no):
        d1, d2 = lo.Q[ij].shape[1], lo.L[ij].shape[1]
        assert torch.all(lo.Qp[ij, :, d1:] == 0)
        assert torch.all(lo.Lp[ij, d1:, :] == 0)
        assert torch.all(lo.Lp[ij, :, d2:] == 0)
        assert torch.all(lo.epsp[ij, d2:] == _EPS_PAD)
        assert torch.all(lo.QLp[ij, :, d2:] == 0)


def test_build_hamiltonian_in_localized_orbitals_matches_pycc_tpu():
    wfn, ref, _ = _pair("PNO")
    jH = jham.build_hamiltonian(wfn, C=ref.C)
    tH = tham.build_hamiltonian(wfn, C=ref.C, device="cpu")
    for name in ("F", "ERI", "L"):
        assert np.abs(np.asarray(getattr(jH, name))
                      - getattr(tH, name).numpy()).max() < 1e-12, name
    for name in ("mu", "m", "p", "Q"):
        r, t = getattr(jH, name), getattr(tH, name)
        assert len(r) == len(t) > 0
        assert max(np.abs(np.asarray(a) - b.numpy()).max()
                   for a, b in zip(r, t)) < 1e-12, name
    # the localized basis is not the canonical one
    F = tH.F.numpy()
    assert np.abs(F[:ref.no, :ref.no] - np.diag(np.diag(F[:ref.no, :ref.no]))
                  ).max() > 1e-3


@pytest.mark.parametrize("which", ["amps", "res", "t2amps"])
def test_filters_match_pycc_tpu(which):
    ref, _, lo = _carried()
    no, nv = ref.no, ref.nv
    rng = np.random.default_rng(11)
    r1 = rng.standard_normal((no, nv))
    r2 = rng.standard_normal((no, no, nv, nv))
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    import jax.numpy as jnp
    t1, t2 = torch.from_numpy(r1), torch.from_numpy(r2)
    if which == "t2amps":
        out_r = (ref.Local.filter_t2amps(jnp.asarray(r2)),)
        out_p = (lo.filter_t2amps(t2),)
    else:
        out_r = getattr(ref.Local, "filter_" + which)(jnp.asarray(r1),
                                                      jnp.asarray(r2))
        out_p = getattr(lo, "filter_" + which)(t1, t2)
    for a, b in zip(out_r, out_p):
        assert b.dtype == torch.float64
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12


def test_filter_res_is_a_real_linear_projector():
    """filter_res is idempotent, and a complex residual is filtered by its
    real and imaginary parts (local real-time CC)."""
    ref, _, lo = _carried()
    no, nv = ref.no, ref.nv
    g = torch.Generator().manual_seed(5)
    r1 = torch.randn((no, nv), generator=g, dtype=torch.float64)
    r2 = torch.randn((no, no, nv, nv), generator=g, dtype=torch.float64)
    f1, f2 = lo.filter_res(r1, r2)
    g1, g2 = lo.filter_res(f1, f2)
    assert (g1 - f1).abs().max() < 1e-12 and (g2 - f2).abs().max() < 1e-12
    c1, c2 = lo.filter_res(torch.complex(r1, 2 * r1),
                           torch.complex(r2, -r2))
    assert c2.dtype == torch.complex128
    assert (c1 - (f1 + 2j * f1)).abs().max() < 1e-12
    assert (c2 - (f2 - 1j * f2)).abs().max() < 1e-12


def test_local_and_simulated_mp2_match_pycc_tpu():
    ref, _, lo = _carried()
    e_r, ep_r, T_r = _quiet(ref.Local.local_mp2, e_conv=1e-12, r_conv=1e-10)
    e_p, ep_p, T_p = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    assert abs(e_r - e_p) < 1e-12
    assert np.abs(np.asarray(ep_r) - ep_p).max() < 1e-12
    assert np.abs(np.asarray(T_r) - T_p.numpy()).max() < 1e-12
    s_r, t_r = _quiet(ref.Local.sim_mp2, e_conv=1e-12, r_conv=1e-10)
    s_p, t_p = _quiet(lo.sim_mp2, e_conv=1e-12, r_conv=1e-10)
    assert abs(s_r - s_p) < 1e-12
    assert np.abs(np.asarray(t_r) - t_p.numpy()).max() < 1e-12


# --- tests/test_028's DLPNO-MP2 oracles through the port ---

@functools.lru_cache(maxsize=None)
def _local(cutoff, kind="PNO"):
    wfn = scf("H2O", "sto-3g", freeze_core=False)
    return _quiet(pycc_tpu_torch.ccwfn, wfn, local=kind, local_cutoff=cutoff,
                  it2_opt=False, filter=True, device="cpu").Local


def _hylleraas(lo):
    lo.it2_opt = True
    t2 = lo._mp2_t2()
    no, nv = lo.no, lo.nv
    L = lo.H.L.numpy()[:no, :no, no:no + nv, no:no + nv]
    return t2, L


def test_028_local_mp2_complete_space_exact():
    lo = _local(0.0)
    t2, L = _hylleraas(lo)
    e_ref = float(np.einsum("ijab,ijab->", t2, L))
    emp2, e_pair, _ = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    assert abs(emp2 - e_ref) < 1e-10
    assert abs(float(e_pair.sum()) - emp2) < 1e-12


def test_028_local_mp2_equals_sim_truncated():
    lo = _local(1e-6)
    assert int(np.asarray(lo.dim).min()) < lo.nv
    e_loc, e_pair, _ = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    e_sim, _ = _quiet(lo.sim_mp2, e_conv=1e-12, r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10
    assert np.abs(e_pair - e_pair.T).max() < 1e-10


def test_028_local_mp2_pao():
    lo = _local(0.02, kind="PAO")
    e_loc, _, _ = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    e_sim, _ = _quiet(lo.sim_mp2, e_conv=1e-12, r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10


def test_028_local_mp2_pair_energies_vs_hylleraas():
    lo = _local(0.0)
    t2, L = _hylleraas(lo)
    e_pair_ref = np.einsum("ijab,ijab->ij", t2, L)
    _, e_pair, _ = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    assert np.abs(e_pair - e_pair_ref).max() < 1e-10


def test_028_local_mp2_pnopp():
    lo = _local(1e-7, kind="PNO++")
    assert int(np.asarray(lo.dim).min()) < lo.nv
    e_loc, e_pair, _ = _quiet(lo.local_mp2, e_conv=1e-12, r_conv=1e-10)
    e_sim, _ = _quiet(lo.sim_mp2, e_conv=1e-12, r_conv=1e-10)
    e_full, _, _ = _quiet(_local(0.0, kind="PNO++").local_mp2, e_conv=1e-12,
                          r_conv=1e-10)
    assert abs(e_loc - e_sim) < 1e-10
    assert np.abs(e_pair - e_pair.T).max() < 1e-10
    assert abs(e_loc) < abs(e_full) + 1e-12
    assert abs(e_loc - e_full) < 0.02 * abs(e_full)
