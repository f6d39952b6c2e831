"""Blocked storage in the port (pycc_tpu_torch/models/blocked.py,
ccwfn(storage="blocked")) and the bf16-gated solve against pycc_tpu on
the same inputs, and tests/test_016's oracles through the port on the
CPU (its two sharded cases are in test_torch_mesh.py).

The views are bit-equal to the dense slices; the blocked post-convergence
stack equals full storage on the same wavefunction at 1e-12 (only the
integral transform's summation order differs) and pycc_tpu's blocked run
at 1e-11.
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
import pycc_tpu.models.blocked as jblocked
import pycc_tpu.models.ccsd as jeqs
import pycc_tpu.models.dfccsd as jdfq
import pycc_tpu_torch
from pycc_tpu.utils.synth import synthetic_hamiltonian as jax_synthetic
from pycc_tpu_torch.models.blocked import (BlockedERI, blocked_views,
                                           blocks_from_full)
from pycc_tpu_torch.ops.diis import DIIS
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils.synth import synthetic_hamiltonian

from .common import H2O, scf

E_CCSD_STO3G = -0.070616830152761     # frozen Psi4 (reference test_002)
E_CCSD_DZ = -0.222029814166783
PATTERNS = ["".join("ov"[(i >> k) & 1] for k in (3, 2, 1, 0))
            for i in range(16)]


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


@functools.lru_cache(maxsize=None)
def _wfn(basis="sto-3g", freeze_core=True):
    return run_rhf(H2O, basis, freeze_core=freeze_core)


def _cc(storage="full", basis="sto-3g", **kw):
    if storage == "df":
        kw.setdefault("df_tol", 1e-12)
    return pycc_tpu_torch.ccwfn(_wfn(basis), storage=storage, device="cpu",
                                **kw)


def _gap(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# ---------------------------------------------------------------------------
# the views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pat", PATTERNS)
def test_all_sixteen_patterns_and_L(pat):
    """Every ERI and L block of the views is bit-equal to the dense slice,
    and to pycc_tpu's views of the same numpy arrays."""
    no, nv = 5, 7
    H = synthetic_hamiltonian(no, nv, seed=3, device="cpu")
    jH = jax_synthetic(no, nv, seed=3)
    bE, bL = blocked_views(blocks_from_full(H.ERI, no), no)
    jE, jL = jblocked.blocked_views(jblocked.blocks_from_full(jH.ERI, no), no)
    sl = {"o": slice(0, no), "v": slice(no, None)}
    key = tuple(sl[c] for c in pat)
    assert torch.equal(H.ERI[key], bE[key])
    assert torch.equal(H.L[key], bL[key])
    assert np.array_equal(np.asarray(jE[key]), bE[key].numpy())
    assert np.array_equal(np.asarray(jL[key]), bL[key].numpy())


def test_views_take_the_ccwfn_slices_and_reject_others():
    """cc.v stops at nact rather than None: the views take both forms, and
    refuse any other slice."""
    no, nv = 5, 7
    H = synthetic_hamiltonian(no, nv, seed=3, device="cpu")
    bE = BlockedERI(blocks_from_full(H.ERI, no), no)
    v_nact = slice(no, no + nv)
    o = slice(0, no)
    assert torch.equal(bE[o, v_nact, v_nact, o], H.ERI[o, no:, no:, o])
    with pytest.raises(KeyError):
        bE[o, o, slice(1, no), o]


def test_blocks_from_the_ao_transform_match_the_dense_slices():
    """ccwfn(storage='blocked') transforms the six blocks straight from
    the AO ERI; they equal the slices of full storage's MO ERI."""
    full, blocked = _cc("full"), _cc("blocked")
    assert blocked.H.ERI is None and blocked.H.L is None
    ref = blocks_from_full(full.H.ERI, full.no)
    for name, b in zip(ref._fields, blocked.blocks):
        assert b.is_contiguous()
        assert _gap(b, ref._asdict()[name]) < 1e-13, name


# ---------------------------------------------------------------------------
# test_016's oracles through the port
# ---------------------------------------------------------------------------

def test_blocked_ccsd_oracle():
    with _quiet():
        ecc = _cc("blocked", "cc-pvdz").solve_cc(1e-12, 1e-12)
    assert abs(ecc - E_CCSD_DZ) < 1e-11


def test_blocked_matches_dense_cc3():
    with _quiet():
        e_d = _cc("full", "cc-pvdz", model="CC3").solve_cc(1e-12, 1e-12)
        e_b = _cc("blocked", "cc-pvdz", model="CC3").solve_cc(1e-12, 1e-12)
    assert abs(e_d - e_b) < 1e-13


def test_bad_storage_rejected():
    with pytest.raises(ValueError, match="sparse"):
        _cc("sparse")


@pytest.mark.parametrize("storage,tol", [("blocked", 1e-11), ("df", 1e-10)])
def test_bf16_gated_solve(storage, tol):
    """The first iterations contract bf16 operands, the rest full
    precision; the fixed point is the frozen oracle."""
    with _quiet():
        cc = _cc(storage)
        ecc = cc.solve_cc(1e-12, 1e-12, bf16_until=1e-3)
    assert cc.niter_bf16 > 0
    assert abs(ecc - E_CCSD_STO3G) < tol


def test_bf16_requires_blocked():
    """bf16_until on full storage raises, naming blocked storage, as
    pycc_tpu's solve_cc does."""
    with _quiet():
        jcc = pycc_tpu.ccwfn(scf("He", "cc-pvdz", freeze_core=False))
    with pytest.raises(Exception, match="blocked"):
        jcc.solve_cc(1e-8, 1e-8, bf16_until=1e-3)
    with pytest.raises(ValueError, match="blocked"):
        _cc("full").solve_cc(1e-8, 1e-8, bf16_until=1e-3)


def test_bf16_noise_floor_guard(monkeypatch):
    """A bf16_until below the bf16 noise floor does not diverge: the guard
    rolls the step back and finishes in full precision, and the DIIS ring
    after the rollback is bit-equal to the ring before the step."""
    rings, checked = [], []
    mark, restore = DIIS.mark, DIIS.restore

    def mark_and_copy(self, state):
        rings.append((state.amps.clone(), state.errs.clone(), state.count))
        return mark(self, state)

    def restore_and_check(self, state, m):
        restore(self, state, m)
        amps, errs, count = rings[-1]
        checked.append(torch.equal(state.amps, amps)
                       and torch.equal(state.errs, errs)
                       and state.count == count)

    monkeypatch.setattr(DIIS, "mark", mark_and_copy)
    monkeypatch.setattr(DIIS, "restore", restore_and_check)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ecc = _cc("blocked").solve_cc(1e-12, 1e-12, bf16_until=1e-14)
    assert abs(ecc - E_CCSD_STO3G) < 1e-11
    assert "noise floor" in buf.getvalue()
    assert checked == [True]


def _amplitudes(cc, seed=5):
    rng = np.random.default_rng(seed)
    t1 = 0.02 * rng.standard_normal(cc.t1.shape)
    t2 = cc.t2.numpy() + 0.002 * rng.standard_normal(cc.t2.shape)
    return t1, t2 + t2.transpose(1, 0, 3, 2)


@pytest.mark.parametrize("storage", ["blocked", "df"])
@pytest.mark.parametrize("model", ["CCSD", "CCD", "CC2"])
def test_bf16_residual_matches_pycc_tpu(storage, model):
    """One bf16 residual at the same amplitudes and integrals as pycc_tpu's
    bf16 step (its residual function on bf16 blocks or factors and bf16
    F, t1, t2): the port's is bfloat16 throughout (no float64 leftover
    promoted it) and within 5e-2 max|r| of pycc_tpu's."""
    cc = _cc(storage, model=model)
    t1, t2 = _amplitudes(cc)
    bf = jnp.bfloat16
    F16 = jnp.asarray(cc.H.F.numpy()).astype(bf)
    t1_16, t2_16 = jnp.asarray(t1).astype(bf), jnp.asarray(t2).astype(bf)
    if storage == "blocked":
        blocks = jblocked.ERIBlocks(*(jnp.asarray(b.numpy()).astype(bf)
                                      for b in cc.blocks))
        fn = {"CCSD": jeqs.residuals_ccsd, "CCD": jeqs.residuals_ccd,
              "CC2": jeqs.residuals_cc2}[model]
        jr = fn(F16, *jblocked.blocked_views(blocks, cc.no), t1_16, t2_16,
                cc.no)
    else:
        dfb = jdfq.DFERI(*(jnp.asarray(b.numpy()).astype(bf)
                           for b in cc.dfb))
        fn = {"CCSD": jdfq.residuals_ccsd_df, "CCD": jdfq.residuals_ccd_df,
              "CC2": jdfq.residuals_cc2_df}[model]
        jr = fn(F16, dfb, t1_16, t2_16, cc.no)
    tr = cc.residuals_bf16(cc.H.F, torch.from_numpy(t1), torch.from_numpy(t2))
    for j, t in zip(jr, tr):
        assert t.dtype == torch.bfloat16
        ref = np.asarray(j.astype(jnp.float32))
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert _gap(t.float(), ref) <= 5e-2 * scale


# ---------------------------------------------------------------------------
# the post-convergence stack on blocked storage
# ---------------------------------------------------------------------------

OMEGA = 0.0656


def _port_stack(storage):
    cc = _cc(storage)
    cc.solve_cc(1e-12, 1e-12)
    hb = pycc_tpu_torch.cchbar(cc)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    lecc = lam.solve_lambda(1e-12, 1e-12)
    dens = pycc_tpu_torch.ccdensity(cc, lam)
    E, _ = pycc_tpu_torch.cceom(hb).solve_eom(N=3, e_conv=1e-10,
                                              r_conv=1e-8)
    resp = pycc_tpu_torch.ccresponse(dens)
    A = resp.pertbar["MU_X"]
    _, _, px = resp.solve_right(A, OMEGA, 1e-12, 1e-12)
    _, _, py = resp.solve_left(A, OMEGA, 1e-12, 1e-12)
    return dict(hbar={k: getattr(hb, k).numpy() for k in
                      ("Hov", "Hvv", "Hoo", "Hoooo", "Hvvvv", "Hvovv",
                       "Hooov", "Hovvo", "Hovov", "Hvvvo", "Hovoo")},
                lambda_=lecc, density=dens.compute_energy(),
                eom=np.asarray(E), response=(complex(px).real, complex(py).real))


def _jax_density_energy(cc, dens):
    """pycc_tpu's ccdensity.compute_energy, term for term, over its block
    views indexed with slices(no): its own blocked branch indexes them
    with cc.v, which stops at nact, and its views refuse that."""
    o, v = jeqs.slices(cc.no)
    F, ERI = cc.H.F, jblocked.BlockedERI(cc.blocks, cc.no)
    e = (jnp.einsum("ij,ij->", F[o, o], dens.Doo)
         + jnp.einsum("ab,ab->", F[v, v], dens.Dvv)
         + 0.5 * jnp.einsum("ijkl,ijkl->", ERI[o, o, o, o], dens.Doooo)
         + 0.5 * jnp.einsum("abcd,abcd->", ERI[v, v, v, v], dens.Dvvvv)
         + jnp.einsum("ijka,ijka->", ERI[o, o, o, v], dens.Dooov)
         + jnp.einsum("abci,abci->", ERI[v, v, v, o], dens.Dvvvo)
         + jnp.einsum("iajb,iajb->", ERI[o, v, o, v], dens.Dovov)
         + 0.5 * jnp.einsum("ijab,ijab->", ERI[o, o, v, v], dens.Doovv))
    return float(e)


def _jax_stack():
    cc = pycc_tpu.ccwfn(scf("H2O", "sto-3g"), storage="blocked")
    cc.solve_cc(1e-12, 1e-12)
    hb = pycc_tpu.cchbar(cc)
    lam = pycc_tpu.cclambda(cc, hb)
    lecc = lam.solve_lambda(1e-12, 1e-12)
    dens = pycc_tpu.ccdensity(cc, lam)
    E, _ = pycc_tpu.cceom(hb).solve_eom(N=3, e_conv=1e-10, r_conv=1e-8)
    resp = pycc_tpu.ccresponse(dens)
    A = resp.pertbar["MU_X"]
    _, _, px = resp.solve_right(A, OMEGA, 1e-12, 1e-12)
    _, _, py = resp.solve_left(A, OMEGA, 1e-12, 1e-12)
    return dict(hbar={k: np.asarray(getattr(hb, k)) for k in
                      ("Hov", "Hvv", "Hoo", "Hoooo", "Hvvvv", "Hvovv",
                       "Hooov", "Hovvo", "Hovov", "Hvvvo", "Hovoo")},
                lambda_=lecc, density=_jax_density_energy(cc, dens),
                eom=np.asarray(E), response=(complex(px).real, complex(py).real))


@pytest.fixture(scope="module")
def stacks():
    with _quiet():
        return _port_stack("full"), _port_stack("blocked"), _jax_stack()


@pytest.mark.parametrize("what", ["hbar", "lambda_", "density", "eom",
                                  "response"])
def test_blocked_post_convergence_equals_full_and_pycc_tpu(stacks, what):
    full, blocked, jax_blocked = stacks
    if what == "hbar":
        for k in full["hbar"]:
            assert _gap(blocked["hbar"][k], full["hbar"][k]) < 1e-12, k
            assert _gap(blocked["hbar"][k], jax_blocked["hbar"][k]) < 1e-11, k
        return
    assert _gap(blocked[what], full[what]) < 1e-12
    assert _gap(blocked[what], jax_blocked[what]) < 1e-11
    if what == "density":
        assert abs(blocked[what] - E_CCSD_STO3G) < 1e-10


@pytest.mark.parametrize("make_t3_density,t3_scan", [
    (False, None), (True, False), (True, True)])
def test_blocked_triples_equal_full(make_t3_density, t3_scan):
    """E(T) through the K2 row scan (its plain version on the CPU) on
    slices cut from the block views, and the (T) density over the full T3
    or its slabs, equal full storage; so does the CCSD(T) density
    energy."""
    kw = dict(model="CCSD(T)", make_t3_density=make_t3_density,
              t3_scan=t3_scan)
    out = []
    with _quiet():
        for storage in ("full", "blocked"):
            cc = _cc(storage, **kw)
            e = cc.solve_cc(1e-12, 1e-12)
            lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
            lam.solve_lambda(1e-12, 1e-12)
            out.append((e, pycc_tpu_torch.ccdensity(cc, lam).compute_energy()))
    (e_f, d_f), (e_b, d_b) = out
    assert abs(e_b - e_f) < 1e-12
    assert abs(d_b - d_f) < 1e-12
