"""The port's EOM-CCSD sigmas against pycc_tpu's on the synthetic inputs of
test_torch_cchbar (1e-12), and the Davidson oracles of tests/test_006
through the port on the CPU."""

import contextlib
import functools
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.cceom
import pycc_tpu_torch
import pycc_tpu_torch.cceom
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O
from .test_torch_cchbar import MODELS, NO, NV, gap, hbars, synthetic_inputs

# the packages export the solver classes under the module names
jeom = sys.modules["pycc_tpu.cceom"]
teom = sys.modules["pycc_tpu_torch.cceom"]


def _vectors(k, seed):
    rng = np.random.default_rng(seed)
    C1 = rng.standard_normal((k, NO, NV))
    C2 = rng.standard_normal((k, NO, NO, NV, NV))
    return C1, C2 + C2.transpose(0, 2, 1, 4, 3)


class _L:
    """pycc_tpu's sigmas read L[o, o, v, v] only."""

    def __init__(self, L):
        self.L = L

    def __getitem__(self, key):
        return self.L[key]


@pytest.mark.parametrize("model", MODELS)
def test_sigma1_and_sigma2_match_pycc_tpu(model):
    jH, tH, _, t2, _, _ = synthetic_inputs()
    jhb, thb = hbars(model)
    C1, C2 = _vectors(1, 41)
    C1, C2 = C1[0], C2[0]
    j1 = jeom.sigma1(jhb, jnp.asarray(C1), jnp.asarray(C2), _L(jH.L), NO)
    j2 = jeom.sigma2(jhb, jnp.asarray(C1), jnp.asarray(C2), _L(jH.L),
                     jnp.asarray(t2), NO)
    t1_ = teom.sigma1(thb, torch.from_numpy(C1), torch.from_numpy(C2), tH.L,
                      NO)
    t2_ = teom.sigma2(thb, torch.from_numpy(C1), torch.from_numpy(C2), tH.L,
                      torch.from_numpy(t2), NO)
    assert gap(j1, t1_) < 1e-12
    assert gap(j2, t2_) < 1e-12


@pytest.mark.parametrize("ladder", ["K1", "plain"])
def test_sigma_block_is_the_per_vector_sigma(ladder):
    _, tH, _, t2, _, _ = synthetic_inputs()
    _, thb = hbars("CCSD")
    C1, C2 = _vectors(3, 43)
    C = torch.from_numpy(np.concatenate([C1.reshape(3, -1),
                                         C2.reshape(3, -1)], axis=1))
    kw = {} if ladder == "K1" else {"ladder": vvvv_nt_reference}
    S = teom.sigma_block(thb, C, tH.L, torch.from_numpy(t2), NO, **kw)
    for k in range(3):
        s1 = teom.sigma1(thb, torch.from_numpy(C1[k]), torch.from_numpy(C2[k]),
                         tH.L, NO)
        s2 = teom.sigma2(thb, torch.from_numpy(C1[k]), torch.from_numpy(C2[k]),
                         tH.L, torch.from_numpy(t2), NO)
        ref = torch.cat([s1.reshape(-1), s2.reshape(-1)])
        assert (S[k] - ref).abs().max().item() < 1e-12


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _eom(basis, freeze_core):
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, basis, freeze_core=freeze_core),
                              device="cpu")
    _quiet(cc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    return pycc_tpu_torch.cceom(_quiet(pycc_tpu_torch.cchbar, cc))


@functools.lru_cache(maxsize=None)
def _dense_roots():
    A = _eom("sto-3g", False).dense_matrix()
    ev = np.linalg.eigvals(A)
    ev = np.sort(np.real(ev[np.abs(np.imag(ev)) < 1e-6]))
    return ev[ev > 1e-6][:3]


@pytest.mark.parametrize("guess", ["HBAR_SS", "CIS", "UNIT"])
def test_davidson_finds_the_dense_roots_sto3g(guess):
    E, C = _quiet(_eom("sto-3g", False).solve_eom, N=3, e_conv=1e-7,
                  guess=guess)
    assert np.allclose(E, _dense_roots(), atol=1e-5), (guess, E)
    assert isinstance(C, torch.Tensor) and C.shape[1] == 10 + 100


def _residual_norms(eom, C):
    """Per-root residual norms |sigma x - omega x| of the Ritz vectors of
    the subspace C, recomputed from C."""
    S = eom.sigma(C)
    G = (C @ S.T).numpy()
    w, a = np.linalg.eig(G)
    idx = np.real(w).argsort()[:3]
    a = torch.from_numpy(np.real(a[:, idx]).T.copy())
    r = a @ S - torch.from_numpy(np.real(w[idx]))[:, None] * (a @ C)
    return torch.linalg.norm(r, dim=1).numpy()


@pytest.mark.parametrize("freeze_core,ref", [
    (True, [0.246365746068, 0.313591867750, 0.354390071110]),
    (False, [0.246401542284, 0.313632702320, 0.354376313732]),
])
def test_eom_ccsd_ccpvdz_roots(freeze_core, ref):
    eom = _eom("cc-pvdz", freeze_core)
    E, C = _quiet(eom.solve_eom, N=3, e_conv=1e-9, r_conv=1e-7)
    assert eom.converged
    assert np.allclose(E, ref, atol=1e-7), E
    assert _residual_norms(eom, C).max() < 1e-6
    assert eom.ritz.shape == (3, C.shape[1])


def test_array_guess_and_collapse():
    eom = _eom("sto-3g", False)
    E0, _ = _quiet(eom.solve_eom, N=2, e_conv=1e-9, r_conv=1e-7)
    seeds = eom.ritz.numpy() + 1e-3
    E, _ = _quiet(eom.solve_eom, N=2, e_conv=1e-9, r_conv=1e-7,
                  guess=seeds, maxM=4)
    assert eom.converged
    assert np.allclose(E, E0, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _c2h4():
    """tests/test_021's C2H4/cc-pVDZ, frozen core: the converged CCSD
    energy and its EOM solver."""
    from pycc_tpu_torch.data import moldict
    cc = pycc_tpu_torch.ccwfn(run_rhf(moldict["C2H4"], "cc-pvdz",
                                      freeze_core=True), device="cpu")
    ecc = _quiet(cc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    return ecc, pycc_tpu_torch.cceom(_quiet(pycc_tpu_torch.cchbar, cc))


@pytest.mark.parametrize("guess", ["HBAR_SS", "CIS", "UNIT"])
def test_eom_ccsd_c2h4_fc_oracle(guess):
    """tests/test_021::test_eom_ccsd_c2h4_fc, one guess a case."""
    ecc, eom = _c2h4()
    assert abs(ecc - -0.305587255584445) < 1e-9
    E, _ = _quiet(eom.solve_eom, N=3, e_conv=1e-7, r_conv=1e-7, maxiter=75,
                  guess=guess)
    assert eom.converged, guess
    ref = np.array([0.324575036764, 0.328021971344, 0.334479736844])
    assert np.allclose(E, ref, atol=1e-6), (guess, E)


def _davidson_on(A, D, no, nv):
    """A cceom whose sigma is the product with the (dim, dim) matrix A and
    whose preconditioner is D: the Davidson alone, on a nonsymmetric
    matrix."""
    import types
    from pycc_tpu_torch.utils.timing import Timers
    eom = object.__new__(teom.cceom)
    eom.no, eom.nv = no, nv
    # A does not map pair-symmetric doubles to pair-symmetric ones
    eom.pair_symmetric = False
    eom.D = torch.tensor(D)
    eom.ccwfn = types.SimpleNamespace(timers=Timers())
    At = torch.tensor(A)
    eom.sigma = lambda C, ladder=None: C @ At.T
    return eom


@pytest.mark.parametrize("seed,coupling,spread,maxM", [
    (7, 0.05, 0.1, 3), (2, 0.05, 0.3, 4)])
def test_davidson_collapse_is_no_stall(seed, coupling, spread, maxM):
    """After a collapse the Ritz pairs are those of the collapsed
    subspace, so that iteration's dE = 0 and its unchanged residuals are
    no noise-floor stall: with a subspace small enough to collapse every
    other iteration, a slowly converging root must reach r_conv, not stop
    'converged' at a residual norm far above it (c8aca2a stopped these
    at 3.6e-2 and 2.0e-5)."""
    no, nv = 2, 3
    n = no * nv + (no * nv) ** 2
    rng = np.random.default_rng(seed)
    A = (np.diag(np.linspace(1.0, 3.0, n))
         + coupling * rng.standard_normal((n, n)))
    D = np.diag(A) + spread * rng.standard_normal(n)
    eom = _davidson_on(A, D, no, nv)
    with contextlib.redirect_stdout(io.StringIO()):
        E, _ = eom.solve_eom(N=1, e_conv=1e-8, r_conv=1e-8, maxM=maxM,
                             guess=np.eye(n)[:2], maxiter=300)
    x = eom.ritz
    r = torch.linalg.norm(eom.sigma(x) - torch.tensor(E)[:, None] * x).item()
    assert eom.converged and r < 1e-7
    assert abs(E[0] - np.sort(np.linalg.eigvals(A).real)[0]) < 1e-8


def test_davidson_does_not_stop_above_the_precision_floor():
    """(H2O)_2/cc-pVDZ, frozen core, 3 roots from the HBAR_SS guess: at
    iteration 8 a lower state replaces the third root, and the largest
    residual norm stays above its best (5.5e-3) for 6 iterations while that
    root converges.  The best-iterate exit took this for the working
    precision's floor, and f08c488 stopped at iteration 13 with residual
    norms near 5.5e-3 and a third root 1e-2 Eh too high.  That exit now
    takes only a plateau the precision explains, so the solve goes on to
    r_conv; its roots equal those of a subspace large enough never to
    collapse (maxM 200)."""
    from pycc_tpu_torch.data import moldict
    cc = pycc_tpu_torch.ccwfn(run_rhf(moldict["(H2O)_2"], "cc-pvdz",
                                      freeze_core=True), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(1e-10, 1e-10)
        hb = pycc_tpu_torch.cchbar(cc)
        roots = {}
        for maxM in (None, 200):
            eom = pycc_tpu_torch.cceom(hb)
            E, _ = eom.solve_eom(3, 1e-10, 1e-7, maxiter=200,
                                 guess="HBAR_SS", maxM=maxM)
            x = eom.ritz
            r = torch.linalg.norm(eom.sigma(x) - torch.tensor(E)[:, None] * x,
                                  dim=1)
            assert eom.converged and eom.residual_floor is None
            assert float(r.max()) <= 1e-7
            roots[maxM] = E
    assert np.abs(roots[None] - roots[200]).max() < 1e-8
    assert abs(roots[None][2] - 0.37773052) < 1e-6
