"""The port's (T) against pycc_tpu's: the plain row projections against the
Pallas kernel K2 (interpret mode), and the (T) drivers against pycc_tpu's
on the same synthetic inputs and on pycc_tpu's converged amplitudes."""

import contextlib
import functools
import io
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
from pycc_tpu import triples as jtr
from pycc_tpu.ops.kernels.triples import t_energy_row_pallas

from pycc_tpu_torch import triples as ttr
from pycc_tpu_torch.hamiltonian import Hamiltonian
from pycc_tpu_torch.ops.kernels.triples import (t_energy_row_reference,
                                                t_vikings_rows)

from .common import scf


@functools.lru_cache(maxsize=None)
def _inputs(no, nv, seed=7):
    """Slab-scan operands as numpy float64, built as in
    tests/test_012_infra.py: scale 0.02, orbital energies spread."""
    rng = np.random.default_rng(seed)
    mk = lambda sh: 0.02 * rng.standard_normal(sh)
    Wv_o = np.ascontiguousarray(mk((nv, nv, nv, no)).transpose(3, 0, 1, 2))
    Wo_t = np.ascontiguousarray(mk((no, nv, no, no)).transpose(2, 3, 0, 1))
    Ev, Eo = mk((nv, no, nv, nv)), mk((no, no, no, nv))
    L, Fov = mk((no, no, nv, nv)), mk((no, nv))
    eps = np.concatenate([np.linspace(-2.0, -0.5, no),
                          np.linspace(0.3, 3.0, nv)])
    t1, t2 = mk((no, nv)), mk((no, no, nv, nv))
    return Wv_o, Wo_t, Ev, Eo, L, Fov, eps, t1, t2


def _torch(arrays, dtype=torch.float64):
    return tuple(torch.tensor(x, dtype=dtype) for x in arrays)


SHAPES = [(4, 8), (3, 10)]


@pytest.mark.parametrize("no,nv", SHAPES)
def test_row_projections_match_the_pallas_kernel(no, nv):
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _inputs(no, nv)
    i = 1
    ref = t_energy_row_pallas(
        i, *(jnp.asarray(x, jnp.float32) for x in (Wv, Wo, Ev, Eo, L, Fov,
                                                   eps, t1, t2)),
        no, interpret=True)
    ref = [np.asarray(x, np.float64) for x in ref]
    ref[0], ref[1] = ref[0].sum(axis=2), ref[1].sum(axis=2)
    out = t_energy_row_reference(
        i, *_torch((Wv, Wo, Ev, Eo, L, Fov, eps, t2), torch.float32), no)
    names = ("X1a", "X1m", "Z1", "Z1m", "Z2a", "Z2m", "X2l")
    for name, r, o in zip(names, ref, out):
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        # f32 sums in another order: 1e-5 of the largest element
        assert np.abs(o.double().numpy() - r).max() < 1e-5 * np.abs(r).max(), name


@functools.lru_cache(maxsize=None)
def _pycc_tpu_scan(no, nv):
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _inputs(no, nv)
    return float(jtr.t_vikings_scan_core(Wv, Wo, Ev, Eo, L, Fov, eps,
                                         t1, t2, no))


def _port_driver(variant, no, ops, t1, t2):
    if variant == "rows":
        return t_vikings_rows(*ops, t1, t2, no)
    if variant == "sym_jc1":
        return ttr.t_vikings_scan_core(*ops, t1, t2, no, jc=1)
    if variant == "sym_jc_no":
        return ttr.t_vikings_scan_core(*ops, t1, t2, no, jc=no)
    return ttr.t_vikings_scan_core(*ops, t1, t2, no, sym=False)


@pytest.mark.parametrize("variant", ["rows", "sym_jc1", "sym_jc_no",
                                     "no_sym"])
@pytest.mark.parametrize("no,nv", SHAPES)
def test_drivers_match_pycc_tpu_scan_core(no, nv, variant):
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _torch(_inputs(no, nv))
    e = _port_driver(variant, no, (Wv, Wo, Ev, Eo, L, Fov, eps), t1, t2)
    assert torch.is_tensor(e) and e.dim() == 0 and e.dtype == torch.float64
    assert abs(float(e) - _pycc_tpu_scan(no, nv)) < 1e-12


def test_scan_core_refuses_what_it_does_not_take():
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _torch(_inputs(4, 8))
    with pytest.raises(ValueError, match="must divide"):
        ttr.t_vikings_scan_core(Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2, 4, jc=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttr.t_vikings_scan_core(Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2, 4,
                                slab_dtype=torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _synthetic(no, nv, seed=3):
    """A full-storage (F, ERI, L) with the ERI's 8-fold symmetry, and
    random amplitudes, as numpy float64."""
    rng = np.random.default_rng(seed)
    nact = no + nv
    eps = np.concatenate([np.linspace(-2.0, -0.5, no),
                          np.linspace(0.3, 3.0, nv)])
    F = np.diag(eps) + 5e-4 * rng.standard_normal((nact, nact))
    F = 0.5 * (F + F.T)
    A = 0.05 * rng.standard_normal((nact,) * 4)
    A = A + A.transpose(1, 0, 2, 3)
    A = A + A.transpose(0, 1, 3, 2)
    A = A + A.transpose(2, 3, 0, 1)
    ERI = np.ascontiguousarray(A.swapaxes(1, 2))
    L = 2.0 * ERI - ERI.swapaxes(2, 3)
    t1 = 0.02 * rng.standard_normal((no, nv))
    t2 = 0.02 * rng.standard_normal((no, no, nv, nv))
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    return F, ERI, L, t1, t2


def _port_cc(no, F, ERI, L, t1, t2):
    return SimpleNamespace(no=no, H=Hamiltonian.from_numpy(F, ERI, L, no,
                                                         device="cpu"),
                           t1=torch.tensor(t1), t2=torch.tensor(t2))


@pytest.mark.parametrize("driver", ["t_vikings", "t_vikings_scan"])
def test_full_tensor_and_scan_drivers_match_pycc_tpu(driver):
    no, nv = 3, 7
    F, ERI, L, t1, t2 = _synthetic(no, nv)
    H = SimpleNamespace(F=jnp.asarray(F), ERI=jnp.asarray(ERI),
                        L=jnp.asarray(L))
    ref = float(jtr.t_vikings(SimpleNamespace(no=no, H=H, t1=jnp.asarray(t1),
                                              t2=jnp.asarray(t2))))
    e = getattr(ttr, driver)(_port_cc(no, F, ERI, L, t1, t2))
    assert abs(float(e) - ref) < 1e-12


@pytest.mark.parametrize("no,nv,sym", [(4, 19, True), (24, 114, True),
                                       (24, 114, False), (7, 45, False)])
def test_scan_flops_match_pycc_tpu(no, nv, sym):
    assert ttr.t_scan_flops(no, nv, sym) == jtr.t_scan_flops(no, nv, sym)


@functools.lru_cache(maxsize=None)
def _h2o_ccsd_t():
    """pycc_tpu's converged H2O/cc-pVDZ CCSD amplitudes and Hamiltonian."""
    cc = pycc_tpu.ccwfn(scf("H2O", "cc-pvdz"), model="CCSD")
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-12, r_conv=1e-12, maxiter=100)
    return cc


@pytest.mark.parametrize("oracle", ["t_tjl", "t_vikings_scan"])
def test_weights_carried_across_give_pycc_tpus_triples(oracle):
    ref_cc = _h2o_ccsd_t()
    ref = float(getattr(jtr, oracle)(ref_cc))
    cc = _port_cc(ref_cc.no, *(np.asarray(x) for x in (
        ref_cc.H.F, ref_cc.H.ERI, ref_cc.H.L, ref_cc.t1, ref_cc.t2)))
    assert abs(float(ttr.t_vikings_scan(cc)) - ref) < 1e-12
    assert abs(ref - -0.003861236558801) < 1e-11
