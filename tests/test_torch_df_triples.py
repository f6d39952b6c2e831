"""The port's (T) from Cholesky/DF factors against its dense (T) and
pycc_tpu's factor-fed (T), on the CPU in f64: the factor-assembled slices
through the K2 row loop, the k-chunked variant, and
from_df_factors(model="CCSD(T)")."""

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
from pycc_tpu.models.dfccsd import df_blocks as jdf_blocks
from pycc_tpu.ops.cholesky import cholesky_factor_eri

import pycc_tpu_torch
from pycc_tpu_torch import triples as ttr
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models.dfccsd import df_blocks
from pycc_tpu_torch.ops.kernels.triples import t_energy_row
from pycc_tpu_torch.scf import run_rhf

from .common import H2O


@functools.lru_cache(maxsize=None)
def _setup():
    """H2O/STO-3G (fzc): near-exact factors, the dense ERI/L they rebuild,
    and arbitrary (non-symmetrized) amplitudes, numpy."""
    wfn = run_rhf(H2O, "sto-3g", freeze_core=True)
    H = build_hamiltonian(wfn, device="cpu")
    ERI = H.ERI.numpy()
    no = H.no
    nv = ERI.shape[0] - no
    B = cholesky_factor_eri(ERI, tol=1e-14)
    rec = np.einsum("Ppr,Pqs->pqrs", B, B)
    rng = np.random.default_rng(23)
    t1 = 0.05 * rng.standard_normal((no, nv))
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv))
    return wfn, H.F.numpy(), B, rec, t1, t2, no


def _df_cc(F, B, t1, t2, no):
    return SimpleNamespace(storage="df", no=no, t1=torch.tensor(t1),
                           t2=torch.tensor(t2),
                           H=SimpleNamespace(F=torch.tensor(F)),
                           dfb=df_blocks(torch.tensor(B), no))


@functools.lru_cache(maxsize=None)
def _port_df_scan():
    wfn, F, B, rec, t1, t2, no = _setup()
    launches = t_energy_row.launches
    e = ttr.t_vikings_scan(_df_cc(F, B, t1, t2, no))
    assert t_energy_row.launches == launches   # CPU tensors: plain rows
    return float(e)


def test_df_scan_equals_the_dense_scan():
    wfn, F, B, rec, t1, t2, no = _setup()
    L = 2.0 * rec - rec.swapaxes(2, 3)
    dense = SimpleNamespace(
        storage="full", no=no, t1=torch.tensor(t1), t2=torch.tensor(t2),
        H=SimpleNamespace(F=torch.tensor(F), ERI=torch.tensor(rec),
                          L=torch.tensor(L)))
    assert abs(float(ttr.t_vikings_scan(dense)) - _port_df_scan()) < 1e-11


def test_df_scan_equals_pycc_tpu():
    wfn, F, B, rec, t1, t2, no = _setup()
    ref = jtr.t_vikings_scan(SimpleNamespace(
        storage="df", no=no, t1=jnp.asarray(t1), t2=jnp.asarray(t2),
        H=SimpleNamespace(F=jnp.asarray(F)),
        dfb=jdf_blocks(jnp.asarray(B), no)))
    assert abs(float(ref) - _port_df_scan()) < 1e-12


def test_df_slices_equal_the_dense_slices():
    wfn, F, B, rec, t1, t2, no = _setup()
    dense = SimpleNamespace(no=no, H=SimpleNamespace(
        F=torch.tensor(F), ERI=torch.tensor(rec),
        L=torch.tensor(2.0 * rec - rec.swapaxes(2, 3))))
    Boo, Bov, Bvv = df_blocks(torch.tensor(B), no)
    for a, b in zip(ttr.t_scan_df_slices(torch.tensor(F), Boo, Bov, Bvv, no),
                    ttr.scan_slices(dense)):
        assert a.shape == b.shape and a.is_contiguous()
        assert (a - b).abs().max().item() < 1e-13


@pytest.mark.parametrize("kc", ["2", "no", "default"])
def test_chunked_equals_the_slice_scan(kc):
    wfn, F, B, rec, t1, t2, no = _setup()
    assert no % 2 == 0 and no > 2       # kc=2 must chunk
    kc = {"2": 2, "no": no, "default": None}[kc]
    cc = _df_cc(F, B, t1, t2, no)
    e = ttr.t_vikings_scan_df_chunked(cc.dfb, cc.H.F, cc.t1, cc.t2, no,
                                      kc=kc)
    assert torch.is_tensor(e) and e.dim() == 0
    assert abs(float(e) - _port_df_scan()) < 1e-12


def test_chunked_refuses_a_kc_that_does_not_divide_no():
    wfn, F, B, rec, t1, t2, no = _setup()
    cc = _df_cc(F, B, t1, t2, no)
    with pytest.raises(ValueError, match="must divide"):
        ttr.t_vikings_scan_df_chunked(cc.dfb, cc.H.F, cc.t1, cc.t2, no,
                                      kc=no - 1)


@pytest.mark.parametrize("no,nv", [(4, 19), (24, 216), (40, 360)])
def test_chunk_size_matches_pycc_tpu(no, nv):
    assert ttr._t_df_kc(no, nv) == jtr._t_df_kc(no, nv)


def test_from_df_factors_ccsd_t_matches_pycc_tpu():
    wfn, F, B, rec, t1, t2, no = _setup()
    with contextlib.redirect_stdout(io.StringIO()):
        ref = pycc_tpu.ccwfn.from_df_factors(B, F, no, model="CCSD(T)")
        e_ref = ref.solve_cc(e_conv=1e-11, r_conv=1e-11)
        cc = pycc_tpu_torch.ccwfn.from_df_factors(B, F, no, model="CCSD(T)",
                                                  device="cpu")
        e = cc.solve_cc(e_conv=1e-11, r_conv=1e-11)
    assert cc.converged
    assert abs(e - float(e_ref)) < 1e-10
    # exact factors: the dense CCSD(T) of the same molecule
    assert abs(e - (-0.070616830152761 - 0.000099957499645)) < 1e-9
