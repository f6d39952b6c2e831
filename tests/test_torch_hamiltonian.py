"""The port's Hamiltonian against pycc_tpu's, built from one SCF."""

import functools

import numpy as np
import torch

torch.set_num_threads(1)

import pycc_tpu.hamiltonian as jham
import pycc_tpu_torch.hamiltonian as tham

from .common import scf


@functools.lru_cache(maxsize=None)
def _pair():
    wfn = scf("H2O", "cc-pvdz")
    return jham.build_hamiltonian(wfn), tham.build_hamiltonian(wfn, device="cpu")


def _gap(a, b):
    return np.max(np.abs(np.asarray(a) - b.numpy()))


def test_f_eri_l_match_pycc_tpu():
    ref, port = _pair()
    assert port.no == ref.no
    for name in ("F", "ERI", "L"):
        assert getattr(port, name).dtype == torch.float64
        assert _gap(getattr(ref, name), getattr(port, name)) < 1e-12, name


def test_property_integrals_match_pycc_tpu():
    ref, port = _pair()
    for name in ("mu", "m", "p", "Q"):
        r, t = getattr(ref, name), getattr(port, name)
        assert len(r) == len(t) > 0
        assert max(_gap(a, b) for a, b in zip(r, t)) < 1e-12, name


def test_vvvv_block_is_contiguous_copy():
    _, port = _pair()
    v = port.v
    assert port.vvvv.is_contiguous()
    assert torch.equal(port.vvvv, port.ERI[v, v, v, v])
    assert port.vvvv is port.vvvv


def test_from_numpy_carries_arrays_and_casts():
    ref, _ = _pair()
    H = tham.Hamiltonian.from_numpy(ref.F, ref.ERI, ref.L, ref.no,
                                    device="cpu", dtype=torch.float32, mu=ref.mu, m=ref.m)
    assert H.ERI.dtype == torch.float32 and H.mu[0].dtype == torch.float32
    assert H.m[0].dtype == torch.complex128
    assert _gap(ref.ERI, H.ERI.double()) < 1e-6


def test_sp_casts_mu_and_q_as_pycc_tpu_does():
    import jax.numpy as jnp
    wfn = scf("H2O", "cc-pvdz")
    ref = jham.build_hamiltonian(wfn, dtype=jnp.float32)
    port = tham.build_hamiltonian(wfn, dtype=torch.float32, device="cpu")
    want = {"mu": torch.float32, "Q": torch.float32,
            "m": torch.complex128, "p": torch.complex128}
    for name, dtype in want.items():
        r, t = getattr(ref, name), getattr(port, name)
        assert {str(x.dtype) for x in r} == {str(dtype).replace("torch.", "")}
        assert {x.dtype for x in t} == {dtype}, name
        assert max(_gap(a, b) for a, b in zip(r, t)) < 1e-6, name


def test_from_df_factors_casts_mu_to_the_working_dtype():
    from pycc_tpu_torch import ccwfn
    rng = np.random.default_rng(5)
    no, nv, naux = 2, 4, 8
    n = no + nv
    B = 0.1 * rng.standard_normal((naux, n, n))
    B = 0.5 * (B + B.transpose(0, 2, 1))
    F = np.diag(np.concatenate([np.linspace(-1.0, -0.5, no),
                                np.linspace(0.3, 1.0, nv)]))
    mu = 0.1 * rng.standard_normal((3, n, n))
    for precision, dtype in (("SP", torch.float32), ("DP", torch.float64)):
        cc = ccwfn.from_df_factors(B, F, no, mu=mu, precision=precision,
                                   device="cpu")
        assert len(cc.H.mu) == 3
        assert all(m.dtype == dtype for m in cc.H.mu), precision
    assert ccwfn.from_df_factors(B, F, no, device="cpu").H.mu == ()


def test_hamiltonian_takes_the_eri_the_scf_kept(monkeypatch):
    """run_rhf keeps its AO ERI on the wavefunction and build_hamiltonian
    takes it: one integrals.eri call for the SCF and the Hamiltonian, and
    the same Hamiltonian, bit for bit, as one that computes it again."""
    from pycc_tpu_torch.scf import integrals as tints
    from pycc_tpu_torch.scf import run_rhf

    from .common import H2O
    calls = []
    eri = tints.eri

    def counted(basis):
        calls.append(basis)
        return eri(basis)
    monkeypatch.setattr(tints, "eri", counted)
    wfn = run_rhf(H2O, "cc-pvdz", freeze_core=True)
    kept = tham.build_hamiltonian(wfn, device="cpu")
    assert len(calls) == 1 and wfn.ERI_ao is not None
    wfn.ERI_ao = None
    fresh = tham.build_hamiltonian(wfn, device="cpu")
    assert len(calls) == 2
    for name in ("F", "ERI", "L"):
        assert torch.equal(getattr(kept, name), getattr(fresh, name)), name
    assert run_rhf(H2O, "sto-3g", df=True).ERI_ao is None
