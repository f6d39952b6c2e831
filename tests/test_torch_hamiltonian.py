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
