"""The port's spectral utilities (pycc_tpu_torch/rt/utils.py, its own
numpy/scipy copy) against pycc_tpu's on the same inputs (1e-14), and
tests/test_014's analytic oracles through the port."""

import numpy as np
import pytest

import pycc_tpu.rt.utils as jutils
import pycc_tpu_torch.rt.utils as tutils
from pycc_tpu_torch.rt.utils import FT, FWHM, Pade, damp, denoise


def _signal(n=2001, dt=0.05, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    return (np.cos(2.0 * t) * np.exp(-t / 40.0)
            + 0.3 * np.sin(3.1 * t) + 0.01 * rng.standard_normal(n)), dt


def _close(a, b, tol=1e-14):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("norm,n", [(False, None), (True, None),
                                    (False, 4096)])
def test_ft_equals_pycc_tpu(norm, n):
    sig, dt = _signal()
    for a, b in zip(jutils.FT(sig, dt=dt, norm=norm, n=n),
                    FT(sig, dt=dt, norm=norm, n=n)):
        _close(a, b)


@pytest.mark.parametrize("complex_signal", [False, True])
def test_denoise_damp_fwhm_equal_pycc_tpu(complex_signal):
    sig, dt = _signal()
    if complex_signal:
        sig = sig + 0.5j * np.roll(sig, 7)
    _close(jutils.denoise(sig, 0.5, dt), denoise(sig, 0.5, dt))
    _close(jutils.damp(sig, dt, 20.0), damp(sig, dt, 20.0))
    spec = np.fft.fft(sig)
    _close(jutils.FWHM(spec, dt), FWHM(spec, dt))


@pytest.mark.parametrize("toeplitz", [True, False])
@pytest.mark.parametrize("n", [201, 200])
def test_pade_equals_pycc_tpu(toeplitz, n):
    """Both solvers, an odd and an even sample count (the even one drops
    its last sample with a warning in both)."""
    sig, dt = _signal(n)
    with pytest.warns(UserWarning) if n % 2 == 0 else _nothing():
        jp = jutils.Pade(sig, dt=dt)
    with pytest.warns(UserWarning) if n % 2 == 0 else _nothing():
        tp = Pade(sig, dt=dt)
    jp.build(toeplitz_solver=toeplitz)
    tp.build(toeplitz_solver=toeplitz)
    _close(jp.a, tp.a)
    _close(jp.b, tp.b)
    o = np.linspace(0.5, 4.0, 97)
    for norm in (False, True):
        _close(jp.approx(o, norm=norm), tp.approx(o, norm=norm))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_utils_import_nothing_of_pycc_tpu():
    import inspect
    src = inspect.getsource(tutils)
    assert "import pycc_tpu" not in src and "from pycc_tpu" not in src
    assert "jax" not in src.split('"""', 2)[2]


# tests/test_014's analytic oracles, through the port

def test_ft_peak_location():
    dt, w0 = 0.05, 2.0
    t = np.arange(4000) * dt
    freq, spec = FT(np.cos(w0 * t), dt=dt)
    assert abs(freq[np.argmax(np.abs(spec))] - w0) < 0.05


def test_pade_peak_location():
    dt, w0 = 0.05, 2.0
    t = np.arange(2001) * dt
    p = Pade(np.cos(w0 * t) * np.exp(-t / 50.0), dt=dt)
    p.build()
    o = np.linspace(0.5, 4.0, 700)
    assert abs(o[np.argmax(np.abs(p.approx(o)))] - w0) < 0.02


def test_pade_solvers_agree():
    sig = np.random.default_rng(0).standard_normal(101)
    p1, p2 = Pade(sig, dt=0.1), Pade(sig, dt=0.1)
    p1.build(toeplitz_solver=True)
    p2.build(toeplitz_solver=False)
    o = np.linspace(0, 5, 50)
    assert np.allclose(p1.approx(o), p2.approx(o), rtol=1e-6, atol=1e-8)


def test_denoise_removes_noise():
    dt, n = 0.05, 2000
    t = np.arange(n) * dt
    clean = np.cos(2 * np.pi * 32 / (n * dt) * t)
    noisy = clean + 0.01 * np.random.default_rng(1).standard_normal(n)
    out = denoise(noisy, filter_level=1.0, timestep=dt)
    assert np.mean((out - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_damp():
    out = damp(np.ones(100), 0.1, 5.0)
    assert np.allclose(out, np.exp(-np.arange(100) * 0.1 / 5.0))


def test_fwhm_positive():
    dt = 0.05
    t = np.arange(4000) * dt
    sig = np.cos(2.0 * t) * np.exp(-t / 10.0)
    assert FWHM(np.abs(np.fft.fft(sig)), dt) > 0
