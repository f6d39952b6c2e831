"""Real-time CC in the port (pycc_tpu_torch.rtcc, rt/integrators.py,
rt/lasers.py) against pycc_tpu's on the CPU.

The right-hand side f(t, y) of CCD, CC2, CCSD and CC3 on full and blocked
storage equals pycc_tpu's to 1e-12 at the converged state and at a state
perturbed by 0.01 (random + i random); the observables, integrators and
lasers equal pycc_tpu's; each right-hand side runs one ladder call on
each of its two complex ladders; and the reference suite's real-time
oracles (tests/test_008, test_013, test_015) hold through the port.
Checkpoints written by either package resume in the other.  A complex
value cast to a real dtype anywhere on these paths fails the test (torch
only warns on such a cast).
"""

import contextlib
import functools
import io
import math
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.rt.integrators as jint
import pycc_tpu.rt.lasers as jlas
import pycc_tpu_torch
import pycc_tpu_torch.rt.integrators as tint
import pycc_tpu_torch.rt.lasers as tlas
from pycc_tpu.scf import run_rhf as jrun_rhf
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O, H2_2, HE

pytestmark = pytest.mark.filterwarnings(
    "error:Casting complex values to real")

MOLS = {"He": HE, "H2O": H2O, "(H2)_2": H2_2}


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _port(mol, basis, model="CCSD", storage="full", freeze_core=False,
          conv=1e-13, real_time=False):
    """A converged port ccwfn, its Lambda and ccdensity on the CPU."""
    wfn = run_rhf(MOLS[mol], basis, freeze_core=freeze_core)
    cc = pycc_tpu_torch.ccwfn(wfn, model=model, storage=storage,
                              real_time=real_time, device="cpu")
    _quiet(cc.solve_cc, conv, conv, 200)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    _quiet(lam.solve_lambda, conv, conv)
    return cc, lam, _quiet(pycc_tpu_torch.ccdensity, cc, lam)


@functools.lru_cache(maxsize=None)
def _ref(mol, basis, model="CCSD", storage="full", freeze_core=False,
         conv=1e-13, real_time=False):
    """The same with pycc_tpu."""
    wfn = jrun_rhf(MOLS[mol], basis, freeze_core=freeze_core)
    kw = {"real_time": True} if real_time else {}
    cc = _quiet(pycc_tpu.ccwfn, wfn, model=model, storage=storage, **kw)
    _quiet(cc.solve_cc, conv, conv, 200)
    lam = pycc_tpu.cclambda(cc, _quiet(pycc_tpu.cchbar, cc))
    _quiet(lam.solve_lambda, conv, conv)
    return cc, lam, _quiet(pycc_tpu.ccdensity, cc, lam)


def _rts(key, V_args=(0.05, 0.0, 0.01, 0.05), magnetic=False, **kw):
    """(port rtcc, pycc_tpu rtcc, y0 as numpy) for one pipeline key; kw
    goes to the port's rtcc alone.  Blocked storage is held to pycc_tpu's
    full storage (its blocked right-hand side equals its full one to
    1e-14), which spares a second reference solve and compile."""
    tc, tl, td = _port(*key)
    jc, jl, jd = _ref(*(key[:3] + ("full",) + key[4:]))
    trt = pycc_tpu_torch.rtcc(tc, tl, td, tlas.gaussian_laser(*V_args),
                              magnetic=magnetic, **kw)
    jrt = pycc_tpu.rtcc(jc, jl, jd, jlas.gaussian_laser(*V_args),
                        magnetic=magnetic)
    y0 = np.asarray(jrt.collect_amps(jc.t1, jc.t2, jl.l1, jl.l2, 0)).astype(
        "complex128")
    return trt, jrt, y0


def _perturbed(y0, seed=11):
    rng = np.random.default_rng(seed)
    return y0 + 0.01 * (rng.standard_normal(y0.shape)
                        + 1j * rng.standard_normal(y0.shape))


# ---------------------------------------------------------------------------
# the right-hand side against pycc_tpu's
# ---------------------------------------------------------------------------

RHS_CASES = [(m, s, False) for s in ("full", "blocked")
             for m in ("CCD", "CC2", "CCSD", "CC3")] + [("CC3", "full", True)]


@pytest.mark.parametrize("model,storage,real_time", RHS_CASES,
                         ids=["%s-%s%s" % (m, s, "-real_time" if r else "")
                              for m, s, r in RHS_CASES])
def test_rhs_equals_pycc_tpu(model, storage, real_time):
    """H2O/STO-3G, frozen core: f(t, y) at the converged state and off it;
    a numpy y gives numpy back, a tensor y a tensor (the same numbers)."""
    key = ("H2O", "sto-3g", model, storage, True, 1e-12, real_time)
    trt, jrt, y0 = _rts(key)
    for y in (y0, _perturbed(y0)):
        ref = np.asarray(jrt.f(0.02, y))
        out = trt.f(0.02, y)
        assert isinstance(out, np.ndarray) and out.dtype == np.complex128
        assert np.abs(out - ref).max() < 1e-12
        out_t = trt.f(0.02, torch.from_numpy(y))
        assert isinstance(out_t, torch.Tensor)
        assert np.abs(out_t.numpy() - out).max() < 1e-14


@pytest.mark.parametrize("model,storage", [("CCSD", "full"),
                                           ("CC3", "full"),
                                           ("CCSD", "blocked")])
def test_observables_equal_pycc_tpu(model, storage):
    """The dipole (electric, and magnetic but for CC3, whose branch differs
    only in the integrals), Lagrangian, energy, phase and autocorrelation
    at a perturbed state, each a Python complex."""
    key = ("H2O", "sto-3g", model, storage, True, 1e-12)
    trt, jrt, y0 = _rts(key, magnetic=True)
    y = _perturbed(y0, seed=5)
    jt, tt = jrt.extract_amps(y), trt.extract_amps(torch.from_numpy(y))
    for mag in (False,) if model == "CC3" else (False, True):
        a = jrt.dipole(*jt[:4], magnetic=mag)
        b = trt.dipole(*tt[:4], magnetic=mag)
        assert all(isinstance(x, complex) for x in b)
        assert max(abs(p - q) for p, q in zip(a, b)) < 1e-12
    assert abs(jrt.lagrangian(0.03, *jt[:4])
               - trt.lagrangian(0.03, *tt[:4])) < 1e-11
    assert abs(jrt.energy(0.03, *jt[:2]) - trt.energy(0.03, *tt[:2])) < 1e-12
    F = np.asarray(jrt.ccwfn.H.F) + 0.01j
    assert abs(jrt.phase(F, *jt[:2]) - trt.phase(F, *tt[:2])) < 1e-11
    assert abs(jrt.autocorrelation(y0, y)
               - trt.autocorrelation(y0, torch.from_numpy(y))) < 1e-12


def test_amplitudes_collect_on_the_device_and_extract_as_given():
    trt, jrt, y0 = _rts(("H2O", "sto-3g", "CCSD", "full", True, 1e-12))
    cc, lam = trt.ccwfn, trt.cclambda
    y = trt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0.25)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.complex128
    assert y.device == cc.device
    assert np.abs(y.numpy()[:-1] - y0[:-1]).max() < 1e-12 and y[-1] == 0.25
    t1, t2, l1, l2, ph = trt.extract_amps(y0)
    assert isinstance(t2, np.ndarray) and t2.shape == tuple(cc.t2.shape)
    t1, t2, l1, l2, ph = trt.extract_amps(y)
    assert isinstance(l2, torch.Tensor) and l2.shape == cc.t2.shape


def _counting():
    calls = []

    def ladder(A, B, bf16=False):
        calls.append((tuple(A.shape), tuple(B.shape), A.dtype))
        return vvvv_nt_reference(A, B, bf16)
    return ladder, calls


@pytest.mark.parametrize("model,storage,n", [
    ("CCSD", "full", 2), ("CCD", "full", 2), ("CC3", "full", 2),
    ("CCSD", "blocked", 2), ("CC2", "full", 0)])
def test_each_complex_ladder_is_one_ladder_call(model, storage, n):
    """One right-hand side is one `ladder` call a ladder: the T side's
    complex tau on stacked rows (2 o^2, v^2) x (v^2, v^2), the Lambda
    side's complex l2 against the HBAR's stacked complex Hvvvv
    (2 o^2, v^2) x (2 v^2, v^2); CC2 has no ladder.  The result equals
    the default (K1) right-hand side's."""
    key = ("H2O", "sto-3g", model, storage, True, 1e-12)
    ladder, calls = _counting()
    trt, _, y0 = _rts(key, ladder=ladder)
    cc = trt.ccwfn
    y = _perturbed(y0, seed=3)
    out = trt.f(0.02, y)
    assert len(calls) == n
    o2, v2 = cc.no ** 2, cc.nv ** 2
    want = [((2 * o2, v2), (v2, v2), torch.float64),
            ((2 * o2, v2), (2 * v2, v2), torch.float64)]
    assert calls == want[:n]
    k1 = pycc_tpu_torch.rtcc(cc, trt.cclambda, None, trt.V).f(0.02, y)
    assert np.abs(out - k1).max() < 1e-13


def test_options_outside_the_slice_raise():
    """rtcc(ri_split=True) (pycc_tpu's real-pair amplitudes for a runtime
    without complex dtypes) and rhs_split=True (the split DF right-hand
    side) are not ported; the split's default (None) and False run."""
    cc, lam, dens = _port("He", "cc-pvdz")
    with pytest.raises(ValueError, match="ri_split"):
        pycc_tpu_torch.rtcc(cc, lam, dens, None, ri_split=True)
    with pytest.raises(ValueError, match="split DF residual"):
        pycc_tpu_torch.rtcc(cc, lam, dens, None, rhs_split=True)
    pycc_tpu_torch.rtcc(cc, lam, dens, None, rhs_split=False)


# ---------------------------------------------------------------------------
# lasers and integrators against pycc_tpu's
# ---------------------------------------------------------------------------

LASERS = [("gaussian_laser", (0.01, 0.3, 0.02), {"center": 0.05}),
          ("sine_square_laser", (1.0, 2.87, 5.0), {"phase": 0.1}),
          ("delta_pulse_laser", (1.0,), {"center": 0.2, "tol": 1e-7}),
          ("lrcw_laser", (0.5, 1.3, 2), {}),
          ("lrcw_laser", (0.5, 1.3, 0), {}),
          ("qrcw_laser", (0.5, 1.3, 2), {})]


@pytest.mark.parametrize("name,args,kw", LASERS,
                         ids=["%s-%d" % (n, i) for i, (n, _, _)
                              in enumerate(LASERS)])
def test_lasers_equal_pycc_tpu(name, args, kw):
    jV, tV = getattr(jlas, name)(*args, **kw), getattr(tlas, name)(*args, **kw)
    ts = np.concatenate([np.linspace(-1.0, 12.0, 301), [0.0, 0.2, 5.0]])
    for t in ts:
        a, b = float(jV(float(t))), tV(float(t))
        assert isinstance(b, float)
        assert abs(a - b) <= 1e-14 * max(1.0, abs(a))


def _ode():
    """dy/dt = -i (H y) cos(t) + 0.1 y^2 on a complex 3-vector, as numpy
    (pycc_tpu's integrators) and torch (the port's) functions."""
    rng = np.random.default_rng(2)
    H = rng.standard_normal((3, 3))
    H = H + H.T
    y0 = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    Ht = torch.from_numpy(H).to(torch.complex128)

    def fn(t, y):
        return -1j * (H @ y) * math.cos(t) + 0.1 * y * y

    def ft(t, y):
        return -1j * (Ht @ y) * math.cos(t) + 0.1 * y * y
    return fn, ft, y0


FIXED = ["euler", "midpoint", "heun", "rk2", "rk3", "rk4", "rk38", "gl4",
         "gl6"]
ADAPTIVE = ["hr", "fehlberg", "bs", "ck", "DOPRI5"]


@pytest.mark.parametrize("name", FIXED + ADAPTIVE)
def test_integrators_equal_pycc_tpu(name):
    """Each tableau, five steps: pycc_tpu's on numpy, the port's on a
    torch tensor (which stays a tensor) and on numpy; the adaptive pairs'
    used and next steps too."""
    fn, ft, y0 = _ode()
    adaptive = name in ADAPTIVE
    make = (lambda m: getattr(m, name)(maxiter=20, yconv=1e-8)) if adaptive \
        else (lambda m: getattr(m, name)(0.05))
    jode, tode = make(jint), make(tint)
    yj, yt, yn, t = y0, torch.from_numpy(y0), y0, 0.0
    hj = ht = hn = 0.05
    for _ in range(5):
        if adaptive:
            yj, hu, hj = jode(fn, t, yj, hj)
            yt, hu_t, ht = tode(ft, t, yt, ht)
            yn, _, hn = tode(fn, t, yn, hn)
            assert abs(hu - hu_t) < 1e-14 and abs(hj - ht) < 1e-14
        else:
            hu = jode.h
            yj, yt, yn = jode(fn, t, yj), tode(ft, t, yt), tode(fn, t, yn)
        t += hu
    assert isinstance(yt, torch.Tensor) and isinstance(yn, np.ndarray)
    assert np.abs(yt.numpy() - yj).max() < 1e-14
    assert np.abs(yn - yj).max() < 1e-14


def test_integrators_analytic_ode():
    """tests/test_008::test_integrators_analytic_ode through the port, on
    a tensor: dy/dx = 3x^2 y, y(0) = 1 -> y = exp(x^3)."""
    f = lambda x, y: 3 * x * x * y
    for ODE, tol in [(tint.rk2(0.01), 5e-4), (tint.rk3(0.01), 1e-6),
                     (tint.rk4(0.01), 1e-8), (tint.rk38(0.01), 1e-8),
                     (tint.gl4(0.01), 1e-8), (tint.gl6(0.01), 1e-8)]:
        y = torch.ones(1, dtype=torch.float64)
        x = 0.0
        for _ in range(100):
            y = ODE(f, x, y)
            x += ODE.h
        assert abs(y[0].item() - np.exp(1.0)) < tol, type(ODE).__name__


def test_adaptive_integrator_analytic_ode():
    """tests/test_008::test_adaptive_integrator_analytic_ode through the
    port."""
    f = lambda x, y: 3 * x * x * y
    ODE = tint.ck(maxiter=20, yconv=1e-10)
    x, y, h = 0.0, torch.ones(1, dtype=torch.float64), 0.01
    while x < 1.0 - 1e-12:
        h = min(h, 1.0 - x)
        y, h_used, h = ODE(f, x, y, h)
        x += h_used
    assert abs(y[0].item() - np.exp(1.0)) < 1e-6


def test_delta_pulse_laser():
    """tests/test_008::test_delta_pulse_laser through the port."""
    V = tlas.delta_pulse_laser(1.0, center=5)
    vals = np.array([float(V(float(t))) for t in range(20)])
    ref = np.zeros(20)
    ref[5] = 1.0
    assert np.allclose(vals, ref)


# ---------------------------------------------------------------------------
# the reference suite's real-time oracles, through the port on the CPU
# ---------------------------------------------------------------------------

def _rt(mol, basis, V, model="CCSD", **kw):
    cc, lam, dens = _port(mol, basis, model)
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, V, **kw)
    return rt, rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)


@functools.lru_cache(maxsize=None)
def _he_vode():
    """He/cc-pVDZ under the sine^2 pulse, scipy's vode to t = 1 at 1e-13
    (tests/test_008 and test_013 integrate the same trajectory)."""
    from scipy.integrate import complex_ode
    rt, y0 = _rt("He", "cc-pvdz", tlas.sine_square_laser(1.0, 2.87, 5.0))
    y0 = y0.numpy()
    ODE = complex_ode(rt.f).set_integrator("vode", atol=1e-13, rtol=1e-13)
    ODE.set_initial_value(y0, 0)
    while ODE.successful() and ODE.t < 1.0:
        y = ODE.integrate(ODE.t + 0.01)
    return rt, y0, y


def test_rtcc_he_scipy_vode():
    """tests/test_008::test_rtcc_he_scipy_vode."""
    rt, _, y = _he_vode()
    mu_z = rt.dipole(*rt.extract_amps(y)[:4])[2]
    assert abs(0.008400738202694 - mu_z.real) < 1e-10


def test_autocorrelation_he():
    """tests/test_013::test_autocorrelation_he."""
    rt, y0, y = _he_vode()
    A = rt.autocorrelation(y0, y)
    assert abs(A - (-0.967109840555436 + 0.250976568630115j)) < 1e-9


def test_rtcc_h2o_rk4():
    """tests/test_008::test_rtcc_h2o_rk4, y on the device (a tensor)."""
    rt, y = _rt("H2O", "cc-pvdz", tlas.gaussian_laser(0.01, 0, 0.01, 0.05))
    cc, lam = rt.ccwfn, rt.cclambda
    mu0_z = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)[2]
    assert abs(-0.07800691 - mu0_z.real) < 1e-6
    ODE = tint.rk4(0.01)
    t = 0.0
    while t < 0.1:
        y = ODE(rt.f, t, y)
        t += 0.01
    assert isinstance(y, torch.Tensor)
    mu_z = rt.dipole(*rt.extract_amps(y)[:4])[2]
    assert abs(-0.0780067603267549 - mu_z.real) < 1e-4


def _gauss():
    return tlas.gaussian_laser(0.01, 0, 0.01, 0.05)


def test_rtcc_checkpoint_restart(tmp_path, monkeypatch):
    """tests/test_008::test_rtcc_checkpoint_restart: a run to 0.05 with
    checkpoints, restarted from chk.pk to 0.1, ends where the straight run
    does; y is kept on the host in chk.pk."""
    monkeypatch.chdir(tmp_path)
    rt, y0 = _rt("He", "cc-pvdz", _gauss())
    ODE = tint.rk4(0.01)
    ret_full = rt.propagate(ODE, y0.clone(), 0.1, ti=0)
    rt.propagate(ODE, y0.clone(), 0.05, ti=0, chk=True, ofile="o.pk",
                 cfile="c.pk")
    with open("c.pk", "rb") as fh:
        chkp = pickle.load(fh)
    assert isinstance(chkp["y"], np.ndarray)
    ret2 = rt.propagate(ODE, chkp["y"], 0.1, ti=chkp["time"], chk=True,
                        ofile="o.pk", cfile="c.pk")
    k_full, k_re = sorted(ret_full)[-1], sorted(ret2)[-1]
    assert k_full == k_re
    for prop in ("ecc", "mu_z"):
        assert abs(ret_full[k_full][prop] - ret2[k_re][prop]) < 1e-12


@pytest.mark.parametrize("first", ["pycc_tpu", "port"])
def test_checkpoints_cross_packages(tmp_path, monkeypatch, first):
    """A propagate(chk=True) checkpoint of either package resumes in the
    other on the same trajectory: He/cc-pVDZ, rk4(0.01) to 0.05 in one
    package, from chk.pk to 0.1 in the other, against the first package's
    straight run to 0.1 (1e-12)."""
    monkeypatch.chdir(tmp_path)
    trt, y0t = _rt("He", "cc-pvdz", _gauss())
    jc, jl, jd = _ref("He", "cc-pvdz")
    jrt = pycc_tpu.rtcc(jc, jl, jd, jlas.gaussian_laser(0.01, 0, 0.01, 0.05))
    y0 = np.asarray(jrt.collect_amps(jc.t1, jc.t2, jl.l1, jl.l2, 0)).astype(
        "complex128")
    assert np.abs(y0 - y0t.numpy()).max() < 1e-11
    A, An, B, Bn = ((jrt, jint, trt, tint) if first == "pycc_tpu"
                    else (trt, tint, jrt, jint))
    ret_full = _quiet(A.propagate, An.rk4(0.01), y0.copy(), 0.1, ti=0)
    _quiet(A.propagate, An.rk4(0.01), y0.copy(), 0.05, ti=0, chk=True)
    with open("chk.pk", "rb") as fh:
        chkp = pickle.load(fh)
    ret = _quiet(B.propagate, Bn.rk4(0.01), chkp["y"], 0.1,
                 ti=chkp["time"], chk=True)
    with open("output.pk", "rb") as fh:
        out = pickle.load(fh)
    key = sorted(ret_full)[-1]
    assert sorted(ret) == sorted(ret_full) == sorted(out)
    for prop in ("ecc", "mu_x", "mu_y", "mu_z"):
        assert abs(complex(ret_full[key][prop]) - complex(ret[key][prop])) \
            < 1e-12


def test_autocorrelation_identity():
    """tests/test_008::test_autocorrelation_identity."""
    rt, y0 = _rt("He", "cc-pvdz", _gauss())
    assert abs(rt.autocorrelation(y0, y0) - 1.0) < 1e-12


def test_mixed_step_integration():
    """tests/test_008::test_mixed_step_integration."""
    V = _gauss()
    rt, y0 = _rt("He", "cc-pvdz", V)
    h_small, h_big, e_field = 0.005, 0.02, 1e-5
    y, t = y0.clone(), 0.0
    while t < 0.2 - 1e-12:
        if float(V(t)) > e_field:
            y = tint.rk4(h_small)(rt.f, t, y)
            t += h_small
        else:
            y = tint.rk4(h_big)(rt.f, t, y)
            t += h_big
    mu_mixed = rt.dipole(*rt.extract_amps(y)[:4])[2].real
    y, t = y0.clone(), 0.0
    while t < 0.2 - 1e-12:
        y = tint.rk4(h_small)(rt.f, t, y)
        t += h_small
    mu_fine = rt.dipole(*rt.extract_amps(y)[:4])[2].real
    assert abs(mu_mixed - mu_fine) < 1e-5


def test_rtcc_cc2_smoke():
    """tests/test_008::test_rtcc_cc2_smoke."""
    rt, y = _rt("He", "cc-pvdz", _gauss(), model="CC2")
    ODE = tint.rk4(0.01)
    t = 0.0
    while t < 0.05:
        y = ODE(rt.f, t, y)
        t += 0.01
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu = rt.dipole(t1, t2, l1, l2)
    ecc = rt.lagrangian(t, t1, t2, l1, l2)
    assert np.isfinite(ecc.real)
    assert all(np.isfinite(m.real) for m in mu)


def test_field_plumbing():
    """tests/test_013::test_field_plumbing."""
    cc, lam, dens = _port("(H2)_2", "6-31g")
    V = tlas.gaussian_laser(0.01, 0, 0.01, center=0.05)
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, V, magnetic=True)
    ref_mu_tot = sum(m.numpy() for m in cc.H.mu) / np.sqrt(3.0)
    assert np.allclose(ref_mu_tot, rt.mu_tot.numpy())
    rt2 = pycc_tpu_torch.rtcc(cc, lam, dens, V, magnetic=True, kick="Y")
    assert np.allclose(cc.H.mu[1].numpy(), rt2.mu_tot.numpy())


def test_correlated_dipoles_h2_dimer():
    """tests/test_015::test_correlated_dipoles_h2_dimer."""
    cc, lam, dens = _port("(H2)_2", "cc-pvdz")
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, None, magnetic=True)
    ecc = cc.cc_energy(cc.t1, cc.t2)
    t1, t2, l1, l2, _ = rt.extract_amps(
        rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, ecc))
    ref_mu = np.array([0.0, 0.0, -0.0007395036977002])
    mu = rt.dipole(t1, t2, l1, l2)
    for ax in range(3):
        assert abs(ref_mu[ax] - mu[ax]) < 1e-10
    ref_m = np.array([0.0, 0.0, -2.3037968376087573e-5])
    m = rt.dipole(t1, t2, l1, l2, magnetic=True)
    for ax in range(3):
        assert abs(ref_m[ax] * 1.0j - m[ax]) < 1e-10


def test_rtcc_magnetic_integrals_h2_dimer():
    """tests/test_015::test_rtcc_magnetic_integrals_h2_dimer."""
    cc, lam, dens = _port("(H2)_2", "cc-pvdz")
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, None, magnetic=True)
    for ax in range(3):
        m = rt.m[ax].numpy()
        assert np.allclose(cc.H.m[ax].numpy(), m)
        assert np.abs(m.real).max() < 1e-14
        assert np.abs(m + m.swapaxes(0, 1)).max() < 1e-12


def test_sp_right_hand_side_is_complex64():
    """precision='SP': collect_amps gives complex64, the right-hand side
    stays complex64 (K1's f32 mode for the stacked operands on the card)
    and agrees with the DP one at the float32 level."""
    wfn = run_rhf(H2O, "sto-3g", freeze_core=True)
    rts = {}
    for prec in ("DP", "SP"):
        cc = pycc_tpu_torch.ccwfn(wfn, precision=prec, device="cpu")
        _quiet(cc.solve_cc, 1e-7, 1e-7)
        lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
        _quiet(lam.solve_lambda, 1e-7, 1e-7)
        rt = pycc_tpu_torch.rtcc(cc, lam, None, _gauss())
        rts[prec] = rt, rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    (rt64, y64), (rt32, y32) = rts["DP"], rts["SP"]
    assert y32.dtype == torch.complex64
    f32 = rt32.f(0.02, y32)
    assert f32.dtype == torch.complex64
    f64 = rt64.f(0.02, y32.to(torch.complex128))
    assert (f32 - f64).abs().max() / f64.abs().max() < 1e-5
    y = tint.rk4(0.01)(rt32.f, 0.0, y32)
    assert y.dtype == torch.complex64
    mu = rt32.dipole(*rt32.extract_amps(y)[:4])
    assert all(np.isfinite(m.real) for m in mu)


def test_cc3_slab_forms_equal_the_full_tensor_forms():
    """CC3's right-hand side, dipole and Lagrangian through the slab forms
    (ccwfn(t3_scan=True): the residual, Lambda's extras and the one-pdm
    one (i, j) slab at a time, what (H2O)_4 and larger take) equal the
    full-tensor forms' under complex amplitudes and a field."""
    wfn = run_rhf(H2O, "sto-3g", freeze_core=True)
    out = {}
    for scan in (False, True):
        cc = pycc_tpu_torch.ccwfn(wfn, model="CC3", t3_scan=scan,
                                  device="cpu")
        _quiet(cc.solve_cc, 1e-10, 1e-10)
        lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
        _quiet(lam.solve_lambda, 1e-10, 1e-10)
        rt = pycc_tpu_torch.rtcc(cc, lam, None,
                                 tlas.gaussian_laser(0.05, 0.0, 0.01, 0.05))
        assert rt._slabs is scan
        if not scan:
            y = torch.from_numpy(_perturbed(
                rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).numpy()))
        amps = rt.extract_amps(y)[:4]
        out[scan] = (rt.f(0.02, y), rt.dipole(*amps),
                     rt.lagrangian(0.02, *amps))
    assert (out[True][0] - out[False][0]).abs().max() < 1e-12
    assert max(abs(a - b) for a, b in zip(out[True][1], out[False][1])) \
        < 1e-12
    assert abs(out[True][2] - out[False][2]) < 1e-11
