"""Local real-time CC through the port: tests/test_013's frozen
trajectories (`test_rt_pno`, `test_rt_pao`: H2O/cc-pVDZ, a filter-path
CCSD, 25 rk4(0.02) steps under a Gaussian pulse) at 1e-8, with the T and
Lambda residuals of every right-hand side projected onto the pair spaces
(`Local.filter_res`) and both complex ladders still run once a
right-hand side; and the filtered right-hand side f(t, y) equals
pycc_tpu's at 1e-12, at the converged state and off it."""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.rt.lasers as jlas
import pycc_tpu_torch
from pycc_tpu_torch.rt.integrators import rk4
from pycc_tpu_torch.rt.lasers import gaussian_laser

from .common import scf

pytestmark = pytest.mark.filterwarnings(
    "error:Casting complex values to real")

# tests/test_013_rt_local_props.py
FROZEN = {
    ("PNO", 1e-5): {"ecc": -84.21331867940133,
                    "mu_x": -5.106207671158796e-05,
                    "mu_y": -5.001503722097678e-05,
                    "mu_z": -0.06905411053873889},
    ("PAO", 1e-2): {"ecc": -84.21540972040579,
                    "mu_x": -4.987717148832141e-05,
                    "mu_y": -4.707786986481166e-05,
                    "mu_z": -0.0783037960868978},
}


@functools.lru_cache(maxsize=None)
def _pipeline(pkg, local, cutoff):
    """A converged filter-path ccwfn of pkg (pycc_tpu_torch on the CPU,
    or pycc_tpu), its Lambda and ccdensity, as test_013 builds them."""
    wfn = scf("H2O", "cc-pvdz", freeze_core=False)
    kw = {"device": "cpu"} if pkg is pycc_tpu_torch else {}
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pkg.ccwfn(wfn, local=local, local_cutoff=cutoff, filter=True,
                       **kw)
        cc.solve_cc(1e-13, 1e-13, 200)
        lam = pkg.cclambda(cc, pkg.cchbar(cc))
        lam.solve_lambda(1e-13, 1e-13)
        dens = pkg.ccdensity(cc, lam)
    return cc, lam, dens


@pytest.mark.parametrize("local,cutoff", list(FROZEN))
def test_rhs_equals_pycc_tpu(local, cutoff):
    """The port's filtered complex right-hand side against pycc_tpu's
    (its complex path, ri_split=False) on the same y: pycc_tpu's
    converged state and that state perturbed by 0.01 (random + i
    random).  Both packages localize and build the pair spaces with the
    same host numpy, so y means the same orbitals in both; the filter
    Q L (.) L^T Q^T does not depend on the spaces' signs."""
    tc, tl, td = _pipeline(pycc_tpu_torch, local, cutoff)
    jc, jl, jd = _pipeline(pycc_tpu, local, cutoff)
    assert np.array_equal(np.asarray(jc.C), tc.C)
    V = (0.001, 0, 0.01)
    trt = pycc_tpu_torch.rtcc(tc, tl, td, gaussian_laser(*V, center=0.05))
    jrt = pycc_tpu.rtcc(jc, jl, jd, jlas.gaussian_laser(*V, center=0.05),
                        ri_split=False)
    y0 = np.asarray(jrt.collect_amps(jc.t1, jc.t2, jl.l1, jl.l2, 0)).astype(
        "complex128")
    rng = np.random.default_rng(5)
    y1 = y0 + 0.01 * (rng.standard_normal(y0.shape)
                      + 1j * rng.standard_normal(y0.shape))
    for y in (y0, y1):
        ref = np.asarray(jrt.f(0.05, y))
        out = trt.f(0.05, y)
        assert out.dtype == np.complex128
        assert np.abs(out - ref).max() < 1e-12


@pytest.mark.parametrize("local,cutoff", list(FROZEN))
def test_013_rt_local(local, cutoff):
    cc, lam, dens = _pipeline(pycc_tpu_torch, local, cutoff)
    calls = []

    def ladder(A, B):
        calls.append(1)
        return A @ B.T

    rt = pycc_tpu_torch.rtcc(cc, lam, dens,
                             gaussian_laser(0.001, 0, 0.01, center=0.05),
                             ladder=ladder)
    nrhs = []
    f = rt.f
    rt.f = lambda t, y: nrhs.append(1) or f(t, y)
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    with contextlib.redirect_stdout(io.StringIO()):
        ret = rt.propagate(rk4(0.02), y0, 0.5, ti=0)
    r = ret["0.50"]
    for k, v in FROZEN[local, cutoff].items():
        assert abs(complex(r[k]).real - v) < 1e-8, k
    assert len(nrhs) == 4 * 25 and len(calls) == 2 * len(nrhs)
    # the right-hand side stays in the pair spaces
    dy = rt.f(0.1, rt.y)
    t1, t2, l1, l2 = rt._split(dy)
    for r1, r2 in ((t1, t2), (l1, l2)):
        p1, p2 = cc.Local.filter_res(r1, r2)
        assert (p1 - r1).abs().max() < 1e-12
        assert (p2 - r2).abs().max() < 1e-12
