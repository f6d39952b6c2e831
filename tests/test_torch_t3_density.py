"""The port's (T) density and its two remaining (T) oracles against
pycc_tpu's on the synthetic inputs of test_torch_cchbar (1e-12), and the
CCSD(T) density oracles of tests/test_011 through the port on the CPU."""

import contextlib
import functools
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu import triples as jtri
from pycc_tpu_torch import triples as ttri
from pycc_tpu_torch.scf import run_rhf

from .test_torch_cchbar import NO, NV, gap, synthetic_inputs

KEYS = ("Doo_t3", "Dvv_t3", "Dov_t3", "Goovv", "Gooov", "Gvvvo", "S1", "S2")


def _ccs():
    """A pycc_tpu-side and a port-side stand-in ccwfn on the synthetic
    inputs (t1 scaled up, so that the disconnected slab counts)."""
    jH, tH, t1, t2, _, _ = synthetic_inputs()
    t1 = 5.0 * t1
    jcc = types.SimpleNamespace(no=NO, nv=NV, H=jH, t1=jnp.asarray(t1),
                                t2=jnp.asarray(t2))
    tcc = types.SimpleNamespace(no=NO, nv=NV, H=tH, t1=torch.from_numpy(t1),
                                t2=torch.from_numpy(t2))
    return jcc, tcc


@functools.lru_cache(maxsize=None)
def _reference():
    jcc, _ = _ccs()
    et = float(jtri.t3_density(jcc))
    return et, {k: np.asarray(getattr(jcc, k)) for k in KEYS}


@pytest.mark.parametrize("fn", ["t3_density", "t3_density_scan"])
def test_t3_density_outputs_match_pycc_tpu_full_tensor(fn):
    et, ref = _reference()
    _, tcc = _ccs()
    got = getattr(ttri, fn)(tcc)
    assert abs(got.item() - et) < 1e-12
    for k in KEYS:
        assert gap(ref[k], getattr(tcc, k)) < 1e-12, k


def test_t3_density_energy_follows_t3_scan():
    _, tcc = _ccs()
    tcc.t3_scan = True
    e_scan = ttri.t3_density_energy(tcc)
    tcc.t3_scan = False
    e_full = ttri.t3_density_energy(tcc)
    assert abs(e_scan.item() - e_full.item()) < 1e-14
    tcc.S1 = None
    S1, S2 = ttri.t3_lambda_sources(tcc)
    assert S1 is tcc.S1 and S2 is tcc.S2


def test_t3d_full_matches_pycc_tpu():
    jcc, tcc = _ccs()
    o, v = slice(0, NO), slice(NO, None)
    j = jtri.t3d_full(jcc.t1, jcc.t2, jcc.H.ERI[o, o, v, v], jcc.H.F, NO)
    t = ttri.t3d_full(tcc.t1, tcc.t2, tcc.H.ERI[o, o, v, v], tcc.H.F, NO)
    assert gap(j, t) < 1e-12


@pytest.mark.parametrize("fn", ["t_tjl", "t_vikings_inverted"])
def test_triples_oracles_match_pycc_tpu(fn):
    jcc, tcc = _ccs()
    j = float(getattr(jtri, fn)(jcc))
    t = getattr(ttri, fn)(tcc).item()
    assert abs(j - t) < 1e-12
    assert abs(t - ttri.t_vikings(tcc).item()) < 1e-12


GEOM = """
O 0.000000000000000   0.000000000000000   0.143225857166674
H 0.000000000000000  -1.638037301628121  -1.136549142277225
H 0.000000000000000   1.638037301628121  -1.136549142277225
symmetry c1
units bohr
"""


@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(GEOM, "sto-3g", freeze_core=False)


@pytest.mark.parametrize("t3_scan", [None, True])
def test_ccsd_t_density_oracles(t3_scan):
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu_torch.ccwfn(_wfn(), model="ccsd(t)",
                                  make_t3_density=True, t3_scan=t3_scan,
                                  device="cpu")
        ecc = cc.solve_cc(1e-12, 1e-12, 75, max_diis=0)
        eccsd = float(cc.cc_energy(cc.t1, cc.t2))
        # internal oracle: density-based (T) equals the Lee/Rendell energy
        assert abs((ecc - eccsd) - float(ttri.t_tjl(cc))) < 1e-14
        hbar = pycc_tpu_torch.cchbar(cc)
        lam = pycc_tpu_torch.cclambda(cc, hbar)
        lcc = lam.solve_lambda(1e-12, 1e-12, 75, max_diis=0)
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        dens.compute_energy()
    assert abs(lcc - -0.069084521221746) < 1e-11
    assert abs(dens.eone - 0.104463374777302) < 1e-11
    assert abs(dens.etwo - -0.175243393781829) < 1e-11
    # the CCSD(T) density energy is the CCSD(T) energy
    assert abs(dens.eone + dens.etwo - ecc) < 1e-12
