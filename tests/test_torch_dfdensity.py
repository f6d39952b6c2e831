"""The port's density energy and (T) density over Cholesky/DF factors
(models/dfdensity.py, triples.t3_density_scan under storage='df') against
pycc_tpu's on the CPU in float64, on tests/test_024's inputs: H2O/STO-3G
factors at tol 1e-14 and random t1, t2, l1, l2.  Each term agrees with
pycc_tpu and the whole energy with the port's dense ccdensity on the
factor-rebuilt ERI to 1e-11; the (T)-density slab scan over factors
agrees with pycc_tpu's to 1e-12; test_024's CCSD(T) oracles run through
the port over factors (1e-9)."""

import functools
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.triples
import pycc_tpu_torch
from pycc_tpu.models import dfdensity as jdd
from pycc_tpu.models.dfccsd import df_blocks as jdf_blocks
from pycc_tpu.ops.cholesky import cholesky_factor_eri
from pycc_tpu_torch import triples as ttriples
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models import dfdensity as tdd
from pycc_tpu_torch.models.dfccsd import df_blocks as tdf_blocks
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

from .common import H2O
from .test_torch_dfhbar import _quiet, gap

jtriples = sys.modules["pycc_tpu.triples"]
MODELS = ["CCD", "CC2", "CCSD"]

# the all-electron H2O/STO-3G of tests/test_011 and test_024 (bohr)
GEOM_T = """
O 0.000000000000000   0.000000000000000   0.143225857166674
H 0.000000000000000  -1.638037301628121  -1.136549142277225
H 0.000000000000000   1.638037301628121  -1.136549142277225
symmetry c1
units bohr
"""


@functools.lru_cache(maxsize=None)
def setup():
    """test_024's inputs in both packages, and the port's dense ERI."""
    H = build_hamiltonian(run_rhf(H2O, "sto-3g", freeze_core=True),
                          device="cpu")
    no = H.no
    nact = H.F.shape[0]
    nv = nact - no
    B = np.asarray(cholesky_factor_eri(H.ERI.numpy(), tol=1e-14))
    rng = np.random.default_rng(24)
    amps = [0.05 * rng.standard_normal(s) for s in
            ((no, nv), (no, no, nv, nv), (no, nv), (no, no, nv, nv))]
    F = H.F.numpy()
    jin = (jnp.asarray(F), jdf_blocks(jnp.asarray(B), no),
           *map(jnp.asarray, amps))
    tin = (torch.tensor(F), tdf_blocks(torch.tensor(B), no),
           *map(torch.tensor, amps))
    return no, nact, jin, tin, torch.tensor(np.einsum("Ppr,Pqs->pqrs", B, B))


def _counting():
    calls = []

    def ladder(A, B):
        calls.append(B.shape)
        return vvvv_nt_reference(A, B)
    return ladder, calls


@pytest.mark.parametrize("model", MODELS)
def test_vvvv_and_vvvo_energy_terms_match_pycc_tpu(model):
    no, _, (_, jdf, jt1, jt2, jl1, jl2), (_, tdf, tt1, tt2, tl1, tl2), _ = \
        setup()
    ladder, calls = _counting()
    assert gap(jdd._evvvv_df(model, jdf, jt1, jt2, jl2),
               tdd._evvvv_df(model, tdf, tt1, tt2, tl2, ladder=ladder)) < 1e-12
    assert gap(jdd._evvvo_df(model, jdf, jt1, jt2, jl1, jl2),
               tdd._evvvo_df(model, tdf, tt1, tt2, tl1, tl2,
                             ladder=ladder)) < 1e-12
    # one ladder for Dvvvv and one for Dvvvo's t1-dressed term, one call
    # an a-block (a single block at this size); CC2 has neither
    assert len(calls) == {"CCD": 1, "CC2": 0, "CCSD": 2}[model]


def test_vvvo_extra_energy_matches_pycc_tpu():
    no, nact, (_, jdf, *_), (_, tdf, *_), _ = setup()
    G = np.random.default_rng(3).standard_normal((nact - no,) * 3 + (no,))
    assert gap(jdd._evvvo_extra_df(jdf, jnp.asarray(G)),
               tdd._evvvo_extra_df(tdf, torch.tensor(G))) < 1e-12


@pytest.mark.parametrize("model", MODELS)
def test_density_energy_df_matches_pycc_tpu_and_dense(model):
    """density_energy_df against pycc_tpu's, and the port's ccdensity over
    factors against its dense ccdensity on the factor-rebuilt ERI."""
    no, nact, jin, tin, ERI = setup()
    jF, jdf, jt1, jt2, jl1, jl2 = jin
    tF, tdf, tt1, tt2, tl1, tl2 = tin
    ref = jdd.density_energy_df(jF, jdf, jt1, jt2, jl1, jl2, no, model=model)
    out = tdd.density_energy_df(tF, tdf, tt1, tt2, tl1, tl2, no, model=model)
    for a, b in zip(ref, out):
        assert gap(a, b) < 1e-12
    lam = types.SimpleNamespace(l1=tl1, l2=tl2)
    common = dict(model=model, t1=tt1, t2=tt2, no=no, nact=nact,
                  o=slice(0, no), v=slice(no, nact))
    dense = pycc_tpu_torch.ccdensity(types.SimpleNamespace(
        storage="full", H=types.SimpleNamespace(F=tF, ERI=ERI), **common),
        lam)
    df = pycc_tpu_torch.ccdensity(types.SimpleNamespace(
        storage="df", dfb=tdf, H=types.SimpleNamespace(F=tF, ERI=None),
        **common), lam)
    assert not hasattr(df, "Dvvvv") and not hasattr(df, "Dvvvo")
    assert abs(dense.compute_energy() - df.compute_energy()) < 1e-11
    assert abs(dense.eone - df.eone) < 1e-12


def test_t3_density_scan_over_factors_matches_pycc_tpu():
    """The nine (T)-density outputs from factor-assembled slices."""
    no, _, (jF, jdf, jt1, jt2, *_), (tF, tdf, tt1, tt2, *_), _ = setup()
    jcc = types.SimpleNamespace(storage="df", no=no, t1=jt1, t2=jt2,
                                dfb=jdf, H=types.SimpleNamespace(F=jF))
    tcc = types.SimpleNamespace(storage="df", no=no, t1=tt1, t2=tt2,
                                dfb=tdf, H=types.SimpleNamespace(F=tF))
    assert gap(jtriples.t3_density_scan(jcc), ttriples.t3_density_scan(tcc)) \
        < 1e-12
    for name in ("Doo_t3", "Dvv_t3", "Dov_t3", "Goovv", "Gooov", "Gvvvo",
                 "S1", "S2"):
        assert gap(getattr(jcc, name), getattr(tcc, name)) < 1e-12, name
    with pytest.raises(ValueError, match="t3_density_scan"):
        ttriples.t3_density(tcc)


@functools.lru_cache(maxsize=None)
def _ccsd_t_density(route):
    """test_024's CCSD(T) density chain through the port over factors:
    from prepared factors (as test_024) or from an SCF with
    ccwfn(storage="df", make_t3_density=True)."""
    wfn = run_rhf(GEOM_T, "sto-3g", freeze_core=False)
    if route == "factors":
        H = build_hamiltonian(wfn, device="cpu")
        B = cholesky_factor_eri(H.ERI.numpy(), tol=1e-14)
        cc = pycc_tpu_torch.ccwfn.from_df_factors(np.asarray(B), H.F.numpy(),
                                                  H.no, model="CCSD(T)",
                                                  device="cpu")
        cc.make_t3_density = True
    else:
        cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", storage="df",
                                  df_tol=1e-13, make_t3_density=True,
                                  device="cpu")
    _quiet(cc.solve_cc, 1e-12, 1e-12, 75, max_diis=0)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    lcc = _quiet(lam.solve_lambda, 1e-12, 1e-12, 75, max_diis=0)
    dens = pycc_tpu_torch.ccdensity(cc, lam)
    _quiet(dens.compute_energy)
    return cc, lcc, dens


@pytest.mark.parametrize("route", ["factors", "scf"])
def test_ccsd_t_density_df_oracles(route):
    cc, lcc, dens = _ccsd_t_density(route)
    assert cc.converged and cc.storage == "df" and cc.Gvvvo is not None
    assert abs(lcc - -0.069084521221746) < 1e-9
    assert abs(dens.eone - 0.104463374777302) < 1e-9
    assert abs(dens.etwo - -0.175243393781829) < 1e-9


def test_density_energy_of_a_converged_df_ccsd_is_ecorr():
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, "sto-3g", freeze_core=True),
                              storage="df", df_tol=1e-13, device="cpu")
    ecc = _quiet(cc.solve_cc, e_conv=1e-12, r_conv=1e-12)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    _quiet(lam.solve_lambda, e_conv=1e-12, r_conv=1e-12)
    dens = pycc_tpu_torch.ccdensity(cc, lam)
    assert abs(_quiet(dens.compute_energy) - ecc) < 1e-12
