"""The port's density blocks against pycc_tpu's on the synthetic inputs of
test_torch_cchbar (1e-12), and the density energy of tests/test_005
through the port on the CPU (equal to Ecorr at 1e-12)."""

import contextlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.ccdensity
import pycc_tpu_torch
import pycc_tpu_torch.ccdensity

from .test_torch_cchbar import MODELS, NO, NV, gap, synthetic_inputs
from .test_torch_cclambda import _port_lambda

# the packages export the solver classes under the module names
jden = sys.modules["pycc_tpu.ccdensity"]
tden = sys.modules["pycc_tpu_torch.ccdensity"]

# block function: the arguments it takes after the model, of (t1, t2, l1,
# l2)
FUNCTIONS = {
    "build_Doo": "t1 t2 l1 l2", "build_Dvv": "t1 t2 l1 l2",
    "build_Dov": "t1 t2 l1 l2", "build_Doooo": "t1 t2 l2",
    "build_Dvvvv": "t1 t2 l2", "build_Dooov": "t1 t2 l1 l2",
    "build_Dvvvo": "t1 t2 l1 l2", "build_Dovov": "t1 t2 l1 l2",
    "build_Doovv": "t1 t2 l1 l2",
}
# the block functions that take a (T) extra, and its shape
EXTRAS = {"build_Doo": (NO, NO), "build_Dvv": (NV, NV), "build_Dov": (NO, NV),
          "build_Dooov": (NO, NO, NO, NV), "build_Dvvvo": (NV, NV, NV, NO),
          "build_Doovv": (NO, NO, NV, NV)}


def _amps():
    _, _, t1, t2, l1, l2 = synthetic_inputs()
    return dict(t1=t1, t2=t2, l1=l1, l2=l2)


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
@pytest.mark.parametrize("model", MODELS)
def test_density_blocks_match_pycc_tpu(model, fn):
    amps = _amps()
    names = FUNCTIONS[fn].split()
    j = getattr(jden, fn)(model, *(jnp.asarray(amps[n]) for n in names))
    t = getattr(tden, fn)(model,
                               *(torch.from_numpy(amps[n]) for n in names))
    assert gap(j, t) < 1e-12


@pytest.mark.parametrize("fn", sorted(EXTRAS))
def test_density_blocks_with_extras_match_pycc_tpu(fn):
    amps = _amps()
    x = 0.01 * np.random.default_rng(23).standard_normal(EXTRAS[fn])
    names = FUNCTIONS[fn].split()
    j = getattr(jden, fn)("CCSD", *(jnp.asarray(amps[n]) for n in names),
                               jnp.asarray(x))
    t = getattr(tden, fn)("CCSD",
                               *(torch.from_numpy(amps[n]) for n in names),
                               torch.from_numpy(x))
    assert gap(j, t) < 1e-12


def test_dvo_matches_pycc_tpu():
    l1 = _amps()["l1"]
    assert gap(jden.build_Dvo(jnp.asarray(l1)),
               tden.build_Dvo(torch.from_numpy(l1))) < 1e-12


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_onepdm_matches_pycc_tpu(model, extras):
    a = _amps()
    rng = np.random.default_rng(29)
    x = ([0.01 * rng.standard_normal(s) for s in ((NO, NO), (NV, NV),
                                                   (NO, NV))]
         if extras else [None] * 3)
    j = jden.onepdm(model, *(jnp.asarray(a[n]) for n in ("t1", "t2", "l1",
                                                          "l2")),
                    NO, NO + NV,
                    *(None if y is None else jnp.asarray(y) for y in x))
    t = tden.onepdm(model, *(torch.from_numpy(a[n]) for n in ("t1", "t2",
                                                               "l1", "l2")),
                    NO, NO + NV,
                    *(None if y is None else torch.from_numpy(y) for y in x))
    assert gap(j, t) < 1e-12


def test_dipole_blocks_match_pycc_tpu():
    rng = np.random.default_rng(31)
    ints = rng.standard_normal((NO + NV, NO + NV))
    t1 = _amps()["t1"]
    for name in ("build_Moo", "build_Mvv"):
        j = getattr(jden, name)(NO, NV, jnp.asarray(ints), jnp.asarray(t1))
        t = getattr(tden, name)(NO, NV, torch.from_numpy(ints),
                                torch.from_numpy(t1))
        assert gap(j, t) < 1e-12


def test_density_energy_equals_ecorr():
    cc, _, lam, ecc, _ = _port_lambda("cc-pvdz")
    with contextlib.redirect_stdout(io.StringIO()):
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        edens = dens.compute_energy()
    assert abs(edens - ecc) < 1e-12
    assert abs(dens.eone + dens.etwo - edens) == 0.0
    opdm = dens.compute_onepdm(cc.t1, cc.t2, lam.l1, lam.l2)
    assert torch.equal(opdm[:cc.no, :cc.no], dens.Doo)
    # the one-electron trace of a correlated density is zero
    assert abs(torch.trace(opdm).item()) < 1e-12


def test_onlyone_gives_the_one_electron_energy():
    cc, _, lam, _, _ = _port_lambda("sto-3g")
    with contextlib.redirect_stdout(io.StringIO()):
        full = pycc_tpu_torch.ccdensity(cc, lam)
        full.compute_energy()
        one = pycc_tpu_torch.ccdensity(cc, lam, onlyone=True)
        eone = one.compute_energy()
    assert abs(eone - full.eone) < 1e-14
    assert not hasattr(one, "Dvvvv")
