"""The port's CC residuals, energies and DIIS against pycc_tpu's on the
same synthetic Hamiltonian and amplitudes (f64; only the summation order
differs, hence 1e-12)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu.models import ccsd as jeqs
from pycc_tpu.ops.diis import DIIS as JDIIS
from pycc_tpu.utils import mp2_guess as jmp2, synthetic_hamiltonian as jsynth
from pycc_tpu_torch.models import ccsd as teqs
from pycc_tpu_torch.ops.diis import DIIS as TDIIS
from pycc_tpu_torch.utils.synth import mp2_guess as tmp2
from pycc_tpu_torch.utils.synth import synthetic_hamiltonian as tsynth

NO, NV, SEED = 4, 12, 3


@functools.lru_cache(maxsize=None)
def _inputs():
    jH = jsynth(NO, NV, seed=SEED)
    tH = tsynth(NO, NV, seed=SEED, device="cpu")
    _, t2, _ = jmp2(jH)
    t1 = 0.01 * np.random.default_rng(11).standard_normal((NO, NV))
    return jH, tH, t1, np.array(t2)


def _gap(a, b):
    return np.max(np.abs(np.asarray(a) - b.numpy()))


def test_synthetic_hamiltonian_and_mp2_guess_are_bit_identical():
    jH, tH, _, t2 = _inputs()
    for name in ("F", "ERI", "L"):
        assert np.array_equal(np.asarray(getattr(jH, name)),
                              getattr(tH, name).numpy()), name
    assert np.array_equal(t2, tmp2(tH)[1].numpy())


@pytest.mark.parametrize("model", ["ccsd", "ccd", "cc2"])
def test_residuals_match_pycc_tpu(model):
    jH, tH, t1, t2 = _inputs()
    jr1, jr2 = getattr(jeqs, "residuals_" + model)(
        jH.F, jH.ERI, jH.L, jnp.asarray(t1), jnp.asarray(t2), NO)
    tr1, tr2 = getattr(teqs, "residuals_" + model)(
        tH.F, tH.ERI, tH.L, tH.vvvv, torch.from_numpy(t1),
        torch.from_numpy(t2), NO)
    assert _gap(jr1, tr1) < 1e-12
    assert _gap(jr2, tr2) < 1e-12


@pytest.mark.parametrize("energy", ["cc_energy", "ccd_energy"])
def test_energies_match_pycc_tpu(energy):
    jH, tH, t1, t2 = _inputs()
    je = getattr(jeqs, energy)(jH.F, jH.L, jnp.asarray(t1), jnp.asarray(t2),
                               NO)
    te = getattr(teqs, energy)(tH.F, tH.L, torch.from_numpy(t1),
                               torch.from_numpy(t2), NO)
    assert abs(float(je) - te.item()) < 1e-12


def test_diis_extrapolation_matches_pycc_tpu():
    rng = np.random.default_rng(5)
    shapes = ((NO, NV), (NO, NO, NV, NV))
    vecs = [tuple(rng.standard_normal(s) * 0.1 ** i for s in shapes)
            for i in range(6)]
    jd = JDIIS(tuple(jnp.asarray(x) for x in vecs[0]), max_diis=8)
    td = TDIIS(tuple(torch.from_numpy(x) for x in vecs[0]), max_diis=8)
    js, ts = jd.init(), td.init()
    for prev, cur in zip(vecs[:-1], vecs[1:]):
        js = jd.push(js, tuple(map(jnp.asarray, cur)),
                     tuple(map(jnp.asarray, prev)))
        td.push(ts, tuple(map(torch.from_numpy, cur)),
                tuple(map(torch.from_numpy, prev)))
    assert ts.count == 5
    cur = vecs[-1]
    jout = jd.extrapolate(js, tuple(map(jnp.asarray, cur)))
    tout = td.extrapolate(ts, tuple(map(torch.from_numpy, cur)))
    for a, b in zip(jout, tout):
        assert _gap(a, b) < 1e-12


@pytest.mark.parametrize("pushes", [2, 3, 10])
def test_diis_on_a_singular_pulay_matrix_takes_the_newest_amplitudes(pushes):
    """Error vectors that are exactly dependent (the same step pushed again,
    as a solve at its floor can give on the card: He/cc-pVDZ Lambda at
    1e-13 on an H100) make the Pulay matrix singular.  torch.linalg.solve
    raised there; the extrapolation now returns the newest amplitudes
    unextrapolated, its ring untouched, on the device (no host read)."""
    rng = np.random.default_rng(8)
    shapes = ((NO, NV), (NO, NO, NV, NV))
    d = TDIIS(tuple(torch.zeros(s, dtype=torch.float64) for s in shapes),
              max_diis=4)
    state = d.init()
    prev = tuple(torch.from_numpy(rng.standard_normal(s)) for s in shapes)
    cur = tuple(torch.from_numpy(rng.standard_normal(s)) for s in shapes)
    for _ in range(pushes):
        d.push(state, cur, prev)
    out = d.extrapolate(state, cur)
    for a, b in zip(out, cur):
        assert torch.equal(a, b)
