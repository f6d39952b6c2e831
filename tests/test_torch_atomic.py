"""scf/atomic.py of the port against pycc_tpu's: the LS-coupled atomic HF
that derives the cc-pVDZ contractions (test_018's sizes: the shipped
primitive sets of O and C)."""

import numpy as np
import pytest

from pycc_tpu.scf import atomic as ref
from pycc_tpu_torch.scf import atomic


@pytest.mark.parametrize("sym,kw", [
    ("O", {}),
    ("C", {"s_exps": ref.PRIMITIVES["C"][0], "p_exps": ref.PRIMITIVES["C"][1],
           "damp": 0.5}),
    ("H", {}),
], ids=["O", "C", "H"])
def test_solve_atom_matches_pycc_tpu(sym, kw):
    got, want = atomic.solve_atom(sym, **kw), ref.solve_atom(sym, **kw)
    # the same numpy and scipy calls on the same integrals: agreement to
    # roundoff in the energy and in every contraction coefficient
    assert abs(got["E"] - want["E"]) < 1e-10
    assert got["niter"] == want["niter"]
    for c, d in zip(got["c"], want["c"]):
        np.testing.assert_allclose(c, d, rtol=0, atol=1e-10)
    if want["w"] is None:
        assert got["w"] is None
    else:
        np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=1e-10)


def test_anion_energy_matches_pycc_tpu():
    e = atomic.anion_energy("O", 0.07896, 0.06856)
    assert abs(e - ref.anion_energy("O", 0.07896, 0.06856)) < 1e-10
    # the anion state is restored after the call
    assert atomic.STATES["O"] == (2, 4, 6.0, -1.0)
