"""The seeded SCF output: its symmetries, its form, and one set per seed."""

import numpy as np
import pytest
import torch

from portbench.harness.inputs import make_inputs
from portbench.tests.common import SEED

FULL = dict(nbf=12, nfzc=1, ndocc=4, storage="full", precision="DP",
            generator=dict(rank=30, scale=0.4, eps_core=[-20.6, -20.5],
                           eps_occ=[-1.4, -0.45], eps_vir=[0.15, 4.8],
                           property_scale=0.5, e_scf=-1.0))
DF = dict(nbf=13, nfzc=1, ndocc=4, naux=40, storage="df", precision="DP",
          generator=dict(scale=0.4, eps_core=[-20.6, -20.5],
                         eps_occ=[-1.4, -0.45], eps_vir=[0.05, 4.5]))
CPU = torch.device("cpu")


def test_ao_eri_has_8_fold_symmetry_and_is_psd():
    eri = make_inputs(FULL, SEED, CPU).ERI_ao
    for perm in ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1), (1, 0, 3, 2),
                 (3, 2, 1, 0), (2, 3, 1, 0), (3, 2, 0, 1)):
        np.testing.assert_allclose(eri, eri.transpose(perm), atol=1e-15)
    n = FULL["nbf"]
    assert np.linalg.eigvalsh(eri.reshape(n * n, n * n)).min() > -1e-12


def test_orbitals_orthonormal_and_mo_fock_diagonal():
    wfn = make_inputs(FULL, SEED, CPU)
    C = wfn.Ca()
    np.testing.assert_allclose(C.T @ C, np.eye(FULL["nbf"]), atol=1e-13)
    F = C.T @ wfn.Fa() @ C
    np.testing.assert_allclose(F, np.diag(wfn.eps), atol=1e-13)
    assert np.all(np.diff(wfn.eps) > 0)
    assert wfn.Ca_subset("AO", "ACTIVE").shape == (12, 11)
    assert (wfn.frzcpi(), wfn.doccpi(), wfn.nmo()) == ([1], [4], 12)
    dip, ang, nab, quad = wfn.ao_props
    assert len(dip) == 3 and len(quad) == 6
    for m in dip + quad:
        np.testing.assert_allclose(m, m.T, atol=0)
    for m in ang + nab:
        np.testing.assert_allclose(m, -m.T, atol=0)


def test_df_factors_symmetric_with_diagonal_fock():
    x = make_inputs(DF, SEED, CPU)
    assert x.B.shape == (40, 12, 12) and x.no == 3
    np.testing.assert_allclose(x.B, x.B.transpose(0, 2, 1), atol=0)
    assert np.count_nonzero(x.F - np.diag(np.diag(x.F))) == 0


@pytest.mark.parametrize("cfg", [FULL, DF], ids=["full", "df"])
def test_repeatable_per_seed(cfg):
    def arrays(seed):
        x = make_inputs(cfg, seed, CPU)
        if cfg["storage"] == "df":
            return [x.B, x.F]
        return [x.Ca(), x.Fa(), x.ERI_ao] + [m for g in x.ao_props
                                               for m in g]
    a, b, c = arrays(SEED), arrays(SEED), arrays(SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_df_dipoles_leave_the_factors_as_they_were():
    """With generator.property_scale the factors also carry three
    symmetric MO dipole matrices of that scale, drawn after B, so that B
    and F are the same, bit for bit, with them or without."""
    plain = make_inputs(DF, SEED, CPU)
    gen = dict(DF["generator"], property_scale=0.5)
    x = make_inputs(dict(DF, generator=gen), SEED, CPU)
    assert plain.mu is None
    assert torch.equal(torch.as_tensor(x.B), torch.as_tensor(plain.B))
    assert torch.equal(torch.as_tensor(x.F), torch.as_tensor(plain.F))
    assert x.mu.shape == (3, 12, 12)
    np.testing.assert_allclose(x.mu, x.mu.transpose(0, 2, 1), atol=0)
    other = make_inputs(dict(DF, generator=gen), SEED + 1, CPU)
    assert not np.array_equal(x.mu, other.mu)
