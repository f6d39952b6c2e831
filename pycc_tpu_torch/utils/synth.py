"""Synthetic Hamiltonians for unit tests and kernel-sized dry runs.

A physically shaped (symmetric, diagonally dominant Fock, 8-fold-symmetric
ERI) active-space Hamiltonian at any (no, nv).  The values come from
numpy's `default_rng(seed)` in the same order as pycc_tpu's generator, so
both packages see bit-identical inputs for a given seed.
"""

import numpy as np
import torch

from ..hamiltonian import Hamiltonian


def synthetic_hamiltonian(no, nv, seed=0, dtype=torch.float64, device="cuda",
                          scale=0.05):
    rng = np.random.default_rng(seed)
    nact = no + nv
    eps = np.concatenate([np.linspace(-2.0, -0.5, no),
                          np.linspace(0.3, 3.0, nv)])
    F = np.diag(eps) + scale * 0.01 * _sym(rng.standard_normal((nact, nact)))
    # 8-fold permutational symmetry in chemists' notation, then -> Dirac
    A = rng.standard_normal((nact,) * 4) * scale
    A = A + A.transpose(1, 0, 2, 3)
    A = A + A.transpose(0, 1, 3, 2)
    A = A + A.transpose(2, 3, 0, 1)
    ERI = A.swapaxes(1, 2)  # <pq|rs>
    L = 2.0 * ERI - ERI.swapaxes(2, 3)
    return Hamiltonian.from_numpy(F, ERI, L, no, device=device, dtype=dtype)


def mp2_guess(H):
    """(t1 = 0, t2 = <ij|ab> / D_ijab, D_ijab) for a Hamiltonian."""
    no = H.no
    o, v = H.o, H.v
    eps = torch.diagonal(H.F)
    Dijab = (eps[o, None, None, None] + eps[None, o, None, None]
             - eps[None, None, v, None] - eps[None, None, None, v])
    t1 = torch.zeros((no, H.F.shape[0] - no), dtype=H.F.dtype,
                     device=H.F.device)
    t2 = H.ERI[o, o, v, v] / Dijab
    return t1, t2, Dijab


def _sym(x):
    return 0.5 * (x + x.T)
