"""Occupied-orbital localization: Pipek-Mezey and Foster-Boys.

The counterpart of pycc_tpu/scf/localize.py, host numpy like the rest of
this package's SCF layer (both are cheap at the sizes local correlation
runs: a few dozen occupied orbitals).  Classic Jacobi-sweep
implementations: PM maximizes the sum of squared Mulliken charges
(Pipek & Mezey, JCP 90, 4916 (1989)); Boys maximizes the sum of squared
orbital dipole moments by the equivalent pairwise rotations.  The sweep
order (i ascending, then j > i ascending) is pycc_tpu's: the localized
orbitals are a local optimum that depends on it.
"""

import numpy as np


def _jacobi_sweeps(C, ABfunc, maxiter=200, conv=1e-12):
    """Generic 2x2 Jacobi rotation sweeps.  ABfunc(C, i, j) -> (A, B) for
    the standard localization angle 4*alpha = atan2(B, -A)."""
    n = C.shape[1]
    C = C.copy()
    for _ in range(maxiter):
        change = 0.0
        for i in range(n):
            for j in range(i + 1, n):
                A, B = ABfunc(C, i, j)
                if A * A + B * B < 1e-24:
                    continue
                gamma = 0.25 * np.arctan2(B, -A)
                c, s = np.cos(gamma), np.sin(gamma)
                ci = C[:, i].copy()
                cj = C[:, j].copy()
                C[:, i] = c * ci + s * cj
                C[:, j] = -s * ci + c * cj
                change += abs(gamma)
        if change < conv:
            break
    return C


def ao_atoms(basis):
    """The atom of each AO basis function (nbf,), from the shells."""
    ao_atom = np.zeros(basis.nbf, dtype=int)
    for sh, off in zip(basis.shells, basis.offsets):
        ao_atom[off:off + sh.nfunc] = sh.atom_index
    return ao_atom


def pipek_mezey(C_occ, S, basis, maxiter=200, conv=1e-12):
    """Localize columns of C_occ (AO x nocc) by Pipek-Mezey."""
    ao_atom = ao_atoms(basis)
    masks = [ao_atom == A for A in range(basis.molecule.natom)]

    def AB(C, i, j):
        SCi = S @ C[:, i]
        SCj = S @ C[:, j]
        A = B = 0.0
        for m in masks:
            qii = np.sum(C[m, i] * SCi[m])
            qjj = np.sum(C[m, j] * SCj[m])
            qij = 0.5 * (np.sum(C[m, i] * SCj[m]) + np.sum(C[m, j] * SCi[m]))
            A += qij * qij - 0.25 * (qii - qjj) ** 2
            B += qij * (qii - qjj)
        return A, B

    return _jacobi_sweeps(C_occ, AB, maxiter, conv)


def boys(C_occ, dipole_ints, maxiter=200, conv=1e-12):
    """Foster-Boys localization using the three AO dipole matrices."""

    def AB(C, i, j):
        A = B = 0.0
        for M in dipole_ints:
            rii = C[:, i] @ M @ C[:, i]
            rjj = C[:, j] @ M @ C[:, j]
            rij = C[:, i] @ M @ C[:, j]
            A += rij * rij - 0.25 * (rii - rjj) ** 2
            B += rij * (rii - rjj)
        return A, B

    return _jacobi_sweeps(C_occ, AB, maxiter, conv)
