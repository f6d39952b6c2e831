"""Restricted Hartree-Fock with DIIS, and a Psi4-like wavefunction facade.

Supplies the SCF reference that the reference framework gets from
`psi4.energy('SCF', return_wfn=True)` (see upstream pycc/tests).
The returned `RHFWavefunction` exposes the small API surface pycc actually
uses from a Psi4 wavefunction (`upstream pycc/ccwfn.py:125-141`):
energy(), frzcpi(), doccpi(), nmo(), Ca(), Ca_subset, Fa(), basisset(),
molecule().
"""

import numpy as np
from . import integrals
from .basis import BasisSet
from .mol import Molecule
from ..utils.log import logger as log
from ..utils.timing import Timers

# Frozen-core orbital counts per element (noble-gas core), Psi4 convention
_CORE = {"H": 0, "He": 0, "Li": 1, "Be": 1, "B": 1, "C": 1, "N": 1, "O": 1,
         "F": 1, "Ne": 1, "S": 5, "Cl": 5}


class RHFWavefunction:
    def __init__(self, mol, basis, energy, C, eps, F_ao, S_ao, ndocc, nfzc):
        self.mol = mol
        self.basis = basis
        self._energy = energy
        self.C = C            # full MO coefficients (nbf, nmo)
        self.eps = eps        # orbital energies
        self.F_ao = F_ao
        self.S_ao = S_ao
        self.ndocc = ndocc
        self.nfzc = nfzc

    # --- Psi4-compatible accessors -------------------------------------
    def energy(self):
        return self._energy

    def frzcpi(self):
        return [self.nfzc]

    def doccpi(self):
        return [self.ndocc]

    def nmo(self):
        return self.C.shape[1]

    def Ca(self):
        return self.C

    def Ca_subset(self, space1="AO", space2="ACTIVE"):
        if space2 == "ACTIVE":
            return self.C[:, self.nfzc:]
        if space2 == "ACTIVE_OCC":
            return self.C[:, self.nfzc:self.ndocc]
        if space2 == "ALL":
            return self.C
        raise ValueError(space2)

    def Fa(self):
        return self.F_ao

    def basisset(self):
        return self.basis

    def molecule(self):
        return self.mol


def run_rhf(geometry, basis_name, freeze_core=False, e_conv=1e-12,
            d_conv=1e-12, maxiter=200, verbose=False, df=False,
            df_tol=1e-10):
    """Run RHF-SCF. `geometry` is a Psi4-style string or a Molecule.

    df=True runs INTEGRAL-DIRECT SCF from AO Cholesky factors
    (scf/df.py): the nao^4 ERI never exists, Fock builds are
    O(naux nao^2 nocc), and the factors are kept on the returned
    wavefunction (`wfn.B_ao`, `wfn.B_tol`) so ccwfn(storage='df')
    can reuse them without a second factorization.  At df_tol=1e-10
    the Cholesky is numerically exact for SCF (energy error << 1e-9 Eh).
    `wfn.timers` holds the host seconds of the AO Cholesky
    ("rhf.ao_cholesky").  Without df the AO ERI (ab|cd) it computed stays
    on the wavefunction (`wfn.ERI_ao`, None with df), where
    build_hamiltonian takes it instead of computing it again."""
    mol = geometry if isinstance(geometry, Molecule) else Molecule(geometry)
    basis = BasisSet(mol, basis_name)

    S = integrals.overlap(basis)
    T = integrals.kinetic(basis)
    V = integrals.nuclear_attraction(basis)
    H = T + V
    Enuc = mol.nuclear_repulsion()

    nel = mol.nelectron()
    if nel % 2:
        raise ValueError("RHF requires an even number of electrons")
    ndocc = nel // 2

    # symmetric orthogonalization
    sval, svec = np.linalg.eigh(S)
    X = svec @ np.diag(sval ** -0.5) @ svec.T

    timers = Timers()
    if df:
        from .df import cholesky_factor_ao, fock_from_factors
        with timers.time("rhf.ao_cholesky"):
            B_ao = cholesky_factor_ao(basis, tol=df_tol, verbose=verbose)
        if verbose:
            log.info("SCF DF factors: naux = %d (tol %.1e)"
                     % (B_ao.shape[0], df_tol))

        def build_fock(D, Cocc=None):
            if Cocc is None:
                # recover Cocc from the (idempotent) density's eigenvectors
                w, U = np.linalg.eigh(D)
                Cocc = U[:, w > 0.5] * np.sqrt(w[w > 0.5])
            return fock_from_factors(B_ao, H, Cocc)
    else:
        B_ao = None
        ERI = integrals.eri(basis)  # (ab|cd) chemists

        def build_fock(D, Cocc=None):
            J = np.einsum("pqrs,rs->pq", ERI, D, optimize=True)
            K = np.einsum("prqs,rs->pq", ERI, D, optimize=True)
            return H + 2.0 * J - K

    def diag(F):
        Fp = X @ F @ X
        e, Cp = np.linalg.eigh(Fp)
        C = X @ Cp
        return e, C

    eps, C = diag(H)
    D = C[:, :ndocc] @ C[:, :ndocc].T
    E_old = 0.0
    diis_F, diis_e = [], []
    E = 0.0
    F = H
    for it in range(1, maxiter + 1):
        F = build_fock(D, C[:, :ndocc])
        E = np.einsum("pq,pq->", D, H + F) + Enuc
        err = F @ D @ S - S @ D @ F
        err = X @ err @ X
        diis_F.append(F.copy())
        diis_e.append(err.copy())
        if len(diis_F) > 8:
            diis_F.pop(0)
            diis_e.pop(0)
        drms = np.sqrt(np.mean(err * err))
        if verbose:
            log.info("SCF iter %3d: E = %.14f dE = %.3e drms = %.3e"
                  % (it, E, E - E_old, drms))
        if abs(E - E_old) < e_conv and drms < d_conv:
            break
        E_old = E
        if len(diis_F) >= 2:
            n = len(diis_F)
            B = -np.ones((n + 1, n + 1))
            B[n, n] = 0.0
            for a in range(n):
                for b in range(n):
                    B[a, b] = np.sum(diis_e[a] * diis_e[b])
            rhs = np.zeros(n + 1)
            rhs[n] = -1.0
            try:
                c = np.linalg.solve(B, rhs)[:n]
                F = sum(ci * Fi for ci, Fi in zip(c, diis_F))
            except np.linalg.LinAlgError:
                pass
        eps, C = diag(F)
        D = C[:, :ndocc] @ C[:, :ndocc].T
    else:
        raise RuntimeError("SCF did not converge in %d iterations" % maxiter)

    # final canonical orbitals from the *unextrapolated* converged Fock
    F = build_fock(D, C[:, :ndocc])
    eps, C = diag(F)
    D = C[:, :ndocc] @ C[:, :ndocc].T
    E = np.einsum("pq,pq->", D, H + F) + Enuc

    nfzc = sum(_CORE[s] for s in mol.symbols) if freeze_core else 0
    wfn = RHFWavefunction(mol, basis, E, C, eps, F, S, ndocc, nfzc)
    wfn.B_ao = B_ao
    wfn.B_tol = df_tol if df else None
    wfn.ERI_ao = None if df else ERI
    wfn.timers = timers
    return wfn
