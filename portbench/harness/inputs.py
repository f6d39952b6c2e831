"""Seeded SCF output at a configuration's real sizes.

The device cost of a CC job depends on the shapes, not on the integral
values, so each run makes the SCF's output from its seed instead of
running an SCF: on the card, with one `torch.Generator`, in a few large
calls, then copied to where the SCF leaves it (host numpy arrays).

Full storage (`SeededSCF`, the psi4-style wavefunction `ccwfn` reads):
an orthonormal C (nbf x nbf) from the QR of a Gaussian matrix, the frozen
core first; fixed canonical orbital energies, so that the AO Fock matrix
F_ao = C diag(eps) C^T has a diagonal MO Fock matrix (the AO overlap is
the identity); the AO ERI (mn|ls) = sum_P B[P,mn] B[P,ls] from `generator.rank`
Gaussian factors symmetric in (m, n), so it has the 8-fold symmetry and is
positive semidefinite; symmetric dipole and quadrupole, antisymmetric
angular-momentum and nabla AO integrals.

Over factors (`SeededFactors`): MO factors B (naux, nact, nact) symmetric
in their two orbital indices and the diagonal active-space MO Fock
matrix, the input of `ccwfn.from_df_factors`; where the configuration's
generator has `property_scale`, three symmetric (nact, nact) MO dipole
matrices too, drawn after B from the same generator, so that B is the
same with them or without.

`generator.scale` sets the size of the two-electron integrals against
the orbital-energy gaps, and with it how many iterations CCSD takes.
"""

import numpy as np
import torch


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 64))
    return g


def orbital_energies(cfg):
    """(nmo,) canonical orbital energies: core, valence occupied and
    virtual, each evenly spread over the configuration's range."""
    gen = cfg["generator"]
    nfzc, ndocc, nbf = cfg["nfzc"], cfg["ndocc"], cfg["nbf"]
    return np.concatenate([
        np.linspace(*gen["eps_core"], nfzc),
        np.linspace(*gen["eps_occ"], ndocc - nfzc),
        np.linspace(*gen["eps_vir"], nbf - ndocc)])


def _sym(X):
    return (X + X.transpose(-1, -2)) * (0.5 ** 0.5)


def _antisym(X):
    return (X - X.transpose(-1, -2)) * (0.5 ** 0.5)


def _host(x):
    return x.cpu().numpy()


class SeededSCF:
    """The SCF output `ccwfn(wfn, ...)` and `build_hamiltonian` read:
    energy(), frzcpi(), doccpi(), nmo(), Ca(), Ca_subset(), Fa(),
    basisset(), and the kept `ERI_ao` and `ao_props`."""

    def __init__(self, C, eps, F_ao, ERI_ao, ao_props, nfzc, ndocc, energy):
        self.C = C
        self.eps = eps
        self.F_ao = F_ao
        self.ERI_ao = ERI_ao
        self.ao_props = ao_props
        self.nfzc = nfzc
        self.ndocc = ndocc
        self._energy = energy

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
        if space2 == "ALL":
            return self.C
        raise ValueError(space2)

    def Fa(self):
        return self.F_ao

    def basisset(self):
        # never read: the AO ERI and the property integrals are kept above
        return None


class SeededFactors:
    """MO factors B (naux, nact, nact) and the active MO Fock matrix F,
    host numpy arrays, the occupied count no, and the MO dipole matrices
    mu (3, nact, nact) or None."""

    def __init__(self, B, F, no, mu=None):
        self.B, self.F, self.no, self.mu = B, F, no, mu


def make_inputs(cfg, seed, device):
    """The run's SCF output for configuration `cfg` from `seed`."""
    if cfg["storage"] == "df":
        return _factors(cfg, seed, device)
    return _scf(cfg, seed, device)


def _scf(cfg, seed, device):
    g = _generator(seed, device)
    gen = cfg["generator"]
    nbf, rank = cfg["nbf"], gen["rank"]
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=f64)

    C = torch.linalg.qr(randn(nbf, nbf))[0]
    eps = torch.as_tensor(orbital_energies(cfg), dtype=f64, device=device)
    F_ao = (C * eps) @ C.T
    B = _sym(randn(rank, nbf, nbf)).reshape(rank, nbf * nbf)
    B *= gen["scale"] / rank ** 0.5
    ERI = (B.T @ B).reshape(nbf, nbf, nbf, nbf)
    del B
    ERI_ao = _host(ERI)
    del ERI
    ps = gen["property_scale"]
    dip = _sym(randn(3, nbf, nbf)) * ps
    ang = _antisym(randn(3, nbf, nbf)) * ps
    nab = _antisym(randn(3, nbf, nbf)) * ps
    quad = _sym(randn(6, nbf, nbf)) * ps
    props = tuple(tuple(_host(m) for m in group)
                  for group in (dip, ang, nab, quad))
    return SeededSCF(_host(C), _host(eps), _host(F_ao), ERI_ao, props,
                     cfg["nfzc"], cfg["ndocc"], gen["e_scf"])


def _factors(cfg, seed, device):
    g = _generator(seed, device)
    gen = cfg["generator"]
    nact = cfg["nbf"] - cfg["nfzc"]
    B = torch.randn((cfg["naux"], nact, nact), generator=g, device=device,
                    dtype=torch.float64)
    B = _sym(B)
    B *= gen["scale"] / cfg["naux"] ** 0.5
    mu = None
    if "property_scale" in gen:
        mu = _host(_sym(torch.randn((3, nact, nact), generator=g,
                                    device=device, dtype=torch.float64))
                   * gen["property_scale"])
    eps = orbital_energies(cfg)[cfg["nfzc"]:]
    return SeededFactors(_host(B), np.diag(eps),
                         cfg["ndocc"] - cfg["nfzc"], mu)
