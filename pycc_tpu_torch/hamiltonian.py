"""MO-basis normal-ordered Hamiltonian as a dataclass of torch tensors.

Fock matrix F, Dirac-notation ERI <pq|rs>, spin-adapted L = 2<pq|rs> -
<pq|sr>, and one-electron property integrals (electric dipole mu, magnetic
dipole m, linear momentum p, traceless quadrupole Q) over the active MO
space.  The counterpart of pycc_tpu/hamiltonian.py.
"""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .utils.device import init_device


@dataclass(frozen=True, eq=False)
class Hamiltonian:
    F: torch.Tensor
    ERI: torch.Tensor     # None under storage='df' (the factors carry it)
    L: torch.Tensor
    mu: tuple = ()        # 3 (nact,nact) real matrices (electric dipole, -r)
    m: tuple = ()         # 3 complex matrices (magnetic dipole)
    p: tuple = ()         # 3 complex matrices (linear momentum)
    Q: tuple = ()         # 6 real matrices (traceless quadrupole, XX..ZZ)
    no: int = 0

    @property
    def o(self):
        return slice(0, self.no)

    @property
    def v(self):
        return slice(self.no, None)

    @cached_property
    def vvvv(self):
        """<ab|ef> as one contiguous (v,v,v,v) tensor, made once.
        ERI[v,v,v,v] is a strided view of the (nact)^4 tensor, and the
        ladder's (v^2, v^2) matrix would otherwise copy v^4 elements on
        every residual evaluation.  None when ERI is None."""
        if self.ERI is None:
            return None
        v = self.v
        return self.ERI[v, v, v, v].contiguous()

    @classmethod
    def from_numpy(cls, F, ERI, L, no, device="cuda", dtype=torch.float64,
                   mu=(), m=(), p=(), Q=()):
        """Carry host arrays (e.g. pycc_tpu's Hamiltonian, via numpy) onto
        `device`: F/ERI/L and the real property matrices in `dtype`, the
        complex ones (m, p) in complex128."""
        dev = init_device(device)
        F, ERI, L = _tensors((F, ERI, L), dtype, dev)
        return cls(F=F, ERI=ERI, L=L, no=int(no),
                   **_properties(mu, m, p, Q, dtype, dev))


def _tensors(arrays, dtype, dev):
    return tuple(torch.tensor(np.asarray(x), dtype=dtype, device=dev)
                 for x in arrays)


def _properties(mu, m, p, Q, dtype, dev):
    return dict(mu=_tensors(mu, dtype, dev),
                m=_tensors(m, torch.complex128, dev),
                p=_tensors(p, torch.complex128, dev),
                Q=_tensors(Q, dtype, dev))


def _mo_eri_dirac(ERI_ao, C):
    """AO (ab|cd) -> MO <pq|rs> (physicists') by four quarter transforms.
    Each tensordot contracts the leading AO index and appends the new MO
    index last, so after four the order is (pr|qs)."""
    t = ERI_ao
    for _ in range(4):
        t = torch.tensordot(t, C, dims=([0], [0]))
    return t.swapaxes(1, 2).contiguous()


def mo_eri_blocks(wfn, device="cuda", dtype=torch.float64):
    """The six canonical Dirac blocks of the active-space ERI
    (models/blocked.ERIBlocks: oooo, ooov, oovv, ovov, ovvv, vvvv), each
    transformed straight from the AO ERI by four quarter transforms with
    the occupied or the virtual columns of C, in float64 on `device`, then
    cast to `dtype`.  The nact^4 MO ERI is never formed.  A partial
    transform that several blocks share is made once, and dropped as soon
    as no block left needs it.  The AO ERI is the wavefunction's (`ERI_ao`), or
    is computed here."""
    from .models.blocked import CANONICAL, ERIBlocks
    from .scf import integrals as ints

    dev = init_device(device)
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    C = torch.as_tensor(np.asarray(wfn.Ca_subset("AO", "ACTIVE")),
                        dtype=torch.float64, device=dev)
    cols = {"o": C[:, :no], "v": C[:, no:]}
    ERI_ao = getattr(wfn, "ERI_ao", None)
    if ERI_ao is None:
        ERI_ao = ints.eri(wfn.basisset())
    # <pq|rs> = (pr|qs): block pat transforms the AO indices in the
    # chemists' order p, r, q, s
    chem = [pat[0] + pat[2] + pat[1] + pat[3] for pat in CANONICAL]
    done = {"": torch.as_tensor(ERI_ao, device=dev)}
    del ERI_ao
    blocks = []
    for k, order in enumerate(chem):
        for depth in range(1, 5):
            key = order[:depth]
            if key not in done:
                done[key] = torch.tensordot(done[key[:-1]], cols[key[-1]],
                                            dims=([0], [0]))
            # a partial transform goes as soon as no later block needs it
            if not any(c.startswith(key[:-1]) for c in chem[k + 1:]):
                done.pop(key[:-1], None)
        blocks.append(done.pop(order).permute(0, 2, 1, 3).to(dtype)
                      .contiguous())
    return ERIBlocks(*blocks)


def ao_properties(wfn):
    """(dipole, angular momentum, nabla, traceless quadrupole) AO integral
    matrices of wfn's basis, computed on the host once and kept on the
    wavefunction (`wfn.ao_props`), as run_rhf keeps the AO ERI: every
    Hamiltonian built from one wavefunction (another storage, a localized
    basis) transforms the same matrices, and at 144 basis functions they
    take seconds of host time each build."""
    from .scf import integrals as ints

    props = getattr(wfn, "ao_props", None)
    if props is None:
        basis = wfn.basisset()
        props = (ints.dipole(basis), ints.angular_momentum(basis),
                 ints.nabla(basis), ints.traceless_quadrupole(basis))
        wfn.ao_props = props
    return props


def build_hamiltonian(wfn, C=None, device="cuda", dtype=torch.float64,
                      eri=True):
    """Build the active-space Hamiltonian from an SCF wavefunction.

    `wfn` is a pycc_tpu_torch.scf.RHFWavefunction.  `C` (AO x active,
    numpy) overrides its active MO coefficients, e.g. with localized
    occupied orbitals: F, ERI, L and every property integral are then in
    that basis, as in pycc_tpu's build_hamiltonian(wfn, C=).  The AO
    property integrals are `ao_properties(wfn)`.  The AO integrals come
    from the host engine; the four-index MO transform runs in float64 on
    `device`, and F/ERI/L are then cast to `dtype`, as are the real
    property integrals (mu, Q); the complex ones (m, p) stay complex128,
    as in pycc_tpu.  A Hamiltonian without property integrals holds the
    empty tuple `()` for each of them (never None): the response code
    tests them for emptiness.

    The AO ERI is the one run_rhf kept on the wavefunction (`ERI_ao`), or
    is computed here when there is none.  eri=False skips the four-index
    tensors entirely (ERI = L = None) and never computes the AO ERI:
    ccwfn(storage='df') carries the two-electron integrals as Cholesky
    factors instead."""
    from .scf import integrals as ints

    dev = init_device(device)
    f64 = torch.float64
    C_np = np.asarray(wfn.Ca_subset("AO", "ACTIVE") if C is None else C)
    C = torch.as_tensor(C_np, dtype=f64, device=dev)
    F = C.T @ torch.as_tensor(np.asarray(wfn.Fa()), dtype=f64, device=dev) @ C

    basis = wfn.basisset()
    ERI = L = None
    if eri:
        ERI_ao = getattr(wfn, "ERI_ao", None)
        if ERI_ao is None:
            ERI_ao = ints.eri(basis)
        ERI = _mo_eri_dirac(torch.as_tensor(ERI_ao, device=dev), C)
        del ERI_ao
        L = (2.0 * ERI - ERI.swapaxes(2, 3)).to(dtype)
        ERI = ERI.to(dtype)

    def mo(M):
        return C_np.T @ M @ C_np

    dip, ang, nab, quad = ao_properties(wfn)
    mu = tuple(mo(M) for M in dip)
    m = tuple(mo(M * -0.5) * 1.0j for M in ang)
    p = tuple(mo(M) * 1.0j for M in nab)
    Q = tuple(mo(M) for M in quad)
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    return Hamiltonian(F=F.to(dtype), ERI=ERI, L=L, no=no,
                       **_properties(mu, m, p, Q, dtype, dev))
