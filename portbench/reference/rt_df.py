"""Real-time CCSD over MO factors, plain: reference/rt.py's right-hand
side, rk4 step and dipole on integrals assembled from the factors.

Every Dirac block but <vv|vv> is assembled once from B (naux, nact, nact)
and kept (`hamiltonian.FactorERI`).  No v^4 tensor is ever held whole,
real or complex: <ab|ef> (`FactorVVVV`) and HBAR's Hvvvv (`FactorHvvvv`)
are made a block of their first index at a time, at most `blk` of it, and
each v^4 term takes them block by block: the T ladder on <ab|ef>, Hvvvv's
t1 term in Hvvvo, and the Lambda ladder 'ijef,efab'.  The CCSD, HBAR and
Lambda equations are reference/ccsd.py's and lam.py's, which hand their
v^4 terms to these objects.
"""

import torch

from .ein import ein, matmul_nt
from .hamiltonian import FactorERI
from .lam import hbar_vvvv
from .rt import RT

# a block of <ab|ef> or Hvvvv holds at most about this many elements
BLOCK_ELEMS = 2 ** 25


def block_size(nv):
    """The a's of one block: BLOCK_ELEMS elements of (a, v, v, v)."""
    return max(1, min(nv, BLOCK_ELEMS // nv ** 3))


def _ranges(n, blk):
    return [(a0, min(a0 + blk, n)) for a0 in range(0, n, blk)]


class FactorVVVV:
    """<ab|ef> = sum_P B[P,a,e] B[P,b,f] from Bvv (naux, v, v), never whole:
    `block(a0, a1)` makes (a1 - a0, v, v, v)."""

    def __init__(self, Bvv, blk):
        self.Bvv = Bvv.contiguous()
        self.nv = Bvv.shape[1]
        self.blk = blk

    def ranges(self):
        return _ranges(self.nv, self.blk)

    def block(self, a0, a1):
        naux, nv = self.Bvv.shape[0], self.nv
        # (a e, P) @ (P, b f) -> (a, e, b, f) -> (a, b, e, f)
        X = (self.Bvv[:, a0:a1].reshape(naux, -1).T
             @ self.Bvv.reshape(naux, -1))
        return X.reshape(a1 - a0, nv, nv, nv).permute(0, 2, 1, 3)

    def ladder(self, tau):
        """'ijef,abef->ijab', a block of a at a time."""
        no1, no2, nv, _ = tau.shape
        A = tau.reshape(no1 * no2, nv * nv)
        out = torch.empty((no1, no2, nv, nv),
                          dtype=torch.promote_types(tau.dtype,
                                                    self.Bvv.dtype),
                          device=tau.device)
        for a0, a1 in self.ranges():
            W = self.block(a0, a1).reshape((a1 - a0) * nv, nv * nv)
            out[:, :, a0:a1] = matmul_nt(A, W).reshape(no1, no2, a1 - a0, nv)
            del W
        return out

    def hbar(self, vovv, eri_oovv, t1, tau):
        return FactorHvvvv(self, vovv, eri_oovv, t1, tau)


class FactorHvvvv:
    """HBAR's Hvvvv (reference/lam.hbar_vvvv) over a FactorVVVV, never
    whole: each use makes it a block of its first index at a time."""

    def __init__(self, vvvv, vovv, eri_oovv, t1, tau):
        self.vvvv, self.vovv, self.eri_oovv = vvvv, vovv, eri_oovv
        self.t1, self.tau = t1, tau

    def block(self, a0, a1):
        a = slice(a0, a1)
        return hbar_vvvv(self.vvvv.block(a0, a1), self.vovv, self.eri_oovv,
                         self.t1, self.tau, a)

    def t1_term(self, t1):
        """'if,abef->abei' (Hvvvo's t1 term)."""
        nv = self.vvvv.nv
        out = None
        for a0, a1 in self.vvvv.ranges():
            part = ein("if,abef->abei", t1, self.block(a0, a1))
            if out is None:
                out = torch.empty((nv,) + part.shape[1:], dtype=part.dtype,
                                  device=part.device)
            out[a0:a1] = part
            del part
        return out

    def ladder_left(self, l2):
        """'ijef,efab->ijab', summed over blocks of e."""
        out = 0
        for e0, e1 in self.vvvv.ranges():
            out = out + ein("ijef,efab->ijab", l2[:, :, e0:e1],
                            self.block(e0, e1))
        return out


def factor_rt(B, F0, mu, no, V, blk=None):
    """The plain real-time CCSD system (reference/rt.RT) of the factors B
    (naux, nact, nact), the field-free Fock matrix F0 and the MO dipole
    matrices mu, its v^4 terms in blocks of at most `blk` a's (None:
    `block_size`)."""
    nv = B.shape[1] - no
    ERI = FactorERI(B, no)
    L = FactorERI(B, no, L=True, eri=ERI)
    vvvv = FactorVVVV(B[:, no:, no:], blk or block_size(nv))
    return RT(F0, ERI, L, vvvv, mu, no, V)
