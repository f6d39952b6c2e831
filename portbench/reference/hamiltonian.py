"""The MO Hamiltonian, recomputed from the benchmark's seeded SCF output.

Full storage: F = C^T F_ao C, <pq|rs> = (pr|qs) by one quarter transform
per index, L = 2 <pq|rs> - <pq|sr>, mu = C^T mu_ao C, all in float64.
Over factors: `FactorERI` assembles any Dirac block from the MO factors
B (naux, nact, nact), <pq|rs> = sum_P B[P,p,r] B[P,q,s], once per block.
Either is indexed like the full tensor with the occupied and virtual
slices (`ERI[o, o, v, v]`).
"""

import torch

from .ein import ein


def mo_fock(C, F_ao):
    return C.T @ F_ao @ C


def mo_eri(C, ERI_ao):
    """AO (mn|ls) -> MO <pq|rs> (physicists'), float64."""
    t = ein("mnls,mp->pnls", ERI_ao, C)
    t = ein("pnls,nr->prls", t, C)
    t = ein("prls,lq->prqs", t, C)
    t = ein("prqs,sx->prqx", t, C)
    return t.permute(0, 2, 1, 3).contiguous()


def spin_adapted(ERI):
    return 2.0 * ERI - ERI.swapaxes(2, 3)


def mo_property(C, M_ao):
    return C.T @ M_ao @ C


class FullERI:
    """A whole (nact,)*4 tensor, indexed as is."""

    def __init__(self, T):
        self.T = T

    def __getitem__(self, key):
        return self.T[key]


def _space(s, no):
    start = 0 if s.start is None else s.start
    if start == 0 and s.stop == no:
        return "o"
    if start == no and s.stop is None:
        return "v"
    raise KeyError("FactorERI takes the occupied or virtual slice, got %r"
                   % (s,))


class FactorERI:
    """Dirac blocks <pq|rs> = (pr|qs) assembled from MO factors B, each
    made once on first use and kept; `L=True` gives 2 <pq|rs> - <pq|sr>."""

    def __init__(self, B, no, L=False, eri=None):
        self.B = B
        self.no = no
        self.L = L
        self.eri = eri if eri is not None else (
            FactorERI(B, no) if L else None)
        self.blocks = {}

    def _piece(self, sp):
        no = self.no
        sl = {"o": slice(0, no), "v": slice(no, None)}
        p, q, r, s = (sl[c] for c in sp)
        Bpr = self.B[:, p, r]
        Bqs = self.B[:, q, s]
        n1, n2, n3, n4 = Bpr.shape[1], Bqs.shape[1], Bpr.shape[2], Bqs.shape[2]
        # (pr, P) @ (P, qs) -> (p, r, q, s) -> (p, q, r, s)
        prqs = (Bpr.reshape(-1, n1 * n3).T @ Bqs.reshape(-1, n2 * n4))
        return prqs.reshape(n1, n3, n2, n4).permute(0, 2, 1, 3).contiguous()

    def __getitem__(self, key):
        sp = "".join(_space(s, self.no) for s in key)
        if sp not in self.blocks:
            if self.L:
                self.blocks[sp] = (2.0 * self.eri[key]
                                   - self.eri[key[:2] + (key[3], key[2])]
                                   .swapaxes(2, 3))
            else:
                self.blocks[sp] = self._piece(sp)
        return self.blocks[sp]
