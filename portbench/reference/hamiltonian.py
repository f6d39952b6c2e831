"""The MO Hamiltonian, recomputed from the benchmark's seeded SCF output.

Full storage: F = C^T F_ao C, <pq|rs> = (pr|qs) by one quarter transform
per index, L = 2 <pq|rs> - <pq|sr>, mu = C^T mu_ao C, all in float64.
Over factors: `FactorERI` assembles any Dirac block from the MO factors
B (naux, nact, nact), <pq|rs> = sum_P B[P,p,r] B[P,q,s], once per block.
By blocks from the AO ERI: `SpaceERI` makes any Dirac block by occupied
and virtual space from the host AO ERI, streamed to the device, so that
neither the whole MO ERI nor the whole AO ERI sits on the device.
Each is indexed like the full tensor with the occupied and virtual
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
    raise KeyError("a block takes the occupied or virtual slice, got %r"
                   % (s,))


def spaces(key, no):
    """'ovvv' for the slices (o, v, v, v)."""
    return "".join(_space(s, no) for s in key)


def space_slices(sp, no):
    """(o, v, v, v) for 'ovvv'."""
    sl = {"o": slice(0, no), "v": slice(no, None)}
    return tuple(sl[c] for c in sp)


class _Blocks:
    """Dirac blocks by space, each made once on first use (`_piece`) and
    kept until `drop`; `L=True` makes 2 <pq|rs> - <pq|sr> from the blocks
    of `eri`."""

    def __init__(self, no, L, eri):
        self.no = no
        self.L = L
        self.eri = eri
        self.blocks = {}

    def __getitem__(self, key):
        sp = spaces(key, self.no)
        if sp not in self.blocks:
            if self.L:
                blk = 2.0 * self.eri[key]
                blk.sub_(self.eri[key[:2] + (key[3], key[2])].swapaxes(2, 3))
                self.blocks[sp] = blk
            else:
                self.blocks[sp] = self._piece(sp)
        return self.blocks[sp]

    def drop(self, sp):
        """Free the block of spaces `sp` ('ovvv'), if it is made."""
        self.blocks.pop(sp, None)


class FactorERI(_Blocks):
    """Dirac blocks <pq|rs> = (pr|qs) assembled from MO factors B, each
    made once on first use and kept; `L=True` gives 2 <pq|rs> - <pq|sr>."""

    def __init__(self, B, no, L=False, eri=None):
        super().__init__(no, L, eri if eri is not None else (
            FactorERI(B, no) if L else None))
        self.B = B

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


class SpaceERI(_Blocks):
    """Dirac blocks <pq|rs> = sum C[m,p] C[n,r] C[l,q] C[s',s] (mn|ls') from
    the AO ERI in host memory, each made once on first use (or several in
    one pass, `make`) and kept until `drop`; `L=True` (with `eri`) gives
    2 <pq|rs> - <pq|sr> from ERI's blocks.

    A pass streams the AO ERI to C's device in chunks of its first index
    m, about `chunk_bytes` a chunk: each chunk's other three indices are
    transformed to every active orbital, and its part of the sum over m is
    added into each block the pass makes.  No tensor on the device is
    larger than the largest block asked for, or than a chunk's.  `passes`
    counts the passes made."""

    def __init__(self, C, ERI_ao, no, L=False, eri=None, chunk_bytes=2 ** 30):
        super().__init__(no, L, eri)
        self.C = C
        self.ERI_ao = ERI_ao
        self.chunk_bytes = chunk_bytes
        self.passes = 0

    def _piece(self, sp):
        self.make([sp])
        return self.blocks[sp]

    def make(self, sps):
        """Make every block of `sps` (space strings) not made yet, in one
        pass over the AO ERI."""
        sps = [sp for sp in dict.fromkeys(sps) if sp not in self.blocks]
        if not sps:
            return
        self.passes += 1
        C, no = self.C, self.no
        nbf, nact = C.shape
        out = {sp: torch.zeros([no if c == "o" else nact - no for c in sp],
                               dtype=C.dtype, device=C.device)
               for sp in sps}
        step = max(1, self.chunk_bytes // (nbf ** 3 * C.element_size()))
        for m0 in range(0, nbf, step):
            X = torch.as_tensor(self.ERI_ao[m0:m0 + step]).to(C.device,
                                                               C.dtype)
            # (m, n, l, s) -> (m, q, r, s): <.q|rs> of each AO m
            Y = ein("mnls,sy->mnly", X, C)
            del X
            Y = ein("mnly,lq->mnqy", Y, C)
            Y = ein("mnqy,nr->mqry", Y, C)
            for sp, blk in out.items():
                p, q, r, s = space_slices(sp, no)
                blk.reshape(blk.shape[0], -1).addmm_(
                    C[m0:m0 + step, p].T,
                    Y[:, q, r, s].reshape(Y.shape[0], -1))
            del Y
        self.blocks.update(out)
