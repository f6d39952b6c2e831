"""Blocked Hamiltonian storage: the six unique Dirac ERI blocks instead of
the full nact^4 ERI and L.

The counterpart of pycc_tpu/models/blocked.py.  Only the six canonical
occupied/virtual blocks are stored -- oooo, ooov, oovv, ovov, ovvv, vvvv
-- each a contiguous tensor.  All sixteen slice patterns of the ERI are
`permute` views of them, through the 8-fold permutational symmetry of
real Dirac integrals.  An L block, 2 <pq|rs> - <pq|sr>, is made when it is
indexed and dropped after use: eager torch cannot fold it into the
consuming product as XLA does, and caching the large ones (L[o,v,v,v] is
o v^3) would give back the memory the blocks save.

`BlockedERI`/`BlockedL` quack like the full tensors under 4-tuple o/v
slicing, so the residual, HBAR, Lambda, density and (T) equations run
verbatim on blocked storage.  `blocks.vvvv` is contiguous: it is K1's B
operand as it is.  On a mesh (parallel/mesh.shard_blocks) vvvv and ovvv
are Sharded; the views read them assembled, the ladder shard by shard.
"""

from typing import NamedTuple

import torch

from ..parallel.mesh import dense
from .ccsd import slices


def _close_group():
    """The 8-fold symmetry group of a real Dirac integral <pq|rs> = (pr|qs)
    as index-position permutations: p<->r, q<->s, bra<->ket and their
    compositions."""
    gens = [(0, 1, 2, 3), (2, 1, 0, 3), (0, 3, 2, 1), (1, 0, 3, 2)]
    group = set(gens)
    frontier = list(gens)
    while frontier:
        a = frontier.pop()
        for b in list(group):
            c = tuple(a[b[k]] for k in range(4))
            if c not in group:
                group.add(c)
                frontier.append(c)
    return sorted(group)


_GROUP = _close_group()

CANONICAL = ("oooo", "ooov", "oovv", "ovov", "ovvv", "vvvv")


class ERIBlocks(NamedTuple):
    """The six canonical Dirac blocks."""
    oooo: torch.Tensor
    ooov: torch.Tensor
    oovv: torch.Tensor
    ovov: torch.Tensor
    ovvv: torch.Tensor
    vvvv: torch.Tensor


def blocks_from_full(ERI, no):
    """Slice the six canonical blocks, as contiguous tensors, out of a full
    Dirac ERI tensor."""
    o, v = slices(no)
    sl = {"o": o, "v": v}
    return ERIBlocks(*(ERI[tuple(sl[c] for c in pat)].contiguous()
                       for pat in CANONICAL))


def _pattern_of(key, no, nact=None):
    """The o/v pattern of a 4-tuple of slices: o is [0, no), v is [no, end)
    (end given as None or as nact)."""
    pat = []
    for s in key:
        if s.start in (None, 0) and s.stop == no and s.step is None:
            pat.append("o")
        elif (s.start == no and s.step is None
              and (s.stop is None or s.stop == nact)):
            pat.append("v")
        else:
            raise KeyError("blocked ERI supports only o/v slices, got %r"
                           % (key,))
    return "".join(pat)


def _resolve(pat):
    """(canonical pattern, permutation) reproducing block `pat`: with sigma
    such that pat[sigma[k]] == canonical[k], B_pat = B_canon.permute(
    sigma^-1)."""
    for sigma in _GROUP:
        cand = "".join(pat[sigma[k]] for k in range(4))
        if cand in CANONICAL:
            inv = tuple(sigma.index(k) for k in range(4))
            return cand, inv
    raise KeyError(pat)  # unreachable: every pattern reduces


# the 16-entry dispatch table, made at import
_TABLE = {}
for _i in range(16):
    _p = "".join("ov"[(_i >> _k) & 1] for _k in (3, 2, 1, 0))
    _TABLE[_p] = _resolve(_p)


class BlockedERI:
    """Quacks like the full Dirac ERI under 4-tuple o/v slicing; every
    block is a view of a canonical one."""

    def __init__(self, blocks, no):
        self.blocks = blocks
        self.no = no
        self.nact = no + blocks.vvvv.shape[0]

    def block(self, pat):
        canon, sigma = _TABLE[pat]
        # a block sharded over a mesh is read assembled on the home device
        base = dense(getattr(self.blocks, canon))
        if sigma == (0, 1, 2, 3):
            return base
        return base.permute(sigma)

    def __getitem__(self, key):
        return self.block(_pattern_of(key, self.no, self.nact))


class BlockedL:
    """Spin-adapted L = 2 <pq|rs> - <pq|sr>, each block made when indexed
    (never cached)."""

    def __init__(self, blocks, no):
        self._eri = BlockedERI(blocks, no)
        self.no = no

    def __getitem__(self, key):
        pat = _pattern_of(key, self.no, self._eri.nact)
        direct = self._eri.block(pat)
        swapped = self._eri.block(pat[:2] + pat[3] + pat[2])
        return 2.0 * direct - swapped.permute(0, 1, 3, 2)


def blocked_views(blocks, no):
    """(ERI-like, L-like) views over an ERIBlocks."""
    return BlockedERI(blocks, no), BlockedL(blocks, no)


def eri_views(cc):
    """(ERI, L) of a ccwfn as the dense equations read them: the full
    tensors of cc.H, or under storage='blocked' the views over cc.blocks;
    (None, None) over DF factors."""
    if getattr(cc, "storage", "full") == "blocked":
        return blocked_views(cc.blocks, cc.no)
    return cc.H.ERI, getattr(cc.H, "L", None)


class LoovvOnly:
    """An L stand-in for the energy functions, which read only L[o,o,v,v]:
    lets a bf16 step evaluate the energy in the working precision while
    its residual contracts bf16 blocks or factors."""

    def __init__(self, Loovv, no):
        self.Loovv = Loovv
        self.no = no

    def __getitem__(self, key):
        if _pattern_of(key, self.no, self.no + self.Loovv.shape[2]) != "oovv":
            raise KeyError("LoovvOnly holds only the oovv block")
        return self.Loovv
