"""Connected-triples (T) energy drivers.

The counterpart of pycc_tpu/triples.py for storage='full', 'blocked' and
'df' (the dense functions read `models/blocked.eri_views`, so blocked
storage cuts every slice from the views of its six blocks):

- `t_vikings(cc)`: the full-tensor (T), o^3 v^3 memory, for small systems
  and tests;
- `t_vikings_scan_core`: the pair-symmetric slab scan, one (i, j) slab of
  t3 at a time, as a plain whole-(T) reference (a Python loop over rows and
  j-chunks);
- `t_vikings_scan(cc, slab_dtype=None, jc=None)`: the production (T) of
  `ccwfn(model="CCSD(T)")`.  It cuts the integral slices once (from the
  block views under storage='blocked', from the factors under
  storage='df', `t_scan_df_slices`) and runs every row through the K2
  kernel wrapper (`ops/kernels/triples.py`), which launches the CUDA
  kernel on CUDA tensors; slab_dtype=torch.bfloat16 is K2's bf16 stream;
- `t_vikings_scan_df_chunked`: the plain, memory-bounded (T) from factors,
  k-chunked over one resident (o, v, v, v) tensor; called explicitly;
- `t_vikings_inverted` and `t_tjl`: the virtual-driven and the Lee/Rendell
  restricted-triples (T), two oracles with other reduction orders;
- the (T) density of CCSD(T): `t3_density` over the full T3 tensor
  (storage 'full' or 'blocked') and `t3_density_scan`, one pass per (i, j) slab pair,
  on slices cut from the ERI or assembled from DF factors; both leave the
  Lambda sources S1/S2 and the density blocks on the ccwfn
  (`t3_density_energy` picks one, `t3_lambda_sources` reads them).

Eager torch materialises each slab once, so the optimization barriers of
the JAX versions have no counterpart here.
"""

import torch

from .models.blocked import eri_views
from .models.ccsd import slices
from .models.dfccsd import whole_bvv
from .parallel.mesh import dense
from .ops.contract import contract


def t3_denom(F, no):
    """D[ijkabc] = f_ii + f_jj + f_kk - f_aa - f_bb - f_cc."""
    o, v = slices(no)
    eps = F.diagonal()
    Fo, Fv = eps[o], eps[v]
    return (Fo[:, None, None, None, None, None]
            + Fo[None, :, None, None, None, None]
            + Fo[None, None, :, None, None, None]
            - Fv[None, None, None, :, None, None]
            - Fv[None, None, None, None, :, None]
            - Fv[None, None, None, None, None, :])


def t3c_full(Wvvvo, Wovoo, t2, F, no):
    """Connected T3 over all (i,j,k,a,b,c) at once."""
    t3 = contract("baei,kjce->ijkabc", Wvvvo, t2)
    t3 += contract("caei,jkbe->ijkabc", Wvvvo, t2)
    t3 += contract("acek,jibe->ijkabc", Wvvvo, t2)
    t3 += contract("bcek,ijae->ijkabc", Wvvvo, t2)
    t3 += contract("cbej,ikae->ijkabc", Wvvvo, t2)
    t3 += contract("abej,kice->ijkabc", Wvvvo, t2)
    t3 -= contract("mcjk,imab->ijkabc", Wovoo, t2)
    t3 -= contract("mbkj,imac->ijkabc", Wovoo, t2)
    t3 -= contract("mbij,kmca->ijkabc", Wovoo, t2)
    t3 -= contract("maji,kmcb->ijkabc", Wovoo, t2)
    t3 -= contract("maki,jmbc->ijkabc", Wovoo, t2)
    t3 -= contract("mcik,jmba->ijkabc", Wovoo, t2)
    return t3 / t3_denom(F, no)


def t3d_full(t1, t2, Woovv, F, no):
    """Disconnected T3 over the full index space."""
    o, v = slices(no)
    Fov = F[o, v]
    t3 = contract("ijab,kc->ijkabc", Woovv, t1)
    t3 += contract("ikac,jb->ijkabc", Woovv, t1)
    t3 += contract("jkbc,ia->ijkabc", Woovv, t1)
    t3 += contract("ijab,kc->ijkabc", t2, Fov)
    t3 += contract("ikac,jb->ijkabc", t2, Fov)
    t3 += contract("jkbc,ia->ijkabc", t2, Fov)
    return t3 / t3_denom(F, no)


def _swap_ac(t3):
    return t3.swapaxes(3, 5)


def _swap_bc(t3):
    return t3.swapaxes(4, 5)


def _vikings_X(F, ERI, L, t2, t3, no):
    """X1/X2 contractions of the occupied-driven (T)."""
    o, v = slices(no)
    td = t3 - _swap_ac(t3)
    T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
    X1 = contract("ijkabc,jkbc->ia", td, L[o, o, v, v])
    X2 = contract("ijkabc,kc->ijab", td, F[o, v])
    X2 += contract("ijkabc,dkbc->ijad", T, ERI[v, o, v, v])
    X2 -= contract("ijkabc,jklc->ilab", T, ERI[o, o, o, v])
    return X1, X2


def t_vikings(cc):
    """Occupied-driven (T) energy over the full T3 tensor (0-d tensor)."""
    no = cc.no
    F, (ERI, L) = cc.H.F, eri_views(cc)
    t1, t2 = cc.t1, cc.t2
    o, v = slices(no)
    t3 = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
    X1, X2 = _vikings_X(F, ERI, L, t2, t3, no)
    ET = 2.0 * contract("ia,ia->", t1, X1)
    return ET + contract("ijab,ijab->", 4.0 * t2 - 2.0 * t2.swapaxes(2, 3), X2)


def t_vikings_inverted(cc):
    """Virtual-driven (T): the X tensors of `t_vikings` accumulated one
    virtual slab (fixed first virtual index of T3 and X2) at a time, a
    different reduction order kept as a numerical cross-check."""
    no = cc.no
    F, (ERI, L) = cc.H.F, eri_views(cc)
    t1, t2 = cc.t1, cc.t2
    o, v = slices(no)
    t3 = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
    td = t3 - _swap_ac(t3)
    T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e = 0.0
    for a in range(t3.shape[3]):
        X1a = contract("ijkbc,jkbc->i", td[:, :, :, a], L[o, o, v, v])
        X2a = contract("ijkbc,kc->ijb", td[:, :, :, a], F[o, v])
        X2a += contract("ijkbc,dkbc->ijd", T[:, :, :, a], ERI[v, o, v, v])
        X2a -= contract("ijkbc,jklc->ilb", T[:, :, :, a], ERI[o, o, o, v])
        e = e + 2.0 * contract("i,i->", t1[:, a], X1a)
        e = e + contract("ijb,ijb->", t2w[:, :, a], X2a)
    return e


def t_tjl(cc):
    """Lee/Rendell restricted-triples (T): one (v, v, v) block per
    occupied triple i >= j >= k, the a >= b >= c triangle of each block
    kept by a mask, and the degenerate triples weighted."""
    no, nv = cc.no, cc.nv
    F, ERI = cc.H.F, eri_views(cc)[0]
    t1, t2 = cc.t1, cc.t2
    o, v = slices(no)
    dt, dev = F.dtype, F.device

    a_ = torch.arange(nv, device=dev)
    dab = (a_[:, None, None] == a_[None, :, None]).to(dt)
    dac = (a_[:, None, None] == a_[None, None, :]).to(dt)
    dbc = (a_[None, :, None] == a_[None, None, :]).to(dt)
    Vdeg = 1.0 + dab + dac + dbc
    tri_abc = ((a_[:, None, None] >= a_[None, :, None])
               & (a_[None, :, None] >= a_[None, None, :]))

    Wvvvo = ERI[v, v, v, o]
    Wovoo = ERI[o, v, o, o]
    Woovv = ERI[o, o, v, v]
    Fov = F[o, v]
    eps = torch.diagonal(F)
    Fv = eps[no:]

    def P(x, perm):
        return x.permute(*perm)

    e = 0.0
    for i in range(no):
        for j in range(i + 1):
            for k in range(j + 1):
                W3 = contract("bae,ce->abc", Wvvvo[:, :, :, i], t2[k, j])
                W3 += contract("cae,be->abc", Wvvvo[:, :, :, i], t2[j, k])
                W3 += contract("ace,be->abc", Wvvvo[:, :, :, k], t2[j, i])
                W3 += contract("bce,ae->abc", Wvvvo[:, :, :, k], t2[i, j])
                W3 += contract("cbe,ae->abc", Wvvvo[:, :, :, j], t2[i, k])
                W3 += contract("abe,ce->abc", Wvvvo[:, :, :, j], t2[k, i])
                W3 -= contract("mc,mab->abc", Wovoo[:, :, j, k], t2[i])
                W3 -= contract("mb,mac->abc", Wovoo[:, :, k, j], t2[i])
                W3 -= contract("mb,mca->abc", Wovoo[:, :, i, j], t2[k])
                W3 -= contract("ma,mcb->abc", Wovoo[:, :, j, i], t2[k])
                W3 -= contract("ma,mbc->abc", Wovoo[:, :, k, i], t2[j])
                W3 -= contract("mc,mba->abc", Wovoo[:, :, i, k], t2[j])

                V3 = W3 + contract("ab,c->abc", Woovv[i, j], t1[k])
                V3 += contract("ac,b->abc", Woovv[i, k], t1[j])
                V3 += contract("bc,a->abc", Woovv[j, k], t1[i])
                V3 += contract("ab,c->abc", t2[i, j], Fov[k])
                V3 += contract("ac,b->abc", t2[i, k], Fov[j])
                V3 += contract("bc,a->abc", t2[j, k], Fov[i])
                V3 = V3 / Vdeg

                X3 = (W3 * V3
                      + P(W3, (0, 2, 1)) * P(V3, (0, 2, 1))
                      + P(W3, (1, 0, 2)) * P(V3, (1, 0, 2))
                      + P(W3, (1, 2, 0)) * P(V3, (1, 2, 0))
                      + P(W3, (2, 0, 1)) * P(V3, (2, 0, 1))
                      + P(W3, (2, 1, 0)) * P(V3, (2, 1, 0)))
                Y3 = V3 + P(V3, (1, 2, 0)) + P(V3, (2, 0, 1))
                Z3 = P(V3, (0, 2, 1)) + P(V3, (1, 0, 2)) + P(V3, (2, 1, 0))

                denom = (eps[i] + eps[j] + eps[k] - Fv[:, None, None]
                         - Fv[None, :, None] - Fv[None, None, :])
                w = 2.0 - ((i == j) + (i == k) + (j == k))
                term = ((Y3 - 2.0 * Z3) * (W3 + P(W3, (1, 2, 0))
                                           + P(W3, (2, 0, 1)))
                        + (Z3 - 2.0 * Y3) * (P(W3, (0, 2, 1))
                                             + P(W3, (1, 0, 2))
                                             + P(W3, (2, 1, 0)))
                        + 3.0 * X3)
                e = e + torch.where(tri_abc, term / denom, 0.0).sum() * w
    return e


# ---------------------------------------------------------------------------
# (T) contributions to the Lambda residuals and the one-/two-electron
# densities: the full-tensor form and the per-(i,j) slab scan
# ---------------------------------------------------------------------------

def _perm_v(t3, order):
    """Permute the three virtual axes (3,4,5) of the full T3 tensor."""
    axes = (0, 1, 2) + tuple(3 + "abc".index(c) for c in order)
    return t3.permute(*axes)


def _perm_o(t3, order):
    """Permute the three occupied axes (0,1,2)."""
    axes = tuple("ijk".index(c) for c in order) + (3, 4, 5)
    return t3.permute(*axes)


def _X3_v(M):
    return (8.0 * M - 4.0 * _perm_v(M, "bac") - 4.0 * _perm_v(M, "acb")
            - 4.0 * _perm_v(M, "cba") + 2.0 * _perm_v(M, "cab")
            + 2.0 * _perm_v(M, "bca"))


def _X3_o(M):
    return (8.0 * M - 4.0 * _perm_o(M, "jik") - 4.0 * _perm_o(M, "ikj")
            - 4.0 * _perm_o(M, "kji") + 2.0 * _perm_o(M, "kij")
            + 2.0 * _perm_o(M, "jki"))


def _require_dense(cc, what):
    """The full-tensor (T) density reads ERI slices, full or blocked: over
    DF factors it is t3_density_scan."""
    if getattr(cc, "storage", "full") == "df":
        raise ValueError("%s reads the full ERI; over DF factors the (T) "
                         "density is t3_density_scan" % what)


def _keep_t3_density(cc, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2):
    """Leave the (T) density blocks and Lambda sources on the ccwfn, where
    ccdensity and cclambda look for them."""
    cc.Doo_t3, cc.Dvv_t3, cc.Dov_t3 = Doo, Dvv, Dov
    cc.Goovv, cc.Gooov, cc.Gvvvo = Goovv, Gooov, Gvvvo
    cc.S1, cc.S2 = S1, S2


def t3_density(cc):
    """(T) corrections over the full T3 tensor (o^3 v^3 memory; small
    systems and tests): Lambda sources S1/S2, 1-pdm blocks Doo/Dvv/Dov,
    2-pdm blocks Goovv/Gooov/Gvvvo, kept on the ccwfn; returns E(T) as a
    0-d tensor."""
    _require_dense(cc, "t3_density")
    no = cc.no
    F, (ERI, L) = cc.H.F, eri_views(cc)
    t1, t2 = cc.t1, cc.t2
    o, v = slices(no)
    M = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
    N = t3d_full(t1, t2, ERI[o, o, v, v], F, no)
    X3 = _X3_v(M)
    Y3 = _X3_v(N)
    W = 2.0 * X3 + Y3
    Md_ac = M - _swap_ac(M)
    T = 2.0 * M - _swap_bc(M) - _swap_ac(M)

    X2 = contract("ijkabc,kc->ijab", Md_ac, F[o, v])
    X2 += contract("ijkabc,dkbc->ijad", T, ERI[v, o, v, v])
    X2 -= contract("ijkabc,jklc->ilab", T, ERI[o, o, o, v])

    Dvv = 0.5 * contract("ijkacd,ijkbcd->ab", M, X3 + Y3)
    Dov = contract("ijkabc,jkbc->ia", Md_ac, 4.0 * t2 - 2.0 * t2.swapaxes(2, 3))
    Z3 = 2.0 * M - 2.0 * _swap_bc(M) - _perm_v(M, "bac") + _perm_v(M, "bca")
    Goovv = 4.0 * contract("ijkabc,kc->ijab", Z3, t1)
    Gooov = -contract("ijkabc,lkbc->jila", W, t2)
    Gvvvo = contract("ijkabc,kicd->abdj", W, t2)

    S1 = 2.0 * contract("ijkabc,jkbc->ia", M - _perm_v(M, "bac"), L[o, o, v, v])
    S2 = -contract("ijkabc,jklc->ilab", W, ERI[o, o, o, v])
    S2 += contract("ijkabc,kdcb->ijad", W, ERI[o, v, v, v])
    S2 = S2 + S2.permute(1, 0, 3, 2)

    Doo = -0.5 * contract("iklabc,jklabc->ij", M, _X3_o(M) + _X3_o(N))

    ET = contract("ia,ia->", t1, S1)
    ET += contract("ijab,ijab->", 4.0 * t2 - 2.0 * t2.swapaxes(2, 3), X2)
    _keep_t3_density(cc, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2)
    return ET


def t3_density_energy(cc):
    """E(T) with the (T) density: the full-tensor form while o^3 v^3 is
    at most 2e8 elements, else the slab scan; the ccwfn's t3_scan
    (True/False) overrides the choice."""
    from .ccwfn import t3_slabs
    return t3_density_scan(cc) if t3_slabs(cc) else t3_density(cc)


def t3_lambda_sources(cc):
    """S1/S2 Lambda-residual sources for CCSD(T) (computes and keeps the
    whole (T) density set the first time)."""
    if getattr(cc, "S1", None) is None:
        t3_density_energy(cc)
    return cc.S1, cc.S2


# ---------------------------------------------------------------------------
# Memory-scalable (T): per-(i,j) T3 slabs
# ---------------------------------------------------------------------------

def slab_layouts(Wvvvo, Wovoo):
    """Occupied-major layouts for the slab builders, (i,b,a,e) and
    (j,k,m,c), as contiguous tensors."""
    return (Wvvvo.permute(3, 0, 1, 2).contiguous(),
            Wovoo.permute(2, 3, 0, 1).contiguous())


def _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i, j] slab (k,a,b,c) for fixed first two occupied indices.
    Takes the occupied-major layouts from `slab_layouts`."""
    Wi = Wvvvo_o[i]
    Wj = Wvvvo_o[j]
    t3 = contract("bae,kce->kabc", Wi, t2[:, j])
    t3 += contract("cae,kbe->kabc", Wi, t2[j])
    t3 += contract("kace,be->kabc", Wvvvo_o, t2[j, i])
    t3 += contract("kbce,ae->kabc", Wvvvo_o, t2[i, j])
    t3 += contract("cbe,kae->kabc", Wj, t2[i])
    t3 += contract("abe,kce->kabc", Wj, t2[:, i])
    t3 -= contract("kmc,mab->kabc", Wovoo_t[j], t2[i])
    t3 -= contract("kmb,mac->kabc", Wovoo_t[:, j], t2[i])
    t3 -= contract("mb,kmca->kabc", Wovoo_t[i, j], t2)
    t3 -= contract("ma,kmcb->kabc", Wovoo_t[j, i], t2)
    t3 -= contract("kma,mbc->kabc", Wovoo_t[:, i], t2[j])
    t3 -= contract("kmc,mba->kabc", Wovoo_t[i], t2[j])
    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return t3 / denom


def _t3c_slab(i, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i] slab (j,k,a,b,c) for a fixed first occupied index: the whole
    row of `_t3c_slab_ij`, o^2 v^3 elements.  Takes the occupied-major
    layouts from `slab_layouts`."""
    Wi = Wvvvo_o[i]
    t2i = t2[i]
    t2_i2 = t2[:, i]
    t3 = contract("bae,kjce->jkabc", Wi, t2)
    t3 += contract("cae,jkbe->jkabc", Wi, t2)
    t3 += contract("kace,jbe->jkabc", Wvvvo_o, t2_i2)
    t3 += contract("kbce,jae->jkabc", Wvvvo_o, t2i)
    t3 += contract("jcbe,kae->jkabc", Wvvvo_o, t2i)
    t3 += contract("jabe,kce->jkabc", Wvvvo_o, t2_i2)
    t3 -= contract("jkmc,mab->jkabc", Wovoo_t, t2i)
    t3 -= contract("kjmb,mac->jkabc", Wovoo_t, t2i)
    t3 -= contract("jmb,kmca->jkabc", Wovoo_t[i], t2)
    t3 -= contract("jma,kmcb->jkabc", Wovoo_t[:, i], t2)
    t3 -= contract("kma,jmbc->jkabc", Wovoo_t[:, i], t2)
    t3 -= contract("kmc,jmba->jkabc", Wovoo_t[i], t2)
    denom = (eps_o[i] + eps_o[:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    return t3 / denom


def _slab_pair_energy(t3, i, j, Evovv, Eooov, Loovv, Fov, t1, t2w):
    """(T) energy contribution of one external pair (i, j) from its
    (k,a,b,c) connected-T3 slab."""
    td = t3 - t3.swapaxes(1, 3)
    T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
    X1 = contract("kabc,kbc->a", td, Loovv[j])
    X2 = contract("kabc,kc->ab", td, Fov)
    X2 += contract("kabc,dkbc->ad", T, Evovv)
    X2l = contract("kabc,klc->lab", T, Eooov[j])
    e = 2.0 * contract("a,a->", t1[i], X1)
    e += contract("ab,ab->", t2w[i, j], X2)
    e -= contract("lab,lab->", t2w[i], X2l)
    return e


def _t_vikings_row(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps,
                   t1, t2, no):
    """One fixed-i row of the (T) energy: every ordered pair (i, j)."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e = 0.0
    for j in range(no):
        t3 = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        e = e + _slab_pair_energy(t3, i, j, Evovv, Eooov, Loovv, Fov, t1,
                                  t2w)
    return e


def _t3c_slab_iJ(i, j0, jc, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i, j0:j0+jc] chunk (j,k,a,b,c): jc stacked `_t3c_slab_ij` slabs,
    each contraction one product over the whole chunk."""
    J = slice(j0, j0 + jc)
    Wi = Wvvvo_o[i]
    t2i = t2[i]
    t2_i2 = t2[:, i]
    WJ = Wvvvo_o[J]
    t2J = t2[J]
    t2_J2 = t2[:, J]
    t3 = contract("bae,kjce->jkabc", Wi, t2_J2)
    t3 += contract("cae,jkbe->jkabc", Wi, t2J)
    t3 += contract("kace,jbe->jkabc", Wvvvo_o, t2_i2[J])
    t3 += contract("kbce,jae->jkabc", Wvvvo_o, t2i[J])
    t3 += contract("jcbe,kae->jkabc", WJ, t2i)
    t3 += contract("jabe,kce->jkabc", WJ, t2_i2)
    t3 -= contract("jkmc,mab->jkabc", Wovoo_t[J], t2i)
    t3 -= contract("kjmb,mac->jkabc", Wovoo_t[:, J], t2i)
    t3 -= contract("jmb,kmca->jkabc", Wovoo_t[i, J], t2)
    t3 -= contract("jma,kmcb->jkabc", Wovoo_t[J, i], t2)
    t3 -= contract("kma,jmbc->jkabc", Wovoo_t[:, i], t2J)
    t3 -= contract("kmc,jmba->jkabc", Wovoo_t[i], t2J)
    denom = (eps_o[i] + eps_o[J][:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    return t3 / denom


def _chunk_pair_energies(t3, Lext, Eext, Fov, Evovv, t1e, t2we, t2wr):
    """Per-j (T) energies of a (j,k,a,b,c) chunk against one set of
    external operands (j-windows for the (i,j) role, the fixed-i row
    broadcast to the chunk for the (j,i) role).  Returns e[j]."""
    td = t3 - t3.swapaxes(2, 4)
    T = 2.0 * t3 - t3.swapaxes(3, 4) - t3.swapaxes(2, 4)
    X1 = contract("jkabc,jkbc->ja", td, Lext)
    X2 = contract("jkabc,kc->jab", td, Fov)
    X2 += contract("jkabc,dkbc->jad", T, Evovv)
    X2l = contract("jkabc,jklc->jlab", T, Eext)
    # the X intermediates are small (j-window x v^2): the scalar
    # contractions run in float32 under bf16 slabs, as pycc_tpu's do
    up = torch.float32 if X1.dtype == torch.bfloat16 else X1.dtype
    e = 2.0 * contract("ja,ja->j", t1e.to(up), X1.to(up))
    e += contract("jab,jab->j", t2we.to(up), X2.to(up))
    e -= contract("jlab,jlab->j", t2wr.to(up), X2l.to(up))
    return e


def _t_vikings_row_sym_jc(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov,
                          eps, t1, t2, no, jc):
    """Fixed-i (T) row, j-chunked and pair-symmetric: t3[j,i,k]^{abc} =
    t3[i,j,k]^{bac}, so a slab built for j >= i serves both the (i,j) and
    the (j,i) contributions.  Chunks of jc tile [0, no) from the one that
    holds i; per-j masks keep the triangle.  Requires jc | no."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e = 0.0
    for c in range(i // jc, no // jc):
        j0 = c * jc
        J = slice(j0, j0 + jc)
        jj = list(range(j0, j0 + jc))
        t3 = _t3c_slab_iJ(i, j0, jc, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        e_ij = _chunk_pair_energies(
            t3, Loovv[J], Eooov[J], Fov, Evovv,
            t1[i].expand((jc,) + t1[i].shape), t2w[i, J],
            t2w[i].expand((jc,) + t2w[i].shape))
        e_ji = _chunk_pair_energies(
            t3.swapaxes(2, 3), Loovv[i].expand((jc,) + Loovv[i].shape),
            Eooov[i].expand((jc,) + Eooov[i].shape), Fov, Evovv,
            t1[J], t2w[J, i], t2w[J])
        for n, j in enumerate(jj):
            if j >= i:
                e = e + e_ij[n]
            if j > i:
                e = e + e_ji[n]
    return e


def t_scan_flops(no, nv, sym=True):
    """Analytic flop count of the slab-scan (T) energy (pycc_tpu's count):
    per (i,j) slab, six 2*no*nv^4 W-terms, six 2*no^2*nv^3 Wovoo terms and
    the no*nv^3 denominator; per consumed ordered pair, the 2*no*nv^4 Evovv
    product, the td/T assembly and the small X contractions."""
    pairs = no * (no + 1) // 2 if sym else no * no
    per_slab = (12.0 * no * nv ** 4 + 12.0 * no ** 2 * nv ** 3
                + no * nv ** 3)
    per_energy = (2.0 * no * nv ** 4 + 2.0 * no ** 2 * nv ** 3
                  + 10.0 * no * nv ** 3)
    n_energy = no * no
    return pairs * per_slab + n_energy * per_energy


def t_vikings_scan_core(Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps,
                        t1, t2, no, sym=True, slab_dtype=None, jc=None):
    """Slice-fed (T) energy, the plain slab scan, as a 0-d tensor.

    sym=True builds each T3 slab once per unordered pair, jc j-values at a
    time (default 2 when no is even, else 1; jc must divide no); sym=False
    walks every ordered pair.  slab_dtype (torch.bfloat16) casts the
    slices, t1 and t2 to it, as pycc_tpu's does: the slabs are built and
    consumed in that type, and the pair energies and their sum are
    accumulated in float32."""
    if slab_dtype is not None:
        (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t1, t2) = (
            x.to(slab_dtype) for x in (Wvvvo_o, Wovoo_t, Evovv, Eooov,
                                       Loovv, Fov, eps, t1, t2))
    if sym:
        if jc is None:
            jc = 2 if no % 2 == 0 else 1
        if no % jc:
            raise ValueError("jc=%d must divide no=%d" % (jc, no))
    e = 0.0
    for i in range(no):
        if sym:
            e = e + _t_vikings_row_sym_jc(i, Wvvvo_o, Wovoo_t, Evovv, Eooov,
                                          Loovv, Fov, eps, t1, t2, no, jc)
        else:
            e = e + _t_vikings_row(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv,
                                   Fov, eps, t1, t2, no)
    return e


def scan_slices(cc):
    """The integral slices the (T) row scan consumes, cut once from the
    full ERI/L, or under storage='blocked' from the block views, as
    contiguous tensors on cc's device: (Wvvvo_o, Wovoo_t, Evovv, Eooov,
    Loovv, Fov, eps)."""
    o, v = slices(cc.no)
    (ERI, L), F = eri_views(cc), cc.H.F
    Wvvvo_o, Wovoo_t = slab_layouts(ERI[v, v, v, o], ERI[o, v, o, o])
    return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v].contiguous(),
            ERI[o, o, o, v].contiguous(), L[o, o, v, v].contiguous(),
            F[o, v].contiguous(), F.diagonal().contiguous())


def t_scan_df_slices(F, Boo, Bov, Bvv, no):
    """The five integral slices (plus Fov and diag F) the (T) row scan
    consumes, assembled from Cholesky/DF factors as contiguous tensors on
    the factors' device, in the layouts `scan_slices` cuts from the full
    ERI: Dirac <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s]."""
    o, v = slices(no)
    Bvv = dense(Bvv)            # whole (assembled on a mesh)
    Wvvvo_o = contract("Pac,Pib->iabc", Bvv, Bov).contiguous()
    Wovoo_t = contract("Pij,Pka->jkia", Boo, Bov).contiguous()
    Evovv = contract("Pab,Pic->aibc", Bvv, Bov).contiguous()
    Eooov = contract("Pik,Pja->ijka", Boo, Bov).contiguous()
    Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
    Loovv = (2.0 * Eoovv - Eoovv.swapaxes(2, 3)).contiguous()
    return (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, F[o, v].contiguous(),
            F.diagonal().contiguous())


# pycc_tpu's (T) over DF factors takes its k-chunked path past this many
# no nv^3 elements, and that path ignores slab_dtype
DF_SLAB_DTYPE_MAX = 2 ** 27


def t_vikings_scan(cc, slab_dtype=None, jc=None,
                   df_slab_max=DF_SLAB_DTYPE_MAX):
    """The (T) energy of a converged ccwfn, as a 0-d tensor: the slices
    once (cut from the full ERI or the blocked views, or under
    storage='df' assembled from the factors by `t_scan_df_slices`), then
    one K2 row per occupied index (the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors).

    pycc_tpu's signature.  slab_dtype=torch.bfloat16 streams the K2 rows
    in bfloat16 with float32 accumulation (`t_vikings_rows(stream_dtype=)`,
    what the Pallas kernel computes); the result is then float32.  jc, the
    j-chunk of the plain symmetric scan (`t_vikings_scan_core`), changes
    nothing here: K2's driver has no j-chunk.  Over DF factors past
    no nv^3 > df_slab_max (2^27, pycc_tpu's switch to its k-chunked path,
    which ignores slab_dtype) slab_dtype is ignored too, and the rows
    stream in the working dtype."""
    storage = getattr(cc, "storage", "full")
    from .ops.kernels.triples import t_vikings_rows
    if storage == "df":
        if cc.no * cc.t2.shape[-1] ** 3 > df_slab_max:
            slab_dtype = None
        sl = t_scan_df_slices(cc.H.F, *cc.dfb, cc.no)
    else:
        sl = scan_slices(cc)
    return t_vikings_rows(*sl, cc.t1, cc.t2, cc.no, stream_dtype=slab_dtype)


# ---------------------------------------------------------------------------
# The (T) density from per-(i,j) slabs
# ---------------------------------------------------------------------------

def _perm_v_slab(s, order):
    """Permute the three virtual axes (1,2,3) of a (k,a,b,c) slab."""
    axes = (0,) + tuple(1 + "abc".index(c) for c in order)
    return s.permute(*axes)


# X3 combination (8 - 4 P_ab - 4 P_bc - 4 P_ac + 2 P_cab + 2 P_bca)
_X3_TERMS = ((-4.0, "bac"), (-4.0, "acb"), (-4.0, "cba"), (2.0, "cab"),
             (2.0, "bca"))


def _X3_v_slab(s):
    """X3 of a (k,a,b,c) slab, formed explicitly (one slab of memory)."""
    out = 8.0 * s
    for c, order in _X3_TERMS:
        out.add_(_perm_v_slab(s, order), alpha=c)
    return out


def _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v):
    """Disconnected T3[i, j] slab (k,a,b,c)."""
    t3 = contract("ab,kc->kabc", Eoovv[i, j], t1)
    t3 += contract("kac,b->kabc", Eoovv[i], t1[j])
    t3 += contract("kbc,a->kabc", Eoovv[j], t1[i])
    t3 += contract("ab,kc->kabc", t2[i, j], Fov)
    t3 += contract("kac,b->kabc", t2[i], Fov[j])
    t3 += contract("kbc,a->kabc", t2[j], Fov[i])
    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return t3 / denom


def density_slices(cc):
    """The integral slices the (T)-density scan consumes, as contiguous
    tensors on cc's device: (Wvvvo_o, Wovoo_t, Evovv, Eooov, Eoovv, Loovv,
    Fov, eps), cut once from the full ERI/L or the blocked views or,
    under storage='df',
    assembled from the factors (`t_scan_df_slices` and <oo|vv>)."""
    o, v = slices(cc.no)
    if getattr(cc, "storage", "full") == "df":
        Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps = t_scan_df_slices(
            cc.H.F, *cc.dfb, cc.no)
        Bov = cc.dfb.Bov
        Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
    else:
        Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps = scan_slices(cc)
        Eoovv = eri_views(cc)[0][o, o, v, v].contiguous()
    return (Wvvvo_o, Wovoo_t, Evovv, Eooov, Eoovv, Loovv, Fov, eps)


def t3_density_scan(cc):
    """The nine outputs of `t3_density` (kept on the ccwfn the same way)
    with O(o v^3) working memory: one connected and one disconnected slab
    per ordered (i, j) pair feed every accumulation
    (`t3_density_scan_core`), on slices cut from the full ERI or
    assembled from DF factors.  Returns E(T) as a 0-d tensor."""
    ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2 = t3_density_scan_core(
        *density_slices(cc), cc.t1, cc.t2, cc.no)
    _keep_t3_density(cc, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2)
    return ET


def _t3_density_pair(i, j, acc, Wvvvo_o, Wovoo_t, Evovv, Eooov, Eoovv,
                     Loovv, Fov, eps_o, eps_v, t1, t2, tt):
    """Every (T)-density accumulation of one ordered pair (i, j), in place
    on `acc`, from its slabs M (connected) and N (disconnected).

    The occupied-permutation combination of the full form's Doo is
    rewritten on the same slab: T3 is unchanged by one permutation applied
    to its occupied and virtual axes together, and X3 commutes with the
    virtual ones, so sum_{klabc} M[i,k,l,abc] X3_o(M+N)[j,k,l,abc] is the
    sum over slabs (k, l) of M[i,abc] X3_v(M+N)[j,abc].  Likewise
    Eovvv[k,d,c,b] = <kd|cb> = Evovv[d,k,b,c], so S2's vvv term reuses
    Evovv."""
    X2, Dvv, Dov, Goovv, S1, Gooov, Gvvvo_t, S2, Doo = acc
    M = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
    N = _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v)

    M_ac = M.swapaxes(1, 3)
    Md = M - M_ac
    T = 2.0 * M - M.swapaxes(2, 3) - M_ac
    X2[i, j] += (contract("kabc,kc->ab", Md, Fov)
                 + contract("kabc,dkbc->ad", T, Evovv))
    X2[i] -= contract("kabc,klc->lab", T, Eooov[j])
    Dov[i] += contract("kabc,kbc->a", Md, tt[j])
    del Md, T

    Z3 = (2.0 * (M - M.swapaxes(2, 3)) - M.swapaxes(1, 2)
          + _perm_v_slab(M, "bca"))
    Goovv[i, j] += 4.0 * contract("kabc,kc->ab", Z3, t1)
    del Z3
    S1[i] += 2.0 * contract("kabc,kbc->a", M - M.swapaxes(1, 2), Loovv[j])

    X = _X3_v_slab(M + N)
    Dvv += 0.5 * contract("kacd,kbcd->ab", M, X)
    Doo -= 0.5 * contract("xabc,yabc->xy", M, X)
    del X

    W = _X3_v_slab(2.0 * M + N)
    del M, N
    Gooov[j, i] -= contract("kabc,lkbc->la", W, t2)
    Gvvvo_t[j] += contract("kabc,kcd->abd", W, t2[:, i])
    S2[i] -= contract("kabc,klc->lab", W, Eooov[j])
    S2[i, j] += contract("kabc,dkbc->ad", W, Evovv)


def t3_density_scan_core(Wvvvo_o, Wovoo_t, Evovv, Eooov, Eoovv, Loovv, Fov,
                         eps, t1, t2, no):
    """Slice-fed (T)-density core: returns (ET, Doo, Dvv, Dov, Goovv,
    Gooov, Gvvvo, S1, S2).  One pass per ordered pair (i, j): its two
    slabs are built once and X3 of each combination formed explicitly
    (o v^3 elements each), and every consumer contracts them once."""
    nv = Fov.shape[1]
    z = dict(dtype=Fov.dtype, device=Fov.device)
    acc = (torch.zeros((no, no, nv, nv), **z), torch.zeros((nv, nv), **z),
           torch.zeros((no, nv), **z), torch.zeros((no, no, nv, nv), **z),
           torch.zeros((no, nv), **z), torch.zeros((no, no, no, nv), **z),
           torch.zeros((no, nv, nv, nv), **z),
           torch.zeros((no, no, nv, nv), **z), torch.zeros((no, no), **z))
    eps_o, eps_v = eps[:no], eps[no:]
    tt = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    for i in range(no):
        for j in range(no):
            _t3_density_pair(i, j, acc, Wvvvo_o, Wovoo_t, Evovv, Eooov,
                             Eoovv, Loovv, Fov, eps_o, eps_v, t1, t2, tt)
    X2, Dvv, Dov, Goovv, S1, Gooov, Gvvvo_t, S2, Doo = acc
    Gvvvo = Gvvvo_t.permute(1, 2, 3, 0)
    S2 = S2 + S2.permute(1, 0, 3, 2)
    ET = contract("ia,ia->", t1, S1) + contract("ijab,ijab->", tt, X2)
    return ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2


# ---------------------------------------------------------------------------
# The k-chunked (T) from factors: one resident (o, v, v, v) integral tensor
# ---------------------------------------------------------------------------

def _dslice(x, k0, kc):
    """The leading-axis window [k0, k0+kc) of an operand of any rank."""
    return x[k0:k0 + kc]


def _t3c_chunk_ij(i, j, k0, kc, W, Wovoo_t, t2, eps_o, eps_v):
    """_t3c_slab_ij restricted to the k-window [k0, k0+kc): (K,a,b,c).

    W is Wvvvo in the occupied-major kace assembly (== slab_layouts'
    Wvvvo_o): W[i] has exactly the (a,b,c) layout the Wi/Wj terms use,
    and the full-k terms take the k-window."""
    K = slice(k0, k0 + kc)
    Wi, Wj, WK = W[i], W[j], W[K]
    t3 = contract("bae,kce->kabc", Wi, t2[K, j])
    t3 += contract("cae,kbe->kabc", Wi, t2[j, K])
    t3 += contract("kace,be->kabc", WK, t2[j, i])
    t3 += contract("kbce,ae->kabc", WK, t2[i, j])
    t3 += contract("cbe,kae->kabc", Wj, t2[i, K])
    t3 += contract("abe,kce->kabc", Wj, t2[K, i])
    t3 -= contract("kmc,mab->kabc", Wovoo_t[j, K], t2[i])
    t3 -= contract("kmb,mac->kabc", Wovoo_t[K, j], t2[i])
    t3 -= contract("mb,kmca->kabc", Wovoo_t[i, j], t2[K])
    t3 -= contract("ma,kmcb->kabc", Wovoo_t[j, i], t2[K])
    t3 -= contract("kma,mbc->kabc", Wovoo_t[K, i], t2[j])
    t3 -= contract("kmc,mba->kabc", Wovoo_t[i, K], t2[j])
    denom = (eps_o[i] + eps_o[j] + eps_o[K][:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return t3 / denom


def _chunk_X(t3, WK, Lj_k, Fov_k, Ej_k):
    """X1/X2/X2l increments of one k-chunk slab for one external pair.
    Evovv[d,k,b,c] = (db|kc) = W[k,d,c,b], a label permutation of the
    same resident tensor, so no second (o, v, v, v) tensor is needed."""
    td = t3 - t3.swapaxes(1, 3)
    T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
    X1 = contract("kabc,kbc->a", td, Lj_k)
    X2 = contract("kabc,kc->ab", td, Fov_k)
    X2 += contract("kabc,kdcb->ad", T, WK)
    X2l = contract("kabc,klc->lab", T, Ej_k)
    return X1, X2, X2l


def _t_df_row_chunked(i, W, Wovoo_t, Eooov, Loovv, Fov, eps, t1, t2, no,
                      kc):
    """One fixed-i row of the (T) energy with k-chunked slabs, using the
    pair-permutation symmetry (see _t_vikings_row_sym_jc): each chunk slab
    built for j >= i feeds both the (i,j) and the (j,i) accumulators, so
    the n^7 slab build runs once per unordered pair."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e = 0.0
    for j in range(i, no):
        Xij = Xji = None
        for k0 in range(0, no, kc):
            K = slice(k0, k0 + kc)
            t3 = _t3c_chunk_ij(i, j, k0, kc, W, Wovoo_t, t2, eps_o, eps_v)
            dij = _chunk_X(t3, W[K], Loovv[j, K], Fov[K], Eooov[j, K])
            dji = _chunk_X(t3.swapaxes(1, 2), W[K], Loovv[i, K], Fov[K],
                           Eooov[i, K])
            Xij = dij if Xij is None else tuple(
                x + d for x, d in zip(Xij, dij))
            Xji = dji if Xji is None else tuple(
                x + d for x, d in zip(Xji, dji))
        X1, X2, X2l = Xij
        e = e + (2.0 * contract("a,a->", t1[i], X1)
                 + contract("ab,ab->", t2w[i, j], X2)
                 - contract("lab,lab->", t2w[i], X2l))
        if j > i:
            Y1, Y2, Y2l = Xji
            e = e + (2.0 * contract("a,a->", t1[j], Y1)
                     + contract("ab,ab->", t2w[j, i], Y2)
                     - contract("lab,lab->", t2w[j], Y2l))
    return e


def _t_df_kc(no, nv, max_elems=2 ** 26):
    """Largest divisor of no whose chunk slab (kc, v, v, v) stays under
    max_elems elements (the symmetric row holds ~7 chunk-sized temps)."""
    cap = max(1, int(max_elems // max(1, nv ** 3)))
    kc = 1
    for d in range(1, no + 1):
        if no % d == 0 and d <= cap:
            kc = d
    return kc


def t_vikings_scan_df_chunked(dfb, F, t1, t2, no, kc=None):
    """(T) from factors with ONE resident (o, v, v, v) integral tensor and
    k-chunked slabs, as a plain 0-d tensor: Wvvvo in the kace assembly
    serves the slab terms (W[i] is exactly the Wi layout) and the Evovv
    energy term ((ac|bk) and (db|kc) are label permutations of the same
    factor product).  Working set W + ~7 chunk slabs, against the two
    (o, v, v, v) slices (and K2's G) of `t_vikings_scan`; it gives the
    same energy.  Called explicitly; nothing chooses it by size.  kc must
    divide no (default `_t_df_kc`)."""
    nv = F.shape[0] - no
    if kc is None:
        kc = _t_df_kc(no, nv)
    if no % kc:
        raise ValueError("kc=%d must divide no=%d" % (kc, no))
    Boo, Bov, Bvv = whole_bvv(dfb)
    # one (v, v, v) sheet at a time: W[k,a,c,e] = sum_P Bvv[P,a,e] Bov[P,k,c]
    W = torch.empty((no, nv, nv, nv), dtype=Bvv.dtype, device=Bvv.device)
    for k in range(no):
        W[k] = contract("Pae,Pc->ace", Bvv, Bov[:, k])
    Wovoo_t = contract("Pij,Pka->jkia", Boo, Bov)
    Eooov = contract("Pik,Pja->ijka", Boo, Bov)
    Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
    Loovv = 2.0 * Eoovv - Eoovv.swapaxes(2, 3)
    Fov = F[:no, no:]
    eps = F.diagonal()
    e = 0.0
    for i in range(no):
        e = e + _t_df_row_chunked(i, W, Wovoo_t, Eooov, Loovv, Fov, eps,
                                  t1, t2, no, kc)
    return e
