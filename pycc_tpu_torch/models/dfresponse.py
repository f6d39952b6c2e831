"""CC linear-response residuals over DF/Cholesky factors.

The counterpart of pycc_tpu/models/dfresponse.py, term for term.  The
dense response stack (ccresponse.py) reads the three HBAR blocks that
cannot exist at DF sizes (Hvovv and Hvvvo, o v^3; Hvvvv, v^4) and the
similarity-transformed perturbation block Avvvo (o v^3).  This module
re-derives every consumer over the dressed Cholesky factors
(models/dfhbar.py):

- the right-hand residual is the EOM sigma plus the inhomogeneous A
  terms, r_X = A - omega X + sigma(X), so `rX_df` reuses
  `sigma1_df`/`sigma2_df`;
- the left-hand residual r_Y has the Lambda residual's structure, so
  `rY_df` reuses the Lambda helpers (`r1_l2_hvvvo`, `r1_gvv_hvovv`,
  `r2_l1_hvovv`, `hvvvv_x2_df`);
- the one-time inhomogeneous terms `inY1_df`/`inY2_df` are re-derived term
  by term; the largest temporary is (naux, v, v), or one g-block of
  `_gaef_hvovv`.

Every Hvvvv ladder goes through `dfhbar.ladder_apply`: one `ladder` call
(the K1 kernel by default) an a-block, a complex X2/Y2 as its real and
imaginary rows stacked.
"""

import torch

from ..ops.contract import contract
from ..ops.kernels.vvvv import vvvv_nt
from ..parallel.mesh import dense
from .ccsd import pair_symmetric
from .dfhbar import (_ea_layout, hvvvv_x2_df, ladder_apply,
                     r1_gvv_hvovv, r1_l2_hvvvo, r2_l1_hvovv, sigma1_df,
                     sigma2_df, zvv_c1_hvovv)


def _goo(t2, l2):
    return contract("mjab,ijab->mi", t2, l2)


def _gvv(t2, l2):
    return -1.0 * contract("ijeb,ijab->ae", t2, l2)


# ---------------------------------------------------------------------------
# right-hand residual: r_X = A - omega*X + sigma(X)
# ---------------------------------------------------------------------------

def rX_df(dfh, Loovv, t1, t2, Ad, omega, X1, X2, no, nblocks=None,
          ladder=vvvv_nt):
    """The DF form of ccresponse.r_X: the perturbed-amplitude residual is
    the EOM sigma shifted by omega plus the pertbar inhomogeneity, so the
    big-block work is sigma1_df/sigma2_df (its ladder one `ladder` call an
    a-block)."""
    r1 = Ad["Avo"].T - omega * X1 + sigma1_df(dfh, X1, X2, Loovv, no)
    r2 = sigma2_df(dfh, X1, X2, Loovv, t1, t2, no, nblocks=nblocks,
                   ladder=ladder)
    r2 = r2 + 2 * pair_symmetric(Ad["Avvoo"])
    r2 = r2 - omega * pair_symmetric(X2)
    return r1, r2


# ---------------------------------------------------------------------------
# left-hand iterated residual: r_Y (the Lambda-shaped equations)
# ---------------------------------------------------------------------------

def rY_df(dfh, Loovv, t1, t2, imY1, imY2, omega, Y1, Y2, no, nblocks=None,
          ladder=vvvv_nt):
    """The DF form of ccresponse.r_Y: the Lambda helper set with (l1, l2)
    -> (Y1, Y2)."""
    Goo = _goo(t2, Y2)
    Gvv = _gvv(t2, Y2)

    r1 = imY1 + omega * Y1
    r1 += contract("ie,ea->ia", Y1, dfh.Hvv)
    r1 -= contract("im,ma->ia", dfh.Hoo, Y1)
    r1 += 2.0 * contract("ieam,me->ia", dfh.Hovvo, Y1)
    r1 -= contract("iema,me->ia", dfh.Hovov, Y1)
    r1 += r1_l2_hvvvo(dfh, t1, t2, Y2, dfh.Hov)
    r1 -= contract("iemn,mnae->ia", dfh.Hovoo, Y2)
    r1 += r1_gvv_hvovv(dfh, Gvv)
    r1 -= 2.0 * contract("mn,mina->ia", Goo, dfh.Hooov)
    r1 += contract("mn,imna->ia", Goo, dfh.Hooov)

    r2 = imY2 + 0.5 * omega * Y2
    r2 += 2.0 * contract("ia,jb->ijab", Y1, dfh.Hov)
    r2 -= contract("ja,ib->ijab", Y1, dfh.Hov)
    r2 += contract("ijeb,ea->ijab", Y2, dfh.Hvv)
    r2 -= contract("im,mjab->ijab", dfh.Hoo, Y2)
    r2 += 0.5 * contract("ijmn,mnab->ijab", dfh.Hoooo, Y2)
    r2 += hvvvv_x2_df(dfh, t2, Y2, nblocks=nblocks, ladder=ladder)
    r2 += r2_l1_hvovv(dfh, Y1)
    r2 -= 2.0 * contract("mb,jima->ijab", Y1, dfh.Hooov)
    r2 += contract("mb,ijma->ijab", Y1, dfh.Hooov)
    r2 += 2.0 * contract("ieam,mjeb->ijab", dfh.Hovvo, Y2)
    r2 -= contract("iema,mjeb->ijab", dfh.Hovov, Y2)
    r2 -= contract("mibe,jema->ijab", Y2, dfh.Hovov)
    r2 -= contract("mieb,jeam->ijab", Y2, dfh.Hovvo)
    r2 += contract("ijeb,ae->ijab", Loovv, Gvv)
    r2 -= contract("mi,mjab->ijab", Goo, Loovv)
    return r1, 2 * pair_symmetric(r2)


# ---------------------------------------------------------------------------
# one-time inhomogeneous Y terms
# ---------------------------------------------------------------------------

def _gaef_hvovv(dfh, l2, X2, nblocks=None):
    """-sum 'gief,gaef->ia' with tmp[gaef] = l2[mnga] X2[mnef]: the dense
    path forms a v^4 temporary (ccresponse.in_Y1).  g-blocked (nblocks
    blocks of g, default v // 32): U[P,a,f] = sum_ge Bd[P,g,e] tmp[g,a,e,f]
    accumulated a block at a time, then -U[P,a,f] Bov[P,i,f]."""
    Bd, Bov = dense(dfh.Bd_ae), dfh.df.Bov
    naux, nv = Bd.shape[0], Bd.shape[1]
    if nblocks is None:
        nblocks = max(1, nv // 32)
    blk = -(-nv // nblocks)
    dt = torch.promote_types(torch.promote_types(Bd.dtype, l2.dtype),
                             X2.dtype)
    U = torch.zeros((naux, nv, nv), dtype=dt, device=Bd.device)
    for g0 in range(0, nv, blk):
        g1 = min(nv, g0 + blk)
        tmp = contract("mnga,mnef->gaef", l2[:, :, g0:g1, :], X2)
        U += contract("Pge,gaef->Paf", Bd[:, g0:g1, :], tmp)
        del tmp
    return -1.0 * contract("Paf,Pif->ia", U, Bov)


def inY1_df(dfh, Loovv, Eoovv, t1, t2, l1, l2, Ad, pert_ov, X1, X2, no,
            nblocks=None):
    """The DF form of ccresponse.in_Y1.  Every Hvovv/Hvvvv/Avvvo
    contraction is re-derived over the factors; the explicit HBAR blocks
    (<= o^3 v) and the factor-assembled Loovv are used as they are.  The
    comments carry the dense einsum each term replaces.  nblocks is the
    g-blocking of `_gaef_hvovv`."""
    Bov, Bd = dfh.df.Bov, dense(dfh.Bd_ae)
    Hooov_s = 2.0 * dfh.Hooov - dfh.Hooov.swapaxes(0, 1)

    r = 2.0 * Ad["Aov"]
    r = r - contract("im,ma->ia", Ad["Aoo"], l1)
    r = r + contract("ie,ea->ia", l1, Ad["Avv"])
    # 'imfe,feam->ia' over Avvvo[feam] = -t2[nmfe] pert[na]
    r = r - contract("in,na->ia", contract("imfe,nmfe->in", l2, t2), pert_ov)
    r = r - 0.5 * contract("ienm,mnea->ia", Ad["Aovoo"], l2)
    r = r - 0.5 * contract("iemn,mnae->ia", Ad["Aovoo"], l2)

    r = r + 2.0 * contract("imae,me->ia", Loovv, X1)

    # the tmp[miae] . X1[me] block: Hov / Hooov explicit; the two Hvovv_s
    # terms ('fmae,if->miae' and 'fiea,mf->miae') factor-implicit
    tmp = -1.0 * contract("ma,ie->miae", dfh.Hov, l1)
    tmp -= contract("ma,ie->miae", l1, dfh.Hov)
    tmp -= contract("mina,ne->miae", Hooov_s, l1)
    tmp -= contract("imne,na->miae", Hooov_s, l1)
    r = r + contract("miae,me->ia", tmp, X1)
    #   + l1[if] Hvovv_s[fmae] X1[me]
    sP = contract("Pme,me->P", Bov, X1)
    C = contract("if,Pfa->Pia", l1, Bd)
    r = r + 2.0 * contract("Pia,P->ia", C, sP)
    D = contract("if,Pfe->Pie", l1, Bd)
    H1 = contract("Pie,me->Pim", D, X1)
    r = r - contract("Pim,Pma->ia", H1, Bov)
    #   + l1[mf] Hvovv_s[fiea] X1[me]
    D2 = contract("mf,Pfe->Pme", l1, Bd)
    s1 = contract("Pme,me->P", D2, X1)
    r = r + 2.0 * contract("P,Pia->ia", s1, Bov)
    E = contract("mf,Pfa->Pma", l1, Bd)
    V = contract("Pie,me->Pim", Bov, X1)
    r = r - contract("Pim,Pma->ia", V, E)

    # the X2/l1 quadratic terms (Loovv explicit)
    tmp = 2.0 * contract("mnef,nf->me", X2, l1)
    tmp -= contract("mnfe,nf->me", X2, l1)
    r = r + contract("imae,me->ia", Loovv, tmp)
    r = r - contract("ni,na->ia", _goo(X2, Loovv), l1)
    r = r + contract("ie,ea->ia", l1, _gvv(Loovv, X2))

    # the tmp[iema] . X1[me] block: Hovov/Hovvo/Hoooo explicit ...
    tmp = -1.0 * contract("nief,mfna->iema", l2, dfh.Hovov)
    tmp -= contract("ifne,nmaf->iema", dfh.Hovov, l2)
    tmp -= contract("inef,mfan->iema", l2, dfh.Hovvo)
    tmp -= contract("ifen,nmfa->iema", dfh.Hovvo, l2)
    tmp += 0.5 * contract("imno,onea->iema", dfh.Hoooo, l2)
    tmp += 0.5 * contract("mino,noea->iema", dfh.Hoooo, l2)
    r = r + contract("iema,me->ia", tmp, X1)
    # ... and the two Hvvvv pieces factor-implicit:
    #   0.5 l2[imfg] Hvvvv[fgae] X1[me], Hvvvv[fgae] = Bd[Pfa] Bd[Pge]
    #                                   + t2[pqfg] (pa|qe)
    D1 = contract("me,Pge->Pmg", X1, Bd)
    E1 = contract("imfg,Pmg->Pif", l2, D1)
    r = r + 0.5 * contract("Pif,Pfa->ia", E1, Bd)
    K1 = contract("imfg,pqfg->impq", l2, t2)
    W1 = contract("Pqe,me->Pqm", Bov, X1)
    U1 = contract("impq,Pqm->Pip", K1, W1)
    r = r + 0.5 * contract("Pip,Ppa->ia", U1, Bov)
    #   0.5 l2[imgf] Hvvvv[fgea] X1[me], Hvvvv[fgea] = Bd[Pfe] Bd[Pga]
    #                                   + t2[pqfg] (pe|qa)
    D2b = contract("me,Pfe->Pmf", X1, Bd)
    E2 = contract("imgf,Pmf->Pig", l2, D2b)
    r = r + 0.5 * contract("Pig,Pga->ia", E2, Bd)
    K2 = contract("imgf,pqfg->impq", l2, t2)
    W2 = contract("Ppe,me->Ppm", Bov, X1)
    U2 = contract("impq,Ppm->Piq", K2, W2)
    r = r + 0.5 * contract("Piq,Pqa->ia", U2, Bov)

    # the X1 . Gvv/Goo(t2, l2) terms (explicit)
    Gvv_l2t2 = _gvv(l2, t2)
    Goo_t2l2 = _goo(t2, l2)
    tmp = contract("nb,fb->nf", X1, Gvv_l2t2)
    r = r + contract("inaf,nf->ia", Loovv, tmp)
    tmp = contract("me,fa->mefa", X1, Gvv_l2t2)
    r = r + contract("mief,mefa->ia", Loovv, tmp)
    tmp = contract("me,ni->meni", X1, Goo_t2l2)
    r = r - contract("meni,mnea->ia", tmp, Loovv)
    tmp = contract("jf,nj->fn", X1, Goo_t2l2)
    r = r - contract("inaf,fn->ia", Loovv, tmp)

    r = r - contract("mi,ma->ia", _goo(X2, l2), dfh.Hov)
    r = r + contract("ie,ea->ia", dfh.Hov, _gvv(l2, X2))

    # the X2 . l2 . Hvovv terms, each factor-implicit:
    #   'imfg,mnef->igne' ; 'igne,gnea->ia'
    tmp = contract("imfg,mnef->igne", l2, X2)
    Vt = contract("igne,Pge->Pin", tmp, Bd)
    r = r - contract("Pin,Pna->ia", Vt, Bov)
    #   'mifg,mnef->igne' ; 'igne,gnae->ia'
    tmp = contract("mifg,mnef->igne", l2, X2)
    V2t = contract("igne,Pne->Pig", tmp, Bov)
    r = r - contract("Pig,Pga->ia", V2t, Bd)
    #   'mnga,mnef->gaef' ; 'gief,gaef->ia'  (a v^4 temp in the dense path)
    r = r + _gaef_hvovv(dfh, l2, X2, nblocks=nblocks)
    #   'gmae,mnef->ganf' (Hvovv_s) ; 'nifg,ganf->ia'
    C7 = contract("Pme,mnef->Pnf", Bov, X2)
    M7 = contract("nifg,Pnf->Pig", l2, C7)
    r = r + 2.0 * contract("Pig,Pga->ia", M7, Bd)
    J7 = contract("mnef,nifg->meig", X2, l2)
    L7 = contract("meig,Pge->Pmi", J7, Bd)
    r = r - contract("Pmi,Pma->ia", L7, Bov)
    #   'giea,ge->ia' over Hvovv_s with Gvv(X2, l2)
    r = r + r1_gvv_hvovv(dfh, _gvv(X2, l2))

    # the X2 . l2 . Hooov terms (explicit)
    tmp = contract("oief,mnef->oimn", l2, X2)
    r = r + contract("oimn,mnoa->ia", tmp, dfh.Hooov)
    tmp = contract("mofa,mnef->oane", l2, X2)
    r = r + contract("inoe,oane->ia", dfh.Hooov, tmp)
    tmp = contract("onea,mnef->oamf", l2, X2)
    r = r + contract("miof,oamf->ia", dfh.Hooov, tmp)
    r = r - contract("mioa,mo->ia", Hooov_s, _goo(X2, l2))
    tmp = -1.0 * contract("imoe,mnef->ionf", Hooov_s, X2)
    return r + contract("ionf,nofa->ia", tmp, l2)


def inY2_df(dfh, Loovv, Eoovv, t1, t2, l1, l2, Ad, X1, X2, no,
            nblocks=None, ladder=vvvv_nt):
    """The DF form of ccresponse.in_Y2; its X1-dressed Hvovv term is a
    generalized ladder (`ladder_apply`, one `ladder` call an a-block, two
    for a complex X1)."""
    # the ladder reads Bd_ae's pieces on a mesh, every other term it whole
    Bov, Bd = dfh.df.Bov, dense(dfh.Bd_ae)
    Hooov_s = 2.0 * dfh.Hooov - dfh.Hooov.swapaxes(0, 1)
    Bd_T = _ea_layout(dfh.Bd_ae)

    r = 2.0 * contract("ia,jb->ijab", l1, Ad["Aov"])
    r = r - contract("ja,ib->ijab", l1, Ad["Aov"])
    r = r + contract("ijeb,ea->ijab", l2, Ad["Avv"])
    r = r - contract("im,mjab->ijab", Ad["Aoo"], l2)

    tmp = contract("me,ja->meja", X1, l1)
    r = r - contract("mieb,meja->ijab", Loovv, tmp)
    tmp = contract("me,mb->eb", X1, l1)
    r = r - contract("ijae,eb->ijab", Loovv, tmp)
    tmp = contract("me,ie->mi", X1, l1)
    r = r - contract("mi,jmba->ijab", tmp, Loovv)
    tmp = 2.0 * contract("me,jb->mejb", X1, l1)
    r = r + contract("imae,mejb->ijab", Loovv, tmp)

    tmp = contract("me,ma->ea", X1, dfh.Hov)
    r = r - contract("ijeb,ea->ijab", l2, tmp)
    tmp = contract("me,ie->mi", X1, dfh.Hov)
    r = r - contract("mi,jmba->ijab", tmp, l2)

    # the X1 . l2 . Hvovv terms, factor-implicit:
    #   'me,ijef->mijf' ; 'mijf,fmba->ijab': a generalized ladder with the
    #   X1-contracted factor Da[P,e,a] = X1[me] Bov[P,m,a]
    Da = contract("me,Pma->Pea", X1, Bov)
    r = r - ladder_apply(Da.transpose(1, 2), Bd_T, l2, nblocks=nblocks,
                         ladder=ladder)
    #   'me,imbf->eibf' ; 'eibf,fjea->ijab'
    D2 = contract("me,Pfe->Pmf", X1, Bd)
    E2 = contract("imbf,Pmf->Pib", l2, D2)
    r = r - contract("Pib,Pja->ijab", E2, Bov)
    #   'me,jmfa->ejfa' ; 'fibe,ejfa->ijab'
    s = contract("Pie,me->Pim", Bov, X1)
    M3 = contract("Pim,Pfb->ibmf", s, Bd)
    r = r - contract("ibmf,jmfa->ijab", M3, l2)
    #   'me,fmae->fa' (Hvovv_s) ; 'ijfb,fa->ijab'
    r = r + contract("ijfb,fa->ijab", l2, zvv_c1_hvovv(dfh, X1))
    #   'me,fiea->mfia' (Hvovv_s) ; 'mfia,jmbf->ijab'
    E5 = contract("jmbf,Pmf->Pjb", l2, D2)
    r = r + 2.0 * contract("Pjb,Pia->ijab", E5, Bov)
    M5 = contract("Pim,Pfa->iamf", s, Bd)
    r = r - contract("iamf,jmbf->ijab", M5, l2)

    # the X1 . l2 . Hooov terms (explicit)
    tmp = contract("me,jmna->ejna", X1, dfh.Hooov)
    r = r + contract("ineb,ejna->ijab", l2, tmp)
    tmp = contract("me,mjna->ejna", X1, dfh.Hooov)
    r = r + contract("nieb,ejna->ijab", l2, tmp)
    tmp = contract("me,nmba->enba", X1, l2)
    r = r + contract("jine,enba->ijab", dfh.Hooov, tmp)
    tmp = contract("me,mina->eina", X1, Hooov_s)
    r = r - contract("eina,njeb->ijab", tmp, l2)
    tmp = contract("me,imne->in", X1, Hooov_s)
    r = r - contract("in,jnba->ijab", tmp, l2)

    # the X2 quadratic terms (Eoovv/Loovv explicit)
    tmp = 0.5 * contract("ijef,mnef->ijmn", l2, X2)
    r = r + contract("ijmn,mnab->ijab", tmp, Eoovv)
    tmp = 0.5 * contract("ijfe,mnef->ijmn", Eoovv, X2)
    r = r + contract("ijmn,mnba->ijab", tmp, l2)
    tmp = contract("mifb,mnef->ibne", l2, X2)
    r = r + contract("ibne,jnae->ijab", tmp, Eoovv)
    tmp = contract("imfb,mnef->ibne", l2, X2)
    r = r + contract("ibne,njae->ijab", tmp, Eoovv)
    tmp = contract("mjfb,mnef->jbne", l2, X2)
    r = r - contract("jbne,inae->ijab", tmp, Loovv)
    r = r - contract("in,jnba->ijab", _goo(Loovv, X2), l2)
    r = r + contract("ijfb,af->ijab", l2, _gvv(X2, Loovv))
    r = r + contract("ijae,be->ijab", Loovv, _gvv(X2, l2))
    r = r - contract("imab,jm->ijab", Loovv, _goo(l2, X2))
    tmp = contract("nifb,mnef->ibme", l2, X2)
    r = r - contract("ibme,mjea->ijab", tmp, Loovv)
    tmp = 2.0 * contract("njfb,mnef->jbme", l2, X2)
    return r + contract("imae,jbme->ijab", Loovv, tmp)
