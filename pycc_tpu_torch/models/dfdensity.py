"""Density-based CC energy from Cholesky/DF factors.

The counterpart of pycc_tpu/models/dfdensity.py.  The dense density energy
(ccdensity.compute_energy) contracts the full two-pdm against the MO ERI,
including a v^4 Dvvvv and a v^3 o Dvvvo block that cannot exist at DF
sizes.  This module evaluates the same scalar without either: the vvvv
term rides the a-blocked DF ladder (`dfhbar.ladder_apply`, one K1 launch
an a-block), and every Dvvvo term is re-associated so that one factor
index is absorbed into B first, leaving o^2 v^2-bounded intermediates;
Dvvvo's t1-dressed vvvv term is a second ladder through K1.

Index conventions: Dirac <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s];
factor blocks Boo/Bov/Bvv as in models/dfccsd.DFERI.
"""

import torch

from ..cclambda import build_Gvv
from ..ops.contract import contract
from ..ops.kernels.vvvv import vvvv_nt
from .ccsd import build_tau
from ..parallel.mesh import dense
from .dfccsd import _eri_oooo, _eri_ooov, _eri_oovv, _eri_ovov, whole_bvv
from .dfhbar import ladder_apply


def _evvvo_extra_df(df, G):
    """sum <ab|ci> G[abci] for a materialized v^3 o extra block (the (T)
    density's Gvvvo): a loop over a, so that the ERI slice never exists
    beyond one (v, o, v) sheet."""
    df = whole_bvv(df)
    e = torch.zeros((), dtype=G.dtype, device=G.device)
    for a in range(G.shape[0]):
        t = contract("Pc,Pib->cib", df.Bvv[:, a], df.Bov)   # <a.|ci> sheet
        e = e + contract("cib,bci->", t, G[a])
    return e


def _evvvv_df(model, df, t1, t2, l2, nblocks=None, ladder=vvvv_nt):
    """0.5 * sum <ab|cd> Dvvvv[abcd] without forming either v^4 tensor."""
    if model == "CC2":
        # Dvvvv = t1[ma] t1[nb] l2[mncd]: absorb both t1 into B
        Bt1 = contract("Pac,ma->Pcm", dense(df.Bvv), t1)
        Z = contract("Pcm,Pdn->mncd", Bt1, Bt1)
        return 0.5 * contract("mncd,mncd->", l2, Z)
    x2 = t2 if model == "CCD" else build_tau(t1, t2)
    # Z[mncd] = sum_ef x2[mnef] <cd|ef>;  <cd|ef> = sum_P Bvv[Pce] Bvv[Pdf]
    Z = ladder_apply(df.Bvv, df.Bvv, x2, nblocks=nblocks, ladder=ladder)
    return 0.5 * contract("mncd,mncd->", l2, Z)


def _evvvo_df(model, df, t1, t2, l1, l2, nblocks=None, ladder=vvvv_nt):
    """sum <ab|ci> Dvvvo[abci] with every term re-associated through the
    factors; largest intermediate o^2 v^2.  Term order follows
    ccdensity.build_Dvvvo.  <ab|ci> = sum_P Bvv[P,a,c] Bov[P,i,b]."""
    if model == "CCD":
        return torch.zeros((), dtype=t2.dtype, device=t2.device)
    # the ladder reads Bvv's pieces (dfs), every other term Bvv whole
    dfs, df = df, whole_bvv(df)
    tau = build_tau(t1, t2)
    tauS = 2.0 * tau - tau.swapaxes(2, 3)

    Bl1 = contract("Pac,mc->Pam", df.Bvv, l1)      # (naux, v, o)
    Bt1v = contract("Pac,na->Pcn", df.Bvv, t1)     # (naux, v, o)
    Bt1o = contract("Pib,nb->Pin", df.Bov, t1)     # (naux, o, o)
    l2t1 = contract("nmce,ie->nmci", l2, t1)       # (o, o, v, o)

    # D += l1[mc] tauS[miab]
    X1 = contract("Pam,Pib->miab", Bl1, df.Bov)
    e = contract("miab,miab->", tauS, X1)
    # D += t1[ma] l2[imbc]
    X5 = contract("Pcn,Pib->ncib", Bt1v, df.Bov)
    e = e + contract("imbc,mcib->", l2, X5)
    if model != "CC2":
        Gvv = build_Gvv(t2, l2)
        # D -= 2 Gvv[ca] t1[ib];  D += Gvv[cb] t1[ia]
        u = contract("Pac,ca->P", df.Bvv, Gvv)
        w = contract("Pib,ib->P", df.Bov, t1)
        e = e - 2.0 * contract("P,P->", u, w)
        tg = contract("Pib,cb->Pic", df.Bov, Gvv)
        e = e + contract("Pci,Pic->", Bt1v, tg)
        # tmp5 = t2[imbe] l2[nmce]:  D += 2 tmp5[ibnc] t1[na]
        #                            D -= tmp5[ianc] t1[nb]
        tmp5 = contract("imbe,nmce->ibnc", t2, l2)
        Y6 = contract("Pac,Pin->acin", df.Bvv, Bt1o)
        e = e + 2.0 * contract("ibnc,ncib->", tmp5, X5)
        e = e - contract("ianc,acin->", tmp5, Y6)
        # D -= (t2[nmab] l2[nmce]) t1[ie]: a t1-dressed vvvv ladder,
        # Z7[nmce] = sum_ab t2[nmab] W[c,e,a,b],
        # W[c,e,a,b] = sum_P Bvv[P,c,a] (sum_i t1[ie] Bov[P,i,b])
        BRe = contract("ie,Pib->Peb", t1, df.Bov)
        Z7 = ladder_apply(dfs.Bvv.transpose(1, 2), BRe, t2, nblocks=nblocks,
                          ladder=ladder)
        e = e - contract("nmce,nmce->", l2, Z7)
        # tmp8 = t2[niae] l2[nmce]:  D -= tmp8[iamc] t1[mb]
        tmp8 = contract("niae,nmce->iamc", t2, l2)
        e = e - contract("iamc,acim->", tmp8, Y6)
        # tmp9 = t2[mibe] l2[nmce]:  D -= tmp9[ibnc] t1[na]
        tmp9 = contract("mibe,nmce->ibnc", t2, l2)
        e = e - contract("ibnc,ncib->", tmp9, X5)
    # D -= l2[nmce] t1[ie] t1[na] t1[mb]
    V10 = contract("Pcn,Pim->cnim", Bt1v, Bt1o)
    return e - contract("nmci,cnim->", l2t1, V10)


def density_energy_df(F, df, t1, t2, l1, l2, no, model="CCSD",
                      Doo=None, Dvv=None, Doooo=None, Dooov=None,
                      Dovov=None, Doovv=None, Gvvvo=None, nblocks=None,
                      ladder=vvvv_nt):
    """(eone, etwo) as 0-d tensors: the density-based correlation energy
    over factors.  The o-heavy two-pdm blocks may be passed in (ccdensity
    keeps them); when None they are built here.  Each o-heavy integral
    block (<= o^2 v^2) is assembled from the factors and dotted with its
    density (pycc_tpu writes the same sums as three-operand contractions),
    the vvvv and vvvo terms go over the factors (two K1 ladders), and the
    (T) density's Gvvvo, when given, one a-sheet at a time."""
    from ..ccdensity import (build_Doo, build_Doooo, build_Dooov,
                             build_Doovv, build_Dovov, build_Dvv)

    o, v = slice(0, no), slice(no, F.shape[0])
    if Doo is None:
        Doo = build_Doo(model, t1, t2, l1, l2)
    if Dvv is None:
        Dvv = build_Dvv(model, t1, t2, l1, l2)
    eone = (contract("ij,ij->", F[o, o], Doo)
            + contract("ab,ab->", F[v, v], Dvv))

    if Doooo is None:
        Doooo = build_Doooo(model, t1, t2, l2)
    if Dooov is None:
        Dooov = build_Dooov(model, t1, t2, l1, l2)
    if Dovov is None:
        Dovov = build_Dovov(model, t1, t2, l1, l2)
    if Doovv is None:
        Doovv = build_Doovv(model, t1, t2, l1, l2)

    # <ij|kl> = (ik|jl), <ij|ka> = (ik|ja), <ia|jb> = (ij|ab),
    # <ij|ab> = (ia|jb)
    etwo = 0.5 * contract("ijkl,ijkl->", _eri_oooo(df), Doooo)
    etwo = etwo + contract("ijka,ijka->", _eri_ooov(df), Dooov)
    etwo = etwo + contract("iajb,iajb->", _eri_ovov(whole_bvv(df)), Dovov)
    etwo = etwo + 0.5 * contract("ijab,ijab->", _eri_oovv(df), Doovv)
    etwo = etwo + _evvvv_df(model, df, t1, t2, l2, nblocks=nblocks,
                            ladder=ladder)
    etwo = etwo + _evvvo_df(model, df, t1, t2, l1, l2, nblocks=nblocks,
                            ladder=ladder)
    if Gvvvo is not None:
        # the (T) density's vvvo block (ccwfn.t3_density's Gvvvo)
        etwo = etwo + _evvvo_extra_df(df, Gvvvo)
    return eone, etwo
