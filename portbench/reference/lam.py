"""HBAR (CCSD forms) and the CCSD Lambda residuals, plain.

`build_hbar` is rebuilt from any F (real-time CC dresses F with the
field), so it takes F, ERI, L, vvvv and the amplitudes and returns the
eleven blocks in a dict.  `lambda_residuals` takes that dict.  A vvvv
that is no tensor (reference/rt_df.py: <ab|ef> made from factors a block
of a at a time) gives an Hvvvv of its own kind (`vvvv.hbar`), which makes
its blocks by `hbar_vvvv` and takes Hvvvo's t1 term (`t1_term`) and the
Lambda ladder (`ladder_left`) block by block.
"""

import torch

from .ccsd import build_tau, slices
from .ein import ein, ladder_left, promote


def hbar_vvvv(vvvv, vovv, eri_oovv, t1, tau, a=slice(None)):
    """Hvvvv[a, b, e, f] over the range `a` of its first index, `vvvv`
    that range of <ab|ef>."""
    return (vvvv
            - ein("mb,amef->abef", t1, vovv[a])
            - ein("ma,bmfe->abef", t1[:, a], vovv)
            + ein("mnab,mnef->abef", tau[:, :, a], eri_oovv))


def _t1_hvvvv(t1, Hvvvv):
    """'if,abef->abei' of t1 and Hvvvv (Hvvvo's t1 term)."""
    if not isinstance(Hvvvv, torch.Tensor):
        return Hvvvv.t1_term(t1)
    return ein("if,abef->abei", t1, Hvvvv)


def build_hbar(F, ERI, L, vvvv, t1, t2, no):
    o, v = slices(no)
    tau = build_tau(t1, t2)
    H = {}
    H["ov"] = F[o, v] + ein("nf,mnef->me", t1, L[o, o, v, v])
    H["vv"] = (F[v, v]
               - ein("me,ma->ae", F[o, v], t1)
               + ein("mf,amef->ae", t1, L[v, o, v, v])
               - ein("mnfa,mnfe->ae", tau, L[o, o, v, v]))
    H["oo"] = (F[o, o]
               + ein("ie,me->mi", t1, F[o, v])
               + ein("ne,mnie->mi", t1, L[o, o, o, v])
               + ein("inef,mnef->mi", tau, L[o, o, v, v]))

    tmp = ein("je,mnie->mnij", t1, ERI[o, o, o, v])
    H["oooo"] = (ERI[o, o, o, o] + tmp + tmp.permute(1, 0, 3, 2)
                 + ein("ijef,mnef->mnij", tau, ERI[o, o, v, v]))

    vovv = ERI[v, o, v, v]
    if isinstance(vvvv, torch.Tensor):
        H["vvvv"] = hbar_vvvv(vvvv, vovv, ERI[o, o, v, v], t1, tau)
    else:
        H["vvvv"] = vvvv.hbar(vovv, ERI[o, o, v, v], t1, tau)

    H["vovv"] = vovv - ein("na,nmef->amef", t1, ERI[o, o, v, v])
    H["ooov"] = ERI[o, o, o, v] + ein("if,nmef->mnie", t1, ERI[o, o, v, v])

    H["ovvo"] = (ERI[o, v, v, o]
                 + ein("jf,mbef->mbej", t1, ERI[o, v, v, v])
                 - ein("nb,mnej->mbej", t1, ERI[o, o, v, o])
                 - ein("jnfb,mnef->mbej", tau, ERI[o, o, v, v])
                 + ein("njfb,mnef->mbej", t2, L[o, o, v, v]))
    H["ovov"] = (ERI[o, v, o, v]
                 + ein("jf,bmef->mbje", t1, ERI[v, o, v, v])
                 - ein("nb,mnje->mbje", t1, ERI[o, o, o, v])
                 - ein("jnfb,nmef->mbje", tau, ERI[o, o, v, v]))

    Hvvvo = (ERI[v, v, v, o]
             - ein("me,miab->abei", H["ov"], t2)
             + _t1_hvvvv(t1, H["vvvv"])
             + ein("mnab,mnei->abei", tau, ERI[o, o, v, o])
             - ein("imfa,bmfe->abei", t2, ERI[v, o, v, v])
             - ein("imfb,amef->abei", t2, ERI[v, o, v, v])
             + ein("mifb,amef->abei", t2, L[v, o, v, v]))
    tmp = ERI[v, o, v, o] - ein("infa,mnfe->amei", t2, ERI[o, o, v, v])
    Hvvvo = Hvvvo - ein("mb,amei->abei", t1, tmp)
    tmp = (ERI[v, o, o, v]
           - ein("infb,mnef->bmie", t2, ERI[o, o, v, v])
           + ein("nifb,mnef->bmie", t2, L[o, o, v, v]))
    H["vvvo"] = Hvvvo - ein("ma,bmie->abei", t1, tmp)

    Hovoo = (ERI[o, v, o, o]
             + ein("me,ijeb->mbij", H["ov"], t2)
             - ein("nb,mnij->mbij", t1, H["oooo"])
             + ein("ijef,mbef->mbij", tau, ERI[o, v, v, v])
             - ein("ineb,nmje->mbij", t2, ERI[o, o, o, v])
             - ein("jneb,mnie->mbij", t2, ERI[o, o, o, v])
             + ein("njeb,mnie->mbij", t2, L[o, o, o, v]))
    tmp = ERI[o, v, o, v] - ein("infb,mnfe->mbie", t2, ERI[o, o, v, v])
    Hovoo = Hovoo + ein("je,mbie->mbij", t1, tmp)
    tmp = (ERI[v, o, o, v]
           - ein("jnfb,mnef->bmje", t2, ERI[o, o, v, v])
           + ein("njfb,mnef->bmje", t2, L[o, o, v, v]))
    H["ovoo"] = Hovoo + ein("ie,bmje->mbij", t1, tmp)
    return H


def lambda_residuals(H, L, t2, l1, l2, no):
    """The CCSD Lambda residuals (r1, r2) on the HBAR blocks H."""
    o, v = slices(no)
    Goo = ein("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * ein("ijeb,ijab->ae", t2, l2)
    Hovvo_s = 2.0 * H["ovvo"] - H["ovov"].swapaxes(2, 3)

    r1 = promote(2.0 * H["ov"], l1)
    r1 = r1 + ein("ie,ea->ia", l1, H["vv"])
    r1 = r1 - ein("ma,im->ia", l1, H["oo"])
    r1 = r1 + ein("imef,efam->ia", l2, H["vvvo"])
    r1 = r1 - ein("mnae,iemn->ia", l2, H["ovoo"])
    r1 = r1 + ein("me,ieam->ia", l1, Hovvo_s)
    r1 = r1 - 2.0 * ein("ef,eifa->ia", Gvv, H["vovv"])
    r1 = r1 + ein("ef,eiaf->ia", Gvv, H["vovv"])
    r1 = r1 - 2.0 * ein("mn,mina->ia", Goo, H["ooov"])
    r1 = r1 + ein("mn,imna->ia", Goo, H["ooov"])

    r2 = promote(L[o, o, v, v], l2)
    r2 = r2 + 2.0 * ein("ia,jb->ijab", l1, H["ov"])
    r2 = r2 - ein("ja,ib->ijab", l1, H["ov"])
    r2 = r2 + 2.0 * ein("ie,ejab->ijab", l1, H["vovv"])
    r2 = r2 - ein("ie,ejba->ijab", l1, H["vovv"])
    r2 = r2 - 2.0 * ein("mb,jima->ijab", l1, H["ooov"])
    r2 = r2 + ein("mb,ijma->ijab", l1, H["ooov"])
    r2 = r2 + ein("ijeb,ea->ijab", l2, H["vv"])
    r2 = r2 - ein("mjab,im->ijab", l2, H["oo"])
    r2 = r2 + 0.5 * ein("mnab,ijmn->ijab", l2, H["oooo"])
    r2 = r2 + 0.5 * ladder_left(l2, H["vvvv"])
    r2 = r2 + ein("mjeb,ieam->ijab", l2, Hovvo_s)
    r2 = r2 - ein("mibe,jema->ijab", l2, H["ovov"])
    r2 = r2 - ein("mieb,jeam->ijab", l2, H["ovvo"])
    r2 = r2 + ein("ae,ijeb->ijab", Gvv, L[o, o, v, v])
    r2 = r2 - ein("mi,mjab->ijab", Goo, L[o, o, v, v])
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2
