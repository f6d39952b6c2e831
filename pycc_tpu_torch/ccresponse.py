"""CC linear response: dynamic polarizabilities and pseudoresponses.

The counterpart of pycc_tpu/ccresponse.py for storage='full', 'blocked'
and 'df':
the similarity-transformed perturbations (`pertbar`), the
perturbed-amplitude residuals `r_X` (right, X) and `r_Y` (left, Y) with
the left inhomogeneous terms `in_Y1`/`in_Y2`, term for term as plain
functions on tensors, and the `ccresponse` class with its Jacobi + DIIS
solvers (`solve_right`, `solve_left`; one host read an iteration), the
conditioning probe and the asymmetric linear-response function.  Over DF
factors the residuals are models/dfresponse.py's (`rX_df`, `inY1_df`,
`inY2_df`, `rY_df`) on the DF-HBAR, the pertbars hold no o v^3 Avvvo, and
no o^2 v^2 denominator stays resident.  `solve_right_mixed` and
`solve_left_mixed` converge in float32 and refine in float64.

The magnetic-dipole and momentum perturbations (M, M*, P, P*) are
complex128, so their X and Y are complex while HBAR is real: `contract`
promotes the real operands, and the Hvvvv ladders keep one real K1 launch
with the real and imaginary rows stacked (`models/ccsd.vvvv_contract`).
Every residual takes `ladder=` (K1's `vvvv_nt` by default;
`vvvv_nt_reference` gives the plain product).
"""

import time
import warnings

import numpy as np
import torch

from .cclambda import build_Goo, build_Gvv
from .models.blocked import LoovvOnly, eri_views
from .models.ccsd import (pair_symmetric, slices, vvvv_contract,
                          vvvv_contract_efab)
from .ops.contract import contract
from .ops.diis import DIIS
from .ops.kernels.vvvv import vvvv_nt
from .utils.log import logger as log

CART = ["X", "Y", "Z"]


class pertbar:
    """Similarity-transformed one-electron perturbation blocks of `pert`
    (nact, nact) over the amplitudes of `ccwfn`.  `pert` is not changed:
    Avo starts from a copy of its (v, o) block.  Under storage='df' the
    o v^3 Avvvo block is not formed: its two consumers (in_Y1 and
    linresp_asym) reduce it to o^2 intermediates against Aov."""

    def __init__(self, pert, ccwfn):
        o, v = ccwfn.o, ccwfn.v
        t1, t2 = ccwfn.t1, ccwfn.t2
        self.Aov = pert[o, v]
        self.Aoo = pert[o, o] + contract("ie,me->mi", t1, pert[o, v])
        self.Avv = pert[v, v] - contract("ma,me->ae", t1, pert[o, v])
        Avo = pert[v, o].clone()
        Avo += contract("ie,ae->ai", t1, pert[v, v])
        Avo -= contract("ma,mi->ai", t1, pert[o, o])
        Avo += contract("miea,me->ai", 2.0 * t2 - t2.swapaxes(2, 3), pert[o, v])
        Avo -= contract("ie,ma,me->ai", t1, t1, pert[o, v])
        self.Avo = Avo
        self.Aovoo = contract("ijeb,me->mbij", t2, pert[o, v])
        if getattr(ccwfn, "storage", "full") != "df":
            self.Avvvo = -1.0 * contract("miab,me->abei", t2, pert[o, v])
        Avvoo = contract("ijeb,ae->ijab", t2, self.Avv)
        Avvoo -= contract("mjab,mi->ijab", t2, self.Aoo)
        self.Avvoo = 0.5 * (Avvoo + Avvoo.permute(1, 0, 3, 2))


def build_response_aux(hb):
    """The spin-adapted combinations 2 H - H^swap of three HBAR blocks
    that r_X, r_Y and in_Y read again and again, made once per response
    object."""
    return dict(
        Hvovv_s=2.0 * hb.Hvovv - hb.Hvovv.swapaxes(2, 3),
        Hooov_s=2.0 * hb.Hooov - hb.Hooov.swapaxes(0, 1),
        Hovvo_s=2.0 * hb.Hovvo - hb.Hovov.swapaxes(2, 3),
    )


def r_X(hb, L, t2, A, omega, X1, X2, no, aux, ladder=vvvv_nt):
    """The right-hand residuals (r1, r2) of (HBAR - omega) X = -A for the
    pertbar blocks A (a dict); the Hvvvv ladder is one `ladder` call."""
    o, v = slices(no)
    r1 = A["Avo"].T - omega * X1
    r1 += contract("ie,ae->ia", X1, hb.Hvv)
    r1 -= contract("ma,mi->ia", X1, hb.Hoo)
    r1 += contract("me,maei->ia", X1, aux["Hovvo_s"])
    r1 += contract("me,miea->ia", hb.Hov, 2.0 * X2 - X2.swapaxes(0, 1))
    r1 += contract("imef,amef->ia", X2, aux["Hvovv_s"])
    r1 -= contract("mnae,mnie->ia", X2, aux["Hooov_s"])

    Zvv = contract("amef,mf->ae", aux["Hvovv_s"], X1)
    Zvv -= contract("mnef,mnaf->ae", L[o, o, v, v], X2)
    Zoo = -1.0 * contract("mnie,ne->mi", aux["Hooov_s"], X1)
    Zoo -= contract("mnef,inef->mi", L[o, o, v, v], X2)

    r2 = A["Avvoo"] - 0.5 * omega * X2
    r2 += contract("ie,abej->ijab", X1, hb.Hvvvo)
    r2 -= contract("ma,mbij->ijab", X1, hb.Hovoo)
    r2 += contract("mi,mjab->ijab", Zoo, t2)
    r2 += contract("ae,ijeb->ijab", Zvv, t2)
    r2 += contract("ijeb,ae->ijab", X2, hb.Hvv)
    r2 -= contract("mjab,mi->ijab", X2, hb.Hoo)
    r2 += 0.5 * contract("mnij,mnab->ijab", hb.Hoooo, X2)
    r2 += 0.5 * vvvv_contract(X2, hb.Hvvvv, ladder)
    r2 -= contract("imeb,maje->ijab", X2, hb.Hovov)
    r2 -= contract("imea,mbej->ijab", X2, hb.Hovvo)
    r2 += 2.0 * contract("miea,mbej->ijab", X2, hb.Hovvo)
    r2 -= contract("miea,mbje->ijab", X2, hb.Hovov)
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def in_Y1(hb, L, t2, l1, l2, A, X1, X2, no, aux, ladder=vvvv_nt):
    """The singles inhomogeneous term of the left equations.  Its two
    Hvvvv terms, 'imfg,fgae' and 'imgf,fgea', are one `ladder` call on
    HBar.Hvvvv_efab: l2 and l2 with its virtual pair swapped stacked as
    one (2 o^2, v^2) operand."""
    o, v = slices(no)
    r = 2.0 * A["Aov"]
    r -= contract("im,ma->ia", A["Aoo"], l1)
    r += contract("ie,ea->ia", l1, A["Avv"])
    r += contract("imfe,feam->ia", l2, A["Avvvo"])
    r -= 0.5 * contract("ienm,mnea->ia", A["Aovoo"], l2)
    r -= 0.5 * contract("iemn,mnae->ia", A["Aovoo"], l2)

    r += 2.0 * contract("imae,me->ia", L[o, o, v, v], X1)

    tmp = -1.0 * contract("ma,ie->miae", hb.Hov, l1)
    tmp -= contract("ma,ie->miae", l1, hb.Hov)
    tmp -= contract("mina,ne->miae", aux["Hooov_s"], l1)
    tmp -= contract("imne,na->miae", aux["Hooov_s"], l1)
    tmp += contract("fmae,if->miae", aux["Hvovv_s"], l1)
    tmp += contract("fiea,mf->miae", aux["Hvovv_s"], l1)
    r += contract("miae,me->ia", tmp, X1)

    tmp = 2.0 * contract("mnef,nf->me", X2, l1)
    tmp -= contract("mnfe,nf->me", X2, l1)
    r += contract("imae,me->ia", L[o, o, v, v], tmp)
    r -= contract("ni,na->ia", build_Goo(X2, L[o, o, v, v]), l1)
    r += contract("ie,ea->ia", l1, build_Gvv(L[o, o, v, v], X2))

    tmp = -1.0 * contract("nief,mfna->iema", l2, hb.Hovov)
    tmp -= contract("ifne,nmaf->iema", hb.Hovov, l2)
    tmp -= contract("inef,mfan->iema", l2, hb.Hovvo)
    tmp -= contract("ifen,nmfa->iema", hb.Hovvo, l2)
    # lad[:no][i,m,a,e] = sum_fg l2[i,m,f,g] Hvvvv[f,g,a,e]   ('imfg,fgae')
    # lad[no:][i,m,e,a] = sum_fg l2[i,m,g,f] Hvvvv[f,g,e,a]   ('imgf,fgea')
    lad = vvvv_contract_efab(torch.cat([l2, l2.swapaxes(2, 3)]),
                             hb.Hvvvv_efab, ladder)
    tmp += 0.5 * (lad[:no].permute(0, 3, 1, 2) + lad[no:].permute(0, 2, 1, 3))
    del lad
    tmp += 0.5 * contract("imno,onea->iema", hb.Hoooo, l2)
    tmp += 0.5 * contract("mino,noea->iema", hb.Hoooo, l2)
    r += contract("iema,me->ia", tmp, X1)

    Gvv_l2t2 = build_Gvv(l2, t2)
    Goo_t2l2 = build_Goo(t2, l2)
    tmp = contract("nb,fb->nf", X1, Gvv_l2t2)
    r += contract("inaf,nf->ia", L[o, o, v, v], tmp)
    tmp = contract("me,fa->mefa", X1, Gvv_l2t2)
    r += contract("mief,mefa->ia", L[o, o, v, v], tmp)
    tmp = contract("me,ni->meni", X1, Goo_t2l2)
    r -= contract("meni,mnea->ia", tmp, L[o, o, v, v])
    tmp = contract("jf,nj->fn", X1, Goo_t2l2)
    r -= contract("inaf,fn->ia", L[o, o, v, v], tmp)

    r -= contract("mi,ma->ia", build_Goo(X2, l2), hb.Hov)
    r += contract("ie,ea->ia", hb.Hov, build_Gvv(l2, X2))
    tmp = contract("imfg,mnef->igne", l2, X2)
    r -= contract("igne,gnea->ia", tmp, hb.Hvovv)
    tmp = contract("mifg,mnef->igne", l2, X2)
    r -= contract("igne,gnae->ia", tmp, hb.Hvovv)
    tmp = contract("mnga,mnef->gaef", l2, X2)
    r -= contract("gief,gaef->ia", hb.Hvovv, tmp)
    tmp = contract("gmae,mnef->ganf", aux["Hvovv_s"], X2)
    r += contract("nifg,ganf->ia", l2, tmp)
    Gvv_X2l2 = build_Gvv(X2, l2)
    r -= contract("giea,ge->ia", aux["Hvovv_s"], Gvv_X2l2)
    tmp = contract("oief,mnef->oimn", l2, X2)
    r += contract("oimn,mnoa->ia", tmp, hb.Hooov)
    tmp = contract("mofa,mnef->oane", l2, X2)
    r += contract("inoe,oane->ia", hb.Hooov, tmp)
    tmp = contract("onea,mnef->oamf", l2, X2)
    r += contract("miof,oamf->ia", hb.Hooov, tmp)
    Goo_X2l2 = build_Goo(X2, l2)
    r -= contract("mioa,mo->ia", aux["Hooov_s"], Goo_X2l2)
    tmp = -1.0 * contract("imoe,mnef->ionf", aux["Hooov_s"], X2)
    r += contract("ionf,nofa->ia", tmp, l2)
    return r


def in_Y2(hb, L, ERI, t2, l1, l2, A, X1, X2, no, aux):
    """The doubles inhomogeneous term of the left equations."""
    o, v = slices(no)
    r = 2.0 * contract("ia,jb->ijab", l1, A["Aov"])
    r -= contract("ja,ib->ijab", l1, A["Aov"])
    r += contract("ijeb,ea->ijab", l2, A["Avv"])
    r -= contract("im,mjab->ijab", A["Aoo"], l2)

    tmp = contract("me,ja->meja", X1, l1)
    r -= contract("mieb,meja->ijab", L[o, o, v, v], tmp)
    tmp = contract("me,mb->eb", X1, l1)
    r -= contract("ijae,eb->ijab", L[o, o, v, v], tmp)
    tmp = contract("me,ie->mi", X1, l1)
    r -= contract("mi,jmba->ijab", tmp, L[o, o, v, v])
    tmp = 2.0 * contract("me,jb->mejb", X1, l1)
    r += contract("imae,mejb->ijab", L[o, o, v, v], tmp)

    tmp = contract("me,ma->ea", X1, hb.Hov)
    r -= contract("ijeb,ea->ijab", l2, tmp)
    tmp = contract("me,ie->mi", X1, hb.Hov)
    r -= contract("mi,jmba->ijab", tmp, l2)
    tmp = contract("me,ijef->mijf", X1, l2)
    r -= contract("mijf,fmba->ijab", tmp, hb.Hvovv)
    tmp = contract("me,imbf->eibf", X1, l2)
    r -= contract("eibf,fjea->ijab", tmp, hb.Hvovv)
    tmp = contract("me,jmfa->ejfa", X1, l2)
    r -= contract("fibe,ejfa->ijab", hb.Hvovv, tmp)
    tmp = contract("me,fmae->fa", X1, aux["Hvovv_s"])
    r += contract("ijfb,fa->ijab", l2, tmp)
    tmp = contract("me,fiea->mfia", X1, aux["Hvovv_s"])
    r += contract("mfia,jmbf->ijab", tmp, l2)
    tmp = contract("me,jmna->ejna", X1, hb.Hooov)
    r += contract("ineb,ejna->ijab", l2, tmp)
    tmp = contract("me,mjna->ejna", X1, hb.Hooov)
    r += contract("nieb,ejna->ijab", l2, tmp)
    tmp = contract("me,nmba->enba", X1, l2)
    r += contract("jine,enba->ijab", hb.Hooov, tmp)
    tmp = contract("me,mina->eina", X1, aux["Hooov_s"])
    r -= contract("eina,njeb->ijab", tmp, l2)
    tmp = contract("me,imne->in", X1, aux["Hooov_s"])
    r -= contract("in,jnba->ijab", tmp, l2)

    tmp = 0.5 * contract("ijef,mnef->ijmn", l2, X2)
    r += contract("ijmn,mnab->ijab", tmp, ERI[o, o, v, v])
    tmp = 0.5 * contract("ijfe,mnef->ijmn", ERI[o, o, v, v], X2)
    r += contract("ijmn,mnba->ijab", tmp, l2)
    tmp = contract("mifb,mnef->ibne", l2, X2)
    r += contract("ibne,jnae->ijab", tmp, ERI[o, o, v, v])
    tmp = contract("imfb,mnef->ibne", l2, X2)
    r += contract("ibne,njae->ijab", tmp, ERI[o, o, v, v])
    tmp = contract("mjfb,mnef->jbne", l2, X2)
    r -= contract("jbne,inae->ijab", tmp, L[o, o, v, v])
    r -= contract("in,jnba->ijab", build_Goo(L[o, o, v, v], X2), l2)
    r += contract("ijfb,af->ijab", l2, build_Gvv(X2, L[o, o, v, v]))
    r += contract("ijae,be->ijab", L[o, o, v, v], build_Gvv(X2, l2))
    r -= contract("imab,jm->ijab", L[o, o, v, v], build_Goo(l2, X2))
    tmp = contract("nifb,mnef->ibme", l2, X2)
    r -= contract("ibme,mjea->ijab", tmp, L[o, o, v, v])
    tmp = 2.0 * contract("njfb,mnef->jbme", l2, X2)
    r += contract("imae,jbme->ijab", L[o, o, v, v], tmp)
    return r


def r_Y(hb, L, t2, imY1, imY2, omega, Y1, Y2, no, aux, ladder=vvvv_nt):
    """The left-hand residuals (r1, r2); the Hvvvv ladder 'ijef,efab' is
    one `ladder` call on HBar.Hvvvv_efab, as in Lambda."""
    o, v = slices(no)
    r1 = imY1 + omega * Y1
    r1 += contract("ie,ea->ia", Y1, hb.Hvv)
    r1 -= contract("im,ma->ia", hb.Hoo, Y1)
    r1 += contract("ieam,me->ia", aux["Hovvo_s"], Y1)
    r1 += contract("imef,efam->ia", Y2, hb.Hvvvo)
    r1 -= contract("iemn,mnae->ia", hb.Hovoo, Y2)
    Gvv_t2Y2 = build_Gvv(t2, Y2)
    r1 -= contract("eifa,ef->ia", aux["Hvovv_s"], Gvv_t2Y2)
    Goo_t2Y2 = build_Goo(t2, Y2)
    r1 -= contract("mina,mn->ia", aux["Hooov_s"], Goo_t2Y2)

    r2 = imY2 + 0.5 * omega * Y2
    r2 += 2.0 * contract("ia,jb->ijab", Y1, hb.Hov)
    r2 -= contract("ja,ib->ijab", Y1, hb.Hov)
    r2 += contract("ijeb,ea->ijab", Y2, hb.Hvv)
    r2 -= contract("im,mjab->ijab", hb.Hoo, Y2)
    r2 += 0.5 * contract("ijmn,mnab->ijab", hb.Hoooo, Y2)
    r2 += 0.5 * vvvv_contract_efab(Y2, hb.Hvvvv_efab, ladder)
    r2 += contract("ie,ejab->ijab", Y1, aux["Hvovv_s"])
    r2 -= contract("mb,jima->ijab", Y1, aux["Hooov_s"])
    r2 += contract("ieam,mjeb->ijab", aux["Hovvo_s"], Y2)
    r2 -= contract("mibe,jema->ijab", Y2, hb.Hovov)
    r2 -= contract("mieb,jeam->ijab", Y2, hb.Hovvo)
    r2 += contract("ijeb,ae->ijab", L[o, o, v, v], Gvv_t2Y2)
    r2 -= contract("mi,mjab->ijab", Goo_t2Y2, L[o, o, v, v])
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


class ccresponse:
    """RHF-CC response properties of a storage='full', 'blocked' or 'df'
    ccdensity (any object with `.ccwfn` and `.cclambda`), on the ccwfn's
    device.
    `pertbar` holds the similarity-transformed perturbations by key:
    MU_X..Z, M_*, M*_*, P_*, P*_* and Q_XX..ZZ, for each operator the
    Hamiltonian carries."""

    def __init__(self, ccdensity):
        self.ccwfn = ccdensity.ccwfn
        self.cclambda = ccdensity.cclambda
        self._df = getattr(self.ccwfn, "storage", "full") == "df"
        self.cart = CART
        self._rebuild_stage()

    def _rebuild_stage(self, rebuild_hbar=False):
        """Every piece of response state derived from the ccwfn's current
        amplitudes and dtype stage: the pertbars, the spin-adapted HBAR
        combinations, the <oo|vv> blocks, the HBAR-diagonal denominators,
        and an empty conditioning cache.  rebuild_hbar=True first rebuilds
        the Lambda object's HBAR from the ccwfn (the mixed solvers, after
        `ccwfn._cast_stage`)."""
        if rebuild_hbar:
            from .cchbar import cchbar
            self.cclambda.hbar = cchbar(self.ccwfn)
        self.H = self.ccwfn.H
        self.hbar = self.cclambda.hbar
        cc = self.ccwfn
        H = self.H
        # an operator the Hamiltonian lacks is () there: nothing is made
        self.pertbar = {}
        for name, ops in (("MU", H.mu), ("M", H.m), ("P", H.p)):
            for axis, op in enumerate(ops):
                self.pertbar[name + "_" + CART[axis]] = pertbar(op, cc)
            if name != "MU":
                for axis, op in enumerate(ops):
                    self.pertbar[name + "*_" + CART[axis]] = pertbar(
                        op.conj().resolve_conj(), cc)
        # Q holds the six unique components; Q_YX is the pertbar of Q_XY
        pairs = [(a1, a2) for a1 in range(3) for a2 in range(a1, 3)]
        for (a1, a2), op in zip(pairs, H.Q):
            self.pertbar["Q_" + CART[a1] + CART[a2]] = \
                self.pertbar["Q_" + CART[a2] + CART[a1]] = pertbar(op, cc)

        hb = self._hb()
        if self._df:
            # no dense Hvovv/Hvvvo/Hvvvv exist, so no pre-laid combinations;
            # L and <oo|vv> are assembled from the factors once
            from .models.dfccsd import _eri_oovv
            from .models.dfhbar import loovv_df
            self._aux = None
            self._Loovv = loovv_df(hb.df)
            self._Eoovv = _eri_oovv(hb.df)
        else:
            # the dense equations read only L[o,o,v,v] and <oo|vv>, of the
            # full tensors or the blocks (`models/blocked.eri_views`)
            self._aux = build_response_aux(hb)
            ERI, L = eri_views(cc)
            o, v = slices(cc.no)
            self._Loovv, self._Eoovv = L[o, o, v, v], ERI[o, o, v, v]
        self._eps_occ = torch.diagonal(hb.Hoo)
        self._eps_vir = torch.diagonal(hb.Hvv)
        self._cond_cache = {}
        self.Dia = self._eps_occ[:, None] - self._eps_vir[None, :]

    @property
    def Dijab(self):
        """The HBAR-diagonal doubles denominators, made when asked for:
        no o^2 v^2 tensor stays resident between solves."""
        eo, ev = self._eps_occ, self._eps_vir
        return (eo[:, None, None, None] + eo[None, :, None, None]
                - ev[None, None, :, None] - ev[None, None, None, :])

    def _hb(self):
        return getattr(self.hbar, "hbar", self.hbar)

    def _oovv(self, block):
        """An o/o/v/v block as the dense equations index it."""
        return LoovvOnly(block, self.ccwfn.no)

    def _Adict(self, A):
        d = {"Aov": A.Aov, "Aoo": A.Aoo, "Avv": A.Avv, "Avo": A.Avo,
             "Aovoo": A.Aovoo, "Avvoo": A.Avvoo}
        if hasattr(A, "Avvvo"):
            d["Avvvo"] = A.Avvvo
        return d

    # ------------------------------------------------------------------
    # the residuals of this response object's storage
    def _r_X(self, Ad, omega, X1, X2, ladder=vvvv_nt):
        """r_X (full storage) or rX_df (DF) at the ccwfn's amplitudes."""
        cc = self.ccwfn
        if self._df:
            from .models.dfresponse import rX_df
            return rX_df(self._hb(), self._Loovv, cc.t1, cc.t2, Ad, omega,
                         X1, X2, cc.no,
                         nblocks=getattr(cc, "df_nblocks", None),
                         ladder=ladder)
        return r_X(self._hb(), self._oovv(self._Loovv), cc.t2, Ad, omega,
                   X1, X2, cc.no, self._aux, ladder=ladder)

    def _in_Y(self, A, X1, X2, ladder=vvvv_nt):
        """The left inhomogeneous terms (imY1, imY2) of pertbar A over the
        right amplitudes X; `ladder` runs in_Y1's Hvvvv pair (full
        storage) or inY2_df's X1-dressed ladder (DF)."""
        cc = self.ccwfn
        hb, no = self._hb(), cc.no
        l1, l2 = self.cclambda.l1, self.cclambda.l2
        Ad = self._Adict(A)
        if self._df:
            from .models.dfresponse import inY1_df, inY2_df
            args = (hb, self._Loovv, self._Eoovv, cc.t1, cc.t2, l1, l2, Ad)
            return (inY1_df(*args, A.Aov, X1, X2, no),
                    inY2_df(*args, X1, X2, no,
                            nblocks=getattr(cc, "df_nblocks", None),
                            ladder=ladder))
        L = self._oovv(self._Loovv)
        return (in_Y1(hb, L, cc.t2, l1, l2, Ad, X1, X2, no, self._aux,
                      ladder=ladder),
                in_Y2(hb, L, self._oovv(self._Eoovv), cc.t2, l1, l2, Ad, X1,
                      X2, no, self._aux))

    def _r_Y(self, imY1, imY2, omega, Y1, Y2, ladder=vvvv_nt):
        """r_Y (full storage) or rY_df (DF) at the ccwfn's amplitudes."""
        cc = self.ccwfn
        if self._df:
            from .models.dfresponse import rY_df
            return rY_df(self._hb(), self._Loovv, cc.t1, cc.t2, imY1, imY2,
                         omega, Y1, Y2, cc.no,
                         nblocks=getattr(cc, "df_nblocks", None),
                         ladder=ladder)
        return r_Y(self._hb(), self._oovv(self._Loovv), cc.t2, imY1, imY2,
                   omega, Y1, Y2, cc.no, self._aux, ladder=ladder)

    def pseudoresponse(self, A, X1, X2):
        polar1 = 2.0 * contract("ai,ia->", torch.conj(A.Avo), X1)
        polar2 = 2.0 * contract("ijab,ijab->", torch.conj(A.Avvoo),
                                2.0 * X2 - X2.swapaxes(2, 3))
        return -2.0 * (polar1 + polar2)

    # ------------------------------------------------------------------
    def estimate_conditioning(self, omega, niter=24, max_diis=6, seed=0):
        """Randomized probe of sigma_min(HBAR - omega) on the physical
        (ij<->ab)-symmetric subspace: drive the solver's own Jacobi + DIIS
        fixed point with a random unit right-hand side g (numpy's
        default_rng(seed), as pycc_tpu draws it) and the pertbar zeroed,
        and return ||g|| / max_k ||z_k|| over `niter` steps.  An upper
        bound on sigma_min, so a warning gated on it never cries wolf
        (pycc_tpu/ccresponse.py:399-432 has the validation against a
        dense SVD).  sigma_min(M^T) = sigma_min(M), so one probe an omega
        serves both sides; results are cached per (omega, dtype)."""
        cc = self.ccwfn
        no, nv = cc.no, cc.nv
        t2 = cc.t2
        dt, dev = t2.dtype, t2.device
        key = (round(float(omega), 12), str(dt))
        hit = self._cond_cache.get(key)
        if hit is not None:
            return hit
        rng = np.random.default_rng(seed)
        g1 = rng.standard_normal((no, nv))
        g2 = rng.standard_normal((no, no, nv, nv))
        g2 = 0.5 * (g2 + g2.transpose(1, 0, 3, 2))
        nrm = np.sqrt((g1 ** 2).sum() + (g2 ** 2).sum())
        g1 = torch.as_tensor(g1 / nrm, dtype=dt, device=dev)
        g2 = torch.as_tensor(g2 / nrm, dtype=dt, device=dev)
        # r_X reads only these two pertbar blocks
        zeroA = {"Avo": torch.zeros((nv, no), dtype=dt, device=dev),
                 "Avvoo": torch.zeros_like(g2)}
        d1 = self.Dia + omega
        d2 = self.Dijab + omega
        diis = DIIS((g1, g2), max_diis=max_diis)
        state = diis.init()
        z1, z2 = torch.zeros_like(g1), torch.zeros_like(g2)
        maxn = torch.zeros((), dtype=dt, device=dev)
        for _ in range(niter):
            m1, m2 = self._r_X(zeroA, omega, z1, z2)
            z1n = z1 + (g1 + m1) / d1
            z2n = z2 + (g2 + m2) / d2
            diis.push(state, (z1n, z2n), (z1, z2))
            z1, z2 = diis.extrapolate(state, (z1n, z2n))
            maxn = torch.maximum(maxn, torch.sqrt((z1 ** 2).sum()
                                                  + (z2 ** 2).sum()))
        maxn = float(maxn)
        sigma = (1.0 / maxn) if maxn > 0 else float("inf")
        self._cond_cache[key] = sigma
        return sigma

    def _cond_gate(self, omega, rms, r_conv, side, sigma_warn=1e-2,
                   warn_factor=10.0):
        """Post-solve conditioning check: warn when the probe's sigma_min
        is below sigma_warn AND the implied ambiguity max(rms, r_conv) /
        sigma exceeds warn_factor * r_conv.  A diagnostic after a finished
        solve: a failed probe becomes a log line, not an error."""
        try:
            sigma = self.estimate_conditioning(omega)
        except (RuntimeError, ValueError) as exc:
            log.info("conditioning probe failed (%r); skipping" % (exc,))
            return None
        ambiguity = max(rms, r_conv) / max(sigma, 1e-300)
        if sigma < sigma_warn and ambiguity > warn_factor * r_conv:
            warnings.warn(
                "solve_%s at omega=%.6f: (HBAR - omega) is near-singular "
                "(probe sigma_min <= %.2e, an upper bound) — the solution "
                "is only determined to ~%.1e (||r||/sigma), beyond the "
                "requested r_conv=%.1e.  Any two converged iterates (e.g. "
                "warm vs cold starts) may legitimately differ by that "
                "much; shift omega away from the pole or tighten r_conv."
                % (side, float(omega), sigma, ambiguity, r_conv))
        return sigma

    # ------------------------------------------------------------------
    def _iterate(self, side, A, omega, start, residual, e_conv, r_conv,
                 maxiter, max_diis, start_diis, stall_limit, cond_check):
        """The Jacobi + DIIS loop both solvers share: `residual(v1, v2)`
        gives (r1, r2); each iteration steps by r / (D + omega), pushes the
        step into the DIIS ring, extrapolates from `start_diis`, and reads
        (pseudoresponse, rms) from the device once.  Returns (v1, v2,
        pseudo) and sets self.converged and self.niter."""
        t0 = time.time()
        timers = self.ccwfn.timers
        Dia = self.Dia + omega
        Dijab = self.Dijab + omega
        v1, v2 = start
        use_diis = max_diis > 0
        diis = DIIS((v1, v2), max_diis=max(max_diis, 1))
        state = diis.init() if use_diis else None
        pseudo = complex(self.pseudoresponse(A, v1, v2))
        rms = float("inf")
        best_rms = float("inf")
        stalled = 0
        for niter in range(1, maxiter + 1):
            with timers.time("response.%s_iteration" % side):
                pseudo_last = pseudo
                r1, r2 = residual(v1, v2)
                inc1 = r1 / Dia
                inc2 = r2 / Dijab
                v1n, v2n = v1 + inc1, v2 + inc2
                # |inc|^2: a real rms for complex increments too
                rms_t = torch.sqrt((inc1.abs() ** 2).sum()
                                   + (inc2.abs() ** 2).sum())
                pseudo_t = self.pseudoresponse(A, v1n, v2n)
                if use_diis:
                    diis.push(state, (v1n, v2n), (v1, v2))
                    if niter >= start_diis:
                        v1, v2 = diis.extrapolate(state, (v1n, v2n))
                    else:
                        v1, v2 = v1n, v2n
                else:
                    v1, v2 = v1n, v2n
                # the one host read of the iteration
                pseudo, rms = torch.stack([
                    pseudo_t.to(torch.complex128),
                    rms_t.to(torch.complex128)]).tolist()
                rms = rms.real
            self.niter = niter
            # the working precision's noise floor: stop after stall_limit
            # iterations without a 2% rms gain (as the CC and Lambda solvers)
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            else:
                stalled += 1
                if stall_limit and stalled >= stall_limit and rms >= r_conv:
                    self.converged = abs(pseudo - pseudo_last) < e_conv
                    log.info("\nsolve_%s hit the working-precision noise "
                             "floor (rms %.3E > r_conv %.1E, no improvement "
                             "in %d iterations); stopping.\n"
                             % (side, rms, r_conv, stall_limit))
                    if cond_check:
                        self._cond_gate(omega, rms, r_conv, side)
                    return v1n, v2n, pseudo
            if abs(pseudo - pseudo_last) < e_conv and rms < r_conv:
                log.info("\nPerturbed wave function converged in %.3f "
                         "seconds.\n" % (time.time() - t0))
                self.converged = True
                if cond_check:
                    self._cond_gate(omega, rms, r_conv, side)
                return v1n, v2n, pseudo
        self.converged = False
        warnings.warn("solve_%s did NOT converge in %d iterations "
                      "(rms=%.2e)" % (side, maxiter, rms))
        if cond_check:
            self._cond_gate(omega, rms, r_conv, side)
        return v1, v2, pseudo

    def _warm(self, v1, v2):
        """A warm start widened to the amplitudes' dtype, complex kept, its
        doubles made pair-symmetric (`models/ccsd.pair_symmetric`): the
        float32 roundoff of a mixed solve's floor stage moved the refined
        MU_Z pseudo-response of H2O/cc-pVDZ at omega = 0.0656 by 7.9e-9
        (pycc_tpu keeps it: the warm/cold drift its _solve_mixed
        docstring describes)."""
        t2 = self.ccwfn.t2
        v1 = torch.as_tensor(v1, device=t2.device)
        v2 = torch.as_tensor(v2, device=t2.device)
        dt = torch.promote_types(v1.dtype, t2.dtype)
        return v1.to(dt), pair_symmetric(v2.to(dt))

    def solve_right(self, A, omega, e_conv=1e-12, r_conv=1e-12, maxiter=200,
                    max_diis=7, start_diis=1, stall_limit=10,
                    X1_init=None, X2_init=None, cond_check=True):
        """The right-hand perturbed amplitudes X of pertbar A at omega:
        (HBAR - omega) X = -A.  Returns (X1, X2, pseudoresponse); X1, X2
        also stay on the object for solve_left."""
        Ad = self._Adict(A)
        if X1_init is not None:
            start = self._warm(X1_init, X2_init)
        else:
            start = (A.Avo.T / (self.Dia + omega),
                     A.Avvoo / (self.Dijab + omega))

        def residual(X1, X2):
            return self._r_X(Ad, omega, X1, X2)

        X1, X2, pseudo = self._iterate(
            "right", A, omega, start, residual, e_conv, r_conv, maxiter,
            max_diis, start_diis, stall_limit, cond_check)
        self.X1, self.X2 = X1, X2
        return X1, X2, pseudo

    def solve_left(self, A, omega, e_conv=1e-12, r_conv=1e-12, maxiter=200,
                   max_diis=7, start_diis=1, stall_limit=10,
                   Y1_init=None, Y2_init=None, cond_check=True):
        """The left-hand perturbed amplitudes Y of pertbar A at omega, over
        the X of the last solve_right.  Returns (Y1, Y2,
        pseudoresponse)."""
        if Y1_init is not None:
            start = self._warm(Y1_init, Y2_init)
        else:
            X1g = A.Avo.T / (self.Dia + omega)
            X2g = A.Avvoo / (self.Dijab + omega)
            start = (2.0 * X1g, 4.0 * X2g - 2.0 * X2g.swapaxes(2, 3))
        imY1, imY2 = self._in_Y(A, self.X1, self.X2)

        def residual(Y1, Y2):
            return self._r_Y(imY1, imY2, omega, Y1, Y2)

        Y1, Y2, pseudo = self._iterate(
            "left", A, omega, start, residual, e_conv, r_conv, maxiter,
            max_diis, start_diis, stall_limit, cond_check)
        self.Y1, self.Y2 = Y1, Y2
        return Y1, Y2, pseudo

    def _solve_mixed(self, side, pertkey, omega, e_conv, r_conv, maxiter,
                     sp_conv, sp_dtype, refine_maxiter, kw):
        """The mixed-precision perturbed-amplitude solve, the scheme of
        ccwfn.solve_cc_mixed: HBAR and pertbars rebuilt in `sp_dtype`
        (float32) and X (or Y) converged to sp_conv or its noise floor,
        then everything rebuilt in float64 and the same vectors refined.
        t1/t2 and l1/l2 (and, for a left solve, the right amplitudes X)
        are parameters of the response equations: their exact float64
        copies are restored for the refinement.  The HBAR and the
        pertbars are left at the float64 build; `self.pseudo_sp_floor` is
        the floor's pseudo-response.  Near a pole of (HBAR - omega) any
        two solutions of working precision may differ by
        ||r|| / sigma_min (`estimate_conditioning`)."""
        cc = self.ccwfn
        if cc.precision != "DP":
            raise ValueError("mixed-precision response needs a "
                             "precision='DP' ccwfn construction (the f64 "
                             "masters are the refinement-stage "
                             "Hamiltonian).")
        if getattr(cc, "local", None) is not None:
            raise ValueError("mixed-precision response supports canonical "
                             "storage modes only.")
        cc._ensure_mixed_masters()
        t1_64, t2_64 = cc.t1, cc.t2
        l1_64, l2_64 = self.cclambda.l1, self.cclambda.l2
        # a left solve reads the last right amplitudes: the floor takes
        # them in its own width (complex X in the complex one)
        X_64 = (self.X1, self.X2) if side == "left" else None
        cc._cast_stage(sp_dtype)
        self.cclambda.l1 = l1_64.to(sp_dtype)
        self.cclambda.l2 = l2_64.to(sp_dtype)
        if X_64 is not None:
            cdt = torch.complex64 if sp_dtype == torch.float32 \
                else torch.complex128
            self.X1, self.X2 = (x.to(cdt if x.is_complex() else sp_dtype)
                                for x in X_64)
        self._rebuild_stage(rebuild_hbar=True)
        solver = self.solve_right if side == "right" else self.solve_left
        v1, v2, self.pseudo_sp_floor = solver(
            self.pertbar[pertkey], omega, sp_conv, sp_conv, maxiter, **kw)
        cc._cast_stage(torch.float64)
        cc.t1, cc.t2 = t1_64, t2_64
        self.cclambda.l1, self.cclambda.l2 = l1_64, l2_64
        if X_64 is not None:
            self.X1, self.X2 = X_64
        self._rebuild_stage(rebuild_hbar=True)
        init = (dict(X1_init=v1, X2_init=v2) if side == "right"
                else dict(Y1_init=v1, Y2_init=v2))
        return solver(self.pertbar[pertkey], omega, e_conv, r_conv,
                      refine_maxiter or maxiter, **init, **kw)

    def solve_right_mixed(self, pertkey, omega, e_conv=1e-12, r_conv=1e-12,
                          maxiter=200, sp_conv=1e-6, sp_dtype=torch.float32,
                          refine_maxiter=None, **kw):
        """Mixed-precision right-hand (X) solve of the pertbar named
        `pertkey` ('MU_X', ...): the pertbar is rebuilt in each stage's
        dtype (`_solve_mixed`).  Returns (X1, X2, pseudo-response)."""
        return self._solve_mixed("right", pertkey, omega, e_conv, r_conv,
                                 maxiter, sp_conv, sp_dtype, refine_maxiter,
                                 kw)

    def solve_left_mixed(self, pertkey, omega, e_conv=1e-12, r_conv=1e-12,
                         maxiter=200, sp_conv=1e-6, sp_dtype=torch.float32,
                         refine_maxiter=None, **kw):
        """Mixed-precision left-hand (Y) solve (see solve_right_mixed); the
        right amplitudes it reads are `self.X1/X2` of the last right solve,
        as solve_left reads them."""
        return self._solve_mixed("left", pertkey, omega, e_conv, r_conv,
                                 maxiter, sp_conv, sp_dtype, refine_maxiter,
                                 kw)

    # ------------------------------------------------------------------
    def linresp_asym(self, pertkey_a, X1_B, X2_B, Y1_B, Y2_B):
        """The asymmetric linear-response function <<A;B>> of pertbar
        `pertkey_a` against B's perturbed amplitudes (a 0-d tensor)."""
        l1, l2 = self.cclambda.l1, self.cclambda.l2
        A = self.pertbar[pertkey_a]
        Avvoo = A.Avvoo.swapaxes(0, 2).swapaxes(1, 3)
        polar1 = contract("ai,ia->", A.Avo, Y1_B)
        polar1 += 0.5 * contract("abij,ijab->", Avvoo, Y2_B)
        polar1 += 0.5 * contract("baji,ijab->", Avvoo, Y2_B)
        polar2 = 2.0 * contract("ia,ia->", A.Aov, X1_B)
        tmp = contract("ia,ic->ac", l1, X1_B)
        polar2 += contract("ac,ac->", tmp, A.Avv)
        tmp = contract("ia,ka->ik", l1, X1_B)
        polar2 -= contract("ik,ki->", tmp, A.Aoo)
        tmp = contract("ia,jb->ijab", l1, A.Aov)
        polar2 += 2.0 * contract("ijab,ijab->", tmp, X2_B)
        polar2 -= contract("ijab,ijba->", tmp, X2_B)
        if self._df:
            # 'ijbc,bcaj->ia' over Avvvo[bcaj] = -t2[mjbc] pert[ma],
            # through an o^2 intermediate (the o v^3 block is not formed)
            G = contract("ijbc,mjbc->im", l2, self.ccwfn.t2)
            tmp = -1.0 * contract("im,ma->ia", G, A.Aov)
        else:
            tmp = contract("ijbc,bcaj->ia", l2, A.Avvvo)
        polar2 += contract("ia,ia->", tmp, X1_B)
        tmp = contract("ijab,kbij->ak", l2, A.Aovoo)
        polar2 -= 0.5 * contract("ak,ka->", tmp, X1_B)
        tmp = contract("ijab,kaji->bk", l2, A.Aovoo)
        polar2 -= 0.5 * contract("bk,kb->", tmp, X1_B)
        tmp = contract("ijab,kjab->ik", l2, X2_B)
        polar2 -= 0.5 * contract("ik,ki->", tmp, A.Aoo)
        tmp = contract("ijab,kiba->jk", l2, X2_B)
        polar2 -= 0.5 * contract("jk,kj->", tmp, A.Aoo)
        tmp = contract("ijab,ijac->bc", l2, X2_B)
        polar2 += 0.5 * contract("bc,bc->", tmp, A.Avv)
        tmp = contract("ijab,ijcb->ac", l2, X2_B)
        polar2 += 0.5 * contract("ac,ac->", tmp, A.Avv)
        return -1.0 * (polar1 + polar2)

    def linresp(self, A, B, omega, e_conv=1e-13, r_conv=1e-13, maxiter=200,
                max_diis=8, start_diis=1):
        """The CC linear-response tensor <<A_a;B_b>>_omega as a 3x3 host
        array: X and Y of each Cartesian component of B at +omega, then
        `linresp_asym` against every component of A.  A, B in {"MU", "M",
        "M*", "P", "P*"}; for Q use the "Q_xy" pertbar keys with
        solve_right/solve_left directly.  Real unless a mixed
        real/imaginary operator pair makes it imaginary."""
        A, B = A.upper(), B.upper()
        if A == "Q" or B == "Q":
            raise ValueError("use per-component Q_ab keys for quadrupole LR")
        XB, YB = {}, {}
        for b in range(3):
            pert = self.pertbar[B + "_" + self.cart[b]]
            X1, X2, _ = self.solve_right(pert, omega, e_conv, r_conv,
                                         maxiter, max_diis, start_diis)
            Y1, Y2, _ = self.solve_left(pert, omega, e_conv, r_conv,
                                        maxiter, max_diis, start_diis)
            XB[b], YB[b] = (X1, X2), (Y1, Y2)
        vals = torch.stack([
            self.linresp_asym(A + "_" + self.cart[a], *XB[b], *YB[b])
            .to(torch.complex128) for a in range(3) for b in range(3)])
        resp = np.array(vals.tolist(), dtype=complex).reshape(3, 3)
        if np.abs(resp.imag).max() < 1e-12:
            return resp.real
        return resp

    def pertcheck(self, omega, e_conv=1e-13, r_conv=1e-13, maxiter=200,
                  max_diis=8, start_diis=1):
        """Converge X for every perturbation at +omega and, unless omega is
        0, at -omega; returns {key_omega: pseudoresponse}."""
        check = {}
        for key, A in self.pertbar.items():
            for om in ((omega, -omega) if omega != 0.0 else (omega,)):
                _, _, pseudo = self.solve_right(A, om, e_conv, r_conv,
                                                maxiter, max_diis, start_diis)
                check[key + "_%0.6f" % om] = pseudo
        return check
