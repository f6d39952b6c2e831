"""CC one- and two-electron densities and density-based energies.

The counterpart of pycc_tpu/ccdensity.py for storage='full', 'blocked'
and 'df':
every block is a plain function of the amplitudes, `onepdm` assembles the
(nact, nact) one-electron density, and `ccdensity.compute_energy` gives
the density-vs-amplitude consistency check (for CCSD(T), with the (T)
blocks of `ccwfn.t3_density()`).  Under storage='df' the v^4 Dvvvv and
v^3 o Dvvvo blocks are never formed: compute_energy evaluates their
energy terms over the factors (models/dfdensity.py, two K1 ladders).
"""

import time

import torch

from .cclambda import build_Goo, build_Gvv
from .models.blocked import eri_views
from .models.ccsd import build_tau, slices
from .ops.contract import contract
from .ops.kernels.vvvv import vvvv_nt
from .utils.log import logger as log


def build_Doo(model, t1, t2, l1, l2, extra=None):
    Doo = -contract("imef,jmef->ij", t2, l2)
    if model != "CCD":
        Doo -= contract("ie,je->ij", t1, l1)
    if extra is not None:
        Doo += extra
    return Doo


def build_Dvv(model, t1, t2, l1, l2, extra=None):
    Dvv = contract("mnbe,mnae->ab", t2, l2)
    if model != "CCD":
        Dvv += contract("mb,ma->ab", t1, l1)
    if extra is not None:
        Dvv += extra
    return Dvv


def build_Dvo(l1):
    return l1.T


def build_Dov(model, t1, t2, l1, l2, extra=None):
    if model == "CCD":
        return torch.zeros_like(t1)
    Dov = 2.0 * t1
    Dov += 2.0 * contract("me,imae->ia", l1, t2)
    Dov -= contract("me,miae->ia", l1, build_tau(t1, t2))
    tmp = contract("mnef,inef->mi", l2, t2)
    Dov -= contract("mi,ma->ia", tmp, t1)
    tmp = contract("mnef,mnaf->ea", l2, t2)
    Dov -= contract("ea,ie->ia", tmp, t1)
    if extra is not None:
        Dov += extra
    return Dov


def build_Doooo(model, t1, t2, l2):
    if model == "CCD":
        return contract("ijef,klef->ijkl", t2, l2)
    if model == "CC2":
        return contract("jf,klif->ijkl", t1, contract("ie,klef->klif", t1, l2))
    return contract("ijef,klef->ijkl", build_tau(t1, t2), l2)


def build_Dvvvv(model, t1, t2, l2):
    if model == "CCD":
        return contract("mnab,mncd->abcd", t2, l2)
    if model == "CC2":
        return contract("nb,ancd->abcd", t1, contract("ma,mncd->ancd", t1, l2))
    return contract("mnab,mncd->abcd", build_tau(t1, t2), l2)


def build_Dooov(model, t1, t2, l1, l2, extra=None):
    if model == "CCD":
        no, nv = t1.shape
        return torch.zeros((no, no, no, nv), dtype=t2.dtype, device=t2.device)
    tau = build_tau(t1, t2)
    tmp = 2.0 * tau - tau.swapaxes(2, 3)
    D = -1.0 * contract("ke,ijea->ijka", l1, tmp)
    D -= contract("ie,jkae->ijka", t1, l2)
    if model != "CC2":
        Goo = build_Goo(t2, l2)
        D -= 2.0 * contract("ik,ja->ijka", Goo, t1)
        D += contract("jk,ia->ijka", Goo, t1)
        tmp = contract("jmaf,kmef->jake", t2, l2)
        D -= 2.0 * contract("jake,ie->ijka", tmp, t1)
        D += contract("iake,je->ijka", tmp, t1)
        tmp = contract("ijef,kmef->ijkm", t2, l2)
        D += contract("ijkm,ma->ijka", tmp, t1)
        tmp = contract("mjaf,kmef->jake", t2, l2)
        D += contract("jake,ie->ijka", tmp, t1)
        tmp = contract("imea,kmef->iakf", t2, l2)
        D += contract("iakf,jf->ijka", tmp, t1)
    tmp = contract("kmef,jf->kmej", l2, t1)
    tmp = contract("kmej,ie->kmij", tmp, t1)
    D += contract("kmij,ma->ijka", tmp, t1)
    if extra is not None:
        D += extra
    return D


def build_Dvvvo(model, t1, t2, l1, l2, extra=None):
    if model == "CCD":
        no, nv = t1.shape
        return torch.zeros((nv, nv, nv, no), dtype=t2.dtype, device=t2.device)
    tau = build_tau(t1, t2)
    tmp = 2.0 * tau - tau.swapaxes(2, 3)
    D = contract("mc,miab->abci", l1, tmp)
    D += contract("ma,imbc->abci", t1, l2)
    if model != "CC2":
        Gvv = build_Gvv(t2, l2)
        D -= 2.0 * contract("ca,ib->abci", Gvv, t1)
        D += contract("cb,ia->abci", Gvv, t1)
        tmp = contract("imbe,nmce->ibnc", t2, l2)
        D += 2.0 * contract("ibnc,na->abci", tmp, t1)
        D -= contract("ianc,nb->abci", tmp, t1)
        tmp = contract("nmab,nmce->abce", t2, l2)
        D -= contract("abce,ie->abci", tmp, t1)
        tmp = contract("niae,nmce->iamc", t2, l2)
        D -= contract("iamc,mb->abci", tmp, t1)
        tmp = contract("mibe,nmce->ibnc", t2, l2)
        D -= contract("ibnc,na->abci", tmp, t1)
    tmp = contract("nmce,ie->nmci", l2, t1)
    tmp = contract("nmci,na->amci", tmp, t1)
    D -= contract("amci,mb->abci", tmp, t1)
    if extra is not None:
        D += extra
    return D


def build_Dovov(model, t1, t2, l1, l2):
    if model == "CCD":
        D = -contract("mibe,jmea->iajb", t2, l2)
        D -= contract("imbe,mjea->iajb", t2, l2)
        return D
    D = -1.0 * contract("ia,jb->iajb", t1, l1)
    if model == "CC2":
        D -= contract("mb,jmia->iajb", t1, contract("ie,jmea->jmia", t1, l2))
    else:
        D -= contract("mibe,jmea->iajb", build_tau(t1, t2), l2)
        D -= contract("imbe,mjea->iajb", t2, l2)
    return D


def build_Doovv(model, t1, t2, l1, l2, extra=None):
    tau = build_tau(t1, t2)
    tau_s = 2.0 * tau - tau.swapaxes(2, 3)

    def _t2_terms(D):
        D += 4.0 * contract("imae,mjeb->ijab", t2, l2)
        D -= 2.0 * contract("mjbe,imae->ijab", tau, l2)
        tmp_oooo = contract("ijef,mnef->ijmn", t2, l2)
        D += contract("ijmn,mnab->ijab", tmp_oooo, t2)
        tmp1 = contract("njbf,mnef->jbme", t2, l2)
        D += contract("jbme,miae->ijab", tmp1, t2)
        tmp1 = contract("imfb,mnef->ibne", t2, l2)
        D += contract("ibne,njae->ijab", tmp1, t2)
        Gvv = build_Gvv(t2, l2)
        D += 4.0 * contract("eb,ijae->ijab", Gvv, tau)
        D -= 2.0 * contract("ea,ijbe->ijab", Gvv, tau)
        Goo = build_Goo(t2, l2)
        D -= 4.0 * contract("jm,imab->ijab", Goo, tau)
        D += 2.0 * contract("jm,imba->ijab", Goo, tau)
        tmp1 = contract("inaf,mnef->iame", t2, l2)
        D -= 4.0 * contract("iame,mjbe->ijab", tmp1, tau)
        D += 2.0 * contract("ibme,mjae->ijab", tmp1, tau)
        D += 4.0 * contract("jbme,imae->ijab", tmp1, t2)
        D -= 2.0 * contract("jame,imbe->ijab", tmp1, t2)
        return D, tmp_oooo

    if model == "CCD":
        D = 2.0 * tau_s + l2
        D, _ = _t2_terms(D)
        return D

    D = 4.0 * contract("ia,jb->ijab", t1, l1)
    D += 2.0 * tau_s
    D += l2
    tmp1 = 2.0 * t2 - t2.swapaxes(2, 3)
    tmp2 = 2.0 * contract("me,jmbe->jb", l1, tmp1)
    D += 2.0 * contract("jb,ia->ijab", tmp2, t1)
    D -= contract("ja,ib->ijab", tmp2, t1)
    tmp2 = 2.0 * contract("ijeb,me->ijmb", tmp1, l1)
    D -= contract("ijmb,ma->ijab", tmp2, t1)
    tmp2 = 2.0 * contract("jmba,me->jeba", tau_s, l1)
    D -= contract("jeba,ie->ijab", tmp2, t1)

    if model == "CC2":
        D -= 2.0 * contract("mb,imaj->ijab", t1,
                            contract("je,imae->imaj", t1, l2))
    else:
        D, tmp_oooo = _t2_terms(D)
        tmp = contract("nb,ijmn->ijmb", t1, tmp_oooo)
        D += contract("ma,ijmb->ijab", t1, tmp)
        tmp = contract("ie,mnef->mnif", t1, l2)
        tmp = contract("jf,mnif->mnij", t1, tmp)
        D += contract("mnij,mnab->ijab", tmp, t2)
        tmp = contract("ie,mnef->mnif", t1, l2)
        tmp = contract("mnif,njbf->mijb", tmp, t2)
        D += contract("ma,mijb->ijab", t1, tmp)
        tmp = contract("jf,mnef->mnej", t1, l2)
        tmp = contract("mnej,miae->njia", tmp, t2)
        D += contract("nb,njia->ijab", t1, tmp)
        tmp = contract("je,mnef->mnjf", t1, l2)
        tmp = contract("mnjf,imfb->njib", tmp, t2)
        D += contract("na,njib->ijab", t1, tmp)
        tmp = contract("if,mnef->mnei", t1, l2)
        tmp = contract("mnei,njae->mija", tmp, t2)
        D += contract("mb,mija->ijab", t1, tmp)

    tmp = contract("jf,mnef->mnej", t1, l2)
    tmp = contract("ie,mnej->mnij", t1, tmp)
    tmp = contract("nb,mnij->mbij", t1, tmp)
    D += contract("ma,mbij->ijab", t1, tmp)
    if extra is not None:
        D += extra
    return D


def onepdm(model, t1, t2, l1, l2, no, nact,
           Doo_x=None, Dvv_x=None, Dov_x=None):
    """Correlated one-electron density as a full (nact, nact) matrix."""
    o, v = slices(no)
    opdm = torch.zeros((nact, nact), dtype=t1.dtype, device=t1.device)
    opdm[o, o] = build_Doo(model, t1, t2, l1, l2, Doo_x)
    opdm[v, v] = build_Dvv(model, t1, t2, l1, l2, Dvv_x)
    opdm[o, v] = build_Dov(model, t1, t2, l1, l2, Dov_x)
    opdm[v, o] = build_Dvo(l1)
    return opdm


# T1-transformed dipole blocks used by CC3 properties
def build_Moo(no, nv, ints, t1):
    return ints[:no, :no] + contract("ma,ia->mi", ints[:no, -nv:], t1)


def build_Mvv(no, nv, ints, t1):
    return ints[-nv:, -nv:] - contract("ie,ia->ae", ints[:no, -nv:], t1)


class ccdensity:
    """ccdensity(ccwfn, cclambda[, onlyone]): the density blocks of a
    storage='full', 'blocked' or 'df' ccwfn on its device (over the
    blocks' views the energy reads the six blocks; over factors without
    Dvvvv and Dvvvo); for CCSD(T) the (T) blocks that
    `ccwfn.t3_density()` left on the ccwfn join them."""

    def __init__(self, ccwfn, cclambda, onlyone=False):
        storage = getattr(ccwfn, "storage", "full")
        t0 = time.time()
        self.ccwfn = ccwfn
        self.cclambda = cclambda
        self.onlyone = onlyone
        self._df = storage == "df"
        model = ccwfn.model
        t1, t2 = ccwfn.t1, ccwfn.t2
        l1, l2 = cclambda.l1, cclambda.l2

        def t3(name):
            return getattr(ccwfn, name, None) if model == "CCSD(T)" else None

        self.Dov = build_Dov(model, t1, t2, l1, l2, t3("Dov_t3"))
        self.Dvo = build_Dvo(l1)
        self.Dvv = build_Dvv(model, t1, t2, l1, l2, t3("Dvv_t3"))
        self.Doo = build_Doo(model, t1, t2, l1, l2, t3("Doo_t3"))
        if not onlyone:
            self.Doooo = build_Doooo(model, t1, t2, l2)
            self.Dooov = build_Dooov(model, t1, t2, l1, l2, t3("Gooov"))
            self.Dovov = build_Dovov(model, t1, t2, l1, l2)
            self.Doovv = build_Doovv(model, t1, t2, l1, l2, t3("Goovv"))
            if not self._df:
                self.Dvvvv = build_Dvvvv(model, t1, t2, l2)
                self.Dvvvo = build_Dvvvo(model, t1, t2, l1, l2,
                                         t3("Gvvvo"))
        log.info("\nCCDENSITY constructed in %.3f seconds.\n"
                 % (time.time() - t0))

    def compute_energy(self, ladder=vvvv_nt):
        """The correlation energy from the densities (one host read).
        Under storage='df' the two-electron energy comes from the factors
        (`dfdensity.density_energy_df`), its vvvv and vvvo ladders one
        `ladder` call (K1 by default) an a-block."""
        cc = self.ccwfn
        o, v = cc.o, cc.v
        F = cc.H.F
        eone = (contract("ij,ij->", F[o, o], self.Doo)
                + contract("ab,ab->", F[v, v], self.Dvv))
        if self.onlyone:
            self.ecc = float(eone)
            return self.ecc
        if self._df:
            from .models.dfdensity import density_energy_df
            lam = self.cclambda
            eone, etwo = density_energy_df(
                F, cc.dfb, cc.t1, cc.t2, lam.l1, lam.l2, cc.no,
                model=cc.model, Doo=self.Doo, Dvv=self.Dvv,
                Doooo=self.Doooo, Dooov=self.Dooov, Dovov=self.Dovov,
                Doovv=self.Doovv,
                Gvvvo=(getattr(cc, "Gvvvo", None)
                       if cc.model == "CCSD(T)" else None),
                nblocks=getattr(cc, "df_nblocks", None), ladder=ladder)
        else:
            ERI = eri_views(cc)[0]
            etwo = 0.5 * contract("ijkl,ijkl->", ERI[o, o, o, o], self.Doooo)
            etwo += 0.5 * contract("abcd,abcd->", ERI[v, v, v, v],
                                   self.Dvvvv)
            etwo += contract("ijka,ijka->", ERI[o, o, o, v], self.Dooov)
            etwo += contract("abci,abci->", ERI[v, v, v, o], self.Dvvvo)
            etwo += contract("iajb,iajb->", ERI[o, v, o, v], self.Dovov)
            etwo += 0.5 * contract("ijab,ijab->", ERI[o, o, v, v],
                                   self.Doovv)
        self.eone, self.etwo = torch.stack([eone, etwo]).tolist()
        self.ecc = self.eone + self.etwo
        log.info("One-electron CC energy = %20.15f" % self.eone)
        log.info("Two-electron CC energy = %20.15f" % self.etwo)
        log.info("CC Correlation Energy  = %20.15f" % self.ecc)
        return self.ecc

    def compute_onepdm(self, t1, t2, l1, l2, real_time=False):
        """The (nact, nact) one-electron density at (t, l); for CC3 the pair
        (opdm, opdm_cc3), opdm_cc3 holding the triples Doo/Dvv blocks that
        go with the T1-transformed property integrals (`build_Moo`,
        `build_Mvv`), over the full T3/L3 or one slab at a time
        (`ccwfn.t3_slabs`; over factors always the slab form)."""
        cc = self.ccwfn
        if cc.model == "CC3":
            from .ccwfn import t3_slabs
            from .models.cc3 import cc3_onepdm, cc3_onepdm_scan
            fn = cc3_onepdm_scan if t3_slabs(cc) else cc3_onepdm
            return fn(cc, t1, t2, l1, l2, real_time=real_time)
        return onepdm(cc.model, t1, t2, l1, l2, cc.no, cc.nact)
