"""CC3: the iterative approximate-triples model.

The counterpart of pycc_tpu/models/cc3.py for storage='full' and
'blocked' and over Cholesky/DF factors (energy, Lambda and the
one-electron density).  Each function keeps the name of its counterpart
and its terms.

Two forms of every triples contribution:

- the full-tensor forms (`residuals_cc3`, `cc3_lambda_extra`,
  `cc3_onepdm`) hold the whole o^3 v^3 T3 and L3, for small systems and
  tests;
- the slab forms (`residuals_cc3_scan`, `cc3_lambda_extra_scan`,
  `cc3_onepdm_scan`, `residuals_cc3_scan_df`, `cc3_lambda_extra_scan_df`;
  over factors the W's come from `cc3_intermediates_df` and
  `cc3_lambda_intermediates_df`) are a Python loop over the
  occupied rows, each row a loop over (i, j) pair slabs (k, a, b, c) of
  o v^3 elements.  They are pycc_tpu's row bodies (`_cc3_row_xs`,
  `_cc3_lambda_row_t3`, `_cc3_lambda_row_l3`, `_cc3_onepdm_row`); past
  no v^3 = 2^27 elements the k-chunked rows bound each slab to kc v^3
  (`_t_df_kc`), as pycc_tpu selects them.  The whole-row slabs of
  pycc_tpu's in-jit scans (`_cc3_t3_slab`, `l3_slab`, o^2 v^3 each) are
  here too, equal to the stacks of a row's pair slabs; no solver calls
  them.

The CCSD part of the residual is models/ccsd.residuals_ccsd (or
dfccsd.residuals_ccsd_df), whose particle-particle ladder is the K1
kernel; the T3/L3 slab work is torch.einsum, as it is einsum outside any
Pallas kernel in pycc_tpu.
"""

import torch

from ..ops.contract import contract
from ..ops.kernels.vvvv import vvvv_nt
from ..parallel.mesh import dense
from ..triples import (_dslice, _swap_ac, _swap_bc, _t3c_chunk_ij,
                       _t3c_slab, _t3c_slab_ij, _t_df_kc, slab_layouts,
                       t3_denom, t3c_full)
from .blocked import eri_views
from .ccsd import build_Fme, residuals_ccsd, slices

# no v^3 elements of one pair slab past which the rows are k-chunked
_CHUNK_ELEMS = 2 ** 27


def _chunked(no, nv):
    return no * nv ** 3 > _CHUNK_ELEMS


def _Vov(F, F_ref, no, real_time):
    """The field part of F in the ov block (zero outside real time)."""
    o, v = slices(no)
    if real_time:
        return (F - F_ref.to(F.dtype))[o, v]
    return torch.zeros_like(F[o, v])


# ---------------------------------------------------------------------------
# T1-dressed intermediates
# ---------------------------------------------------------------------------

def cc3_intermediates(ERI, t1, no):
    o, v = slices(no)
    Wmnij = ERI[o, o, o, o]
    tmp = contract("ijma,na->ijmn", ERI[o, o, o, v], t1)
    Wmnij = Wmnij + tmp + tmp.permute(1, 0, 3, 2)
    Wmnij = Wmnij + contract("mnif,jf->mnij",
                             contract("ia,mnaf->mnif", t1, ERI[o, o, v, v]), t1)

    Wmbij = ERI[o, v, o, o]
    Wmbij = Wmbij - contract("mnij,nb->mbij", Wmnij, t1)
    Wmbij = Wmbij + contract("mbie,je->mbij", ERI[o, v, o, v], t1)
    tmp = ERI[o, v, v, o] + contract("mbef,jf->mbej", ERI[o, v, v, v], t1)
    Wmbij = Wmbij + contract("ie,mbej->mbij", t1, tmp)

    Wmnie = ERI[o, o, o, v] + contract("if,mnfe->mnie", t1, ERI[o, o, v, v])
    Wamef = ERI[v, o, v, v] - contract("na,nmef->amef", t1, ERI[o, o, v, v])

    # Wabei
    Z = ERI[v, o, v, v]
    tmp_ints = ERI[v, v, v, v] + ERI[v, v, v, v].swapaxes(2, 3)
    Z1 = 0.5 * contract("if,abef->eiab", t1, tmp_ints)
    tmp_ints = ERI[v, v, v, v] - ERI[v, v, v, v].swapaxes(2, 3)
    Z2 = 0.5 * contract("if,abef->eiab", t1, tmp_ints)
    del tmp_ints
    Z_eiab = Z + Z1 + Z2
    Zeiam = ERI[v, o, v, o]
    Zamei = contract("amef,if->amei", ERI[v, o, v, v], t1)
    Zeiam = Zeiam + Zamei.permute(2, 3, 0, 1)
    Z_eiab = Z_eiab - contract("eiam,mb->eiab", Zeiam, t1)
    Zmnei = ERI[o, o, v, o] + contract("mnef,if->mnei", ERI[o, o, v, v], t1)
    Zanei = contract("ma,mnei->anei", t1, Zmnei)
    Z_eiab = Z_eiab + contract("anei,nb->eiab", Zanei, t1)
    Zmbei = ERI[o, v, v, o] + contract("mbef,if->mbei", ERI[o, v, v, v], t1)
    Z_abei = -1.0 * contract("ma,mbei->abei", t1, Zmbei)
    Wabei = Z_abei + Z_eiab.permute(2, 3, 0, 1)

    return Wmnij, Wmbij, Wmnie, Wamef, Wabei


def cc3_intermediates_df(dfb, t1, no, scan_layout=False):
    """The five T1-dressed W intermediates of `cc3_intermediates` from
    Cholesky/DF factors, ERI[p,q,r,s] = <pq|rs> = sum_P B[P,p,r] B[P,q,s],
    term by term with the t1 dressings folded into the factors:

      t1[if] on a ket virtual  -> Cbi[P,b,i] = Bvv[P,b,f] t1[i,f]
      t1[if] on a ket occupied -> Dmi[P,m,i] = Bov[P,m,f] t1[i,f]
      t1[ma] on a bra virtual  -> Sae[P,a,e] = t1[m,a] Bov[P,m,e]
      t1[mb] on a bra occupied -> Eib[P,i,b] = Boo[P,i,m] t1[m,b]

    The o v^3 tensors (Wamef, Wabei) are formed; nothing nact^4 is.
    scan_layout=True gives Wabei as the occupied-major (i,a,b,e) slab
    layout and Wmbij as (i,j,m,b), those of `triples.slab_layouts`."""
    # Bvv whole (assembled once a call on a mesh)
    Boo, Bov, Bvv = dfb.Boo, dfb.Bov, dense(dfb.Bvv)
    Bvo = Bov.transpose(1, 2)
    Dmi = contract("Pmf,if->Pmi", Bov, t1)
    Cbi = contract("Pbf,if->Pbi", Bvv, t1)
    CbiT = Cbi.transpose(1, 2)
    Sae = contract("ma,Pme->Pae", t1, Bov)
    Eib = contract("Pim,mb->Pib", Boo, t1)
    Gib = contract("Pmi,mb->Pib", Dmi, t1)
    Kib = contract("Pni,nb->Pib", Boo + Dmi, t1)

    tmp = contract("Pmi,Pnj->mnij", Boo, Dmi)
    Wmnij = (contract("Pmi,Pnj->mnij", Boo, Boo)
             + tmp + tmp.permute(1, 0, 3, 2)
             + contract("Pmi,Pnj->mnij", Dmi, Dmi))

    Wmbij = (contract("Pmi,Pbj->mbij", Boo, Bvo + Cbi)
             - contract("mnij,nb->mbij", Wmnij, t1)
             + contract("Pmi,Pbj->mbij", Dmi, Bvo + Cbi))

    Wmnie = contract("Pmi,Pne->mnie", Boo + Dmi, Bov)
    Wamef = contract("Pae,Pmf->amef", Bvv - Sae, Bov)

    # Wabei = Z_abei + Z_eiab^T, the six dense terms regrouped into two
    # factor products
    out = "iabe" if scan_layout else "abei"
    Wabei = (contract("Pae,Pib->" + out, Bvv, Bov + CbiT - Eib - Gib)
             + contract("Pae,Pib->" + out, Sae, Kib - Bov - CbiT))
    if scan_layout:
        Wmbij = Wmbij.permute(2, 3, 0, 1).contiguous()
    return Wmnij, Wmbij, Wmnie, Wamef, Wabei


def cc3_lambda_intermediates(ERI, t1, no):
    o, v = slices(no)
    Wmbje = (ERI[o, v, o, v]
             + contract("mbfe,jf->mbje", ERI[o, v, v, v], t1)
             - contract("mnje,nb->mbje", ERI[o, o, o, v], t1)
             - contract("mnfe,jf,nb->mbje", ERI[o, o, v, v], t1, t1))
    Wmbej = (ERI[o, v, v, o]
             + contract("mbef,jf->mbej", ERI[o, v, v, v], t1)
             - contract("mnej,nb->mbej", ERI[o, o, v, o], t1)
             - contract("mnef,jf,nb->mbej", ERI[o, o, v, v], t1, t1))
    Wabef = ERI[v, v, v, v]
    tmp = contract("mbef,ma->abef", ERI[o, v, v, v], t1)
    Wabef = Wabef - tmp - tmp.permute(1, 0, 3, 2)
    del tmp
    Wabef = Wabef + contract("mnef,ma,nb->abef", ERI[o, o, v, v], t1, t1)
    return Wmbje, Wmbej, Wabef


def cc3_lambda_intermediates_df(dfb, t1, no):
    """`cc3_lambda_intermediates` from factors.  Wmbje/Wmbej are pure
    t1-dressed integrals (rank-1 factor assemblies); Wabef is exactly the
    dressed bilinear sum_P Bd_ae[P,a,e] Bd_ae[P,b,f] (the t1.t1 bilinear
    of the dense form is the product of the two dressings), so the v^4
    tensor stays implicit: the third output is Bd_ae, and its one consumer
    contracts against it (`_wvvvv_y1`)."""
    # Bvv whole (assembled once a call on a mesh)
    Boo, Bov, Bvv = dfb.Boo, dfb.Bov, dense(dfb.Bvv)
    Bvo = Bov.transpose(1, 2)
    Dmi = contract("Pmf,if->Pmi", Bov, t1)
    Cbi = contract("Pbf,if->Pbi", Bvv, t1)
    Sae = contract("ma,Pme->Pae", t1, Bov)
    Bd_ae = Bvv - Sae

    # Wmbje[mbje] = <mb|je> + t1[jf]<mb|fe> - t1[nb]<mn|je> - bilinear
    #   <mb|je> = (mj|be); t1[jf]<mb|fe> = t1[jf](mf|be) -> Dmi.Bvv;
    #   t1[nb]<mn|je> = t1[nb](mj|ne) and the bilinear both dress the
    #   (b,e) factor with -t1[nb]Bov[P,n,e], which is Bd_ae
    Wmbje = contract("Pmj,Pbe->mbje", Boo + Dmi, Bd_ae)

    # Wmbej[mbej] = <mb|ej> + t1[jf]<mb|ef> - t1[nb]<mn|ej> - bilinear
    #   <mb|ej> = (me|bj); t1[jf]<mb|ef> = t1[jf](me|bf) -> Bov.Cbi;
    #   t1[nb]<mn|ej> = t1[nb](me|nj) -> Bov.(Boo-dressed);
    #   bilinear: t1[jf]t1[nb](me|nf) -> Bov.(Dmi-dressed)
    Fbj = contract("nb,Pnj->Pbj", t1, Boo + Dmi)
    Wmbej = contract("Pme,Pbj->mbej", Bov, Bvo + Cbi - Fbj)
    return Wmbje, Wmbej, Bd_ae


# ---------------------------------------------------------------------------
# T3 over the full index space, with the real-time perturbation term
# ---------------------------------------------------------------------------

def t3_pert_full(F, F_ref, t2, no):
    """Connected-T3 perturbation correction of real-time CC3."""
    o, v = slices(no)
    V = F - F_ref.to(F.dtype)
    tmp = contract("ld,ijad->ijal", V[o, v], t2)
    t3 = contract("ijal,klcb->ijkabc", tmp, t2)
    return t3 / t3_denom(F, no)


def cc3_t3_full(F, ERI, t1, t2, no, real_time=False, F_ref=None):
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    t3 = t3c_full(Wabei, Wmbij, t2, F, no)
    if real_time:
        t3 = t3 - t3_pert_full(F, F_ref, t2, no)
    return t3, (Wmnij, Wmbij, Wmnie, Wamef, Wabei)


# ---------------------------------------------------------------------------
# CC3 ground-state residuals
# ---------------------------------------------------------------------------

def residuals_cc3(F, ERI, L, vvvv, t1, t2, no, real_time=False, F_ref=None,
                  ladder=vvvv_nt):
    """CC3 T1/T2 residuals over the full T3 tensor: the CCSD residuals
    (their ladder through `ladder`, K1 by default) plus the T3 terms."""
    o, v = slices(no)
    r1, r2 = residuals_ccsd(F, ERI, L, vvvv, t1, t2, no, ladder=ladder)
    Fme = build_Fme(F, L, t1, no)
    t3, (Wmnij, Wmbij, Wmnie, Wamef, Wabei) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=F_ref)

    td = t3 - _swap_ac(t3)
    T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
    X1 = contract("ijkabc,jkbc->ia", td, L[o, o, v, v])
    X2 = contract("ijkabc,kc->ijab", td, Fme)
    X2 += contract("ijkabc,dkbc->ijad", T, Wamef)
    X2 -= contract("ijkabc,jklc->ilab", T, Wmnie)

    r1 = r1 + X1
    r2 = r2 + X2 + X2.permute(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# L3 over the full index space
# ---------------------------------------------------------------------------

def l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no):
    o, v = slices(no)
    Lo = L[o, o, v, v]
    l3 = contract("ijab,kc->ijkabc", Lo, l1) - contract("ijac,kb->ijkabc", Lo, l1)
    l3 += contract("ikac,jb->ijkabc", Lo, l1) - contract("ikab,jc->ijkabc", Lo, l1)
    l3 += contract("jiba,kc->ijkabc", Lo, l1) - contract("jibc,ka->ijkabc", Lo, l1)
    l3 += contract("kica,jb->ijkabc", Lo, l1) - contract("kicb,ja->ijkabc", Lo, l1)
    l3 += contract("jkbc,ia->ijkabc", Lo, l1) - contract("jkba,ic->ijkabc", Lo, l1)
    l3 += contract("kjcb,ia->ijkabc", Lo, l1) - contract("kjca,ib->ijkabc", Lo, l1)

    l3 += contract("ia,jkbc->ijkabc", Fov, l2) - contract("ib,jkac->ijkabc", Fov, l2)
    l3 += contract("ia,kjcb->ijkabc", Fov, l2) - contract("ic,kjab->ijkabc", Fov, l2)
    l3 += contract("jb,ikac->ijkabc", Fov, l2) - contract("ja,ikbc->ijkabc", Fov, l2)
    l3 += contract("kc,ijab->ijkabc", Fov, l2) - contract("ka,ijcb->ijkabc", Fov, l2)
    l3 += contract("jb,kica->ijkabc", Fov, l2) - contract("jc,kiba->ijkabc", Fov, l2)
    l3 += contract("kc,jiba->ijkabc", Fov, l2) - contract("kb,jica->ijkabc", Fov, l2)

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    l3 += contract("ejab,kice->ijkabc", tW, l2)
    l3 += contract("ekac,jibe->ijkabc", tW, l2)
    l3 += contract("eiba,kjce->ijkabc", tW, l2)
    l3 += contract("eica,jkbe->ijkabc", tW, l2)
    l3 += contract("ekbc,ijae->ijkabc", tW, l2)
    l3 += contract("ejcb,ikae->ijkabc", tW, l2)

    l3 -= contract("eibc,jkea->ijkabc", Wvovv, l2)
    l3 -= contract("eicb,kjea->ijkabc", Wvovv, l2)
    l3 -= contract("ekba,jiec->ijkabc", Wvovv, l2)
    l3 -= contract("ejac,ikeb->ijkabc", Wvovv, l2)
    l3 -= contract("ejca,kieb->ijkabc", Wvovv, l2)
    l3 -= contract("ekab,ijec->ijkabc", Wvovv, l2)

    tW = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("jima,kmcb->ijkabc", tW, l2)
    l3 -= contract("kima,jmbc->ijkabc", tW, l2)
    l3 -= contract("ijmb,kmca->ijkabc", tW, l2)
    l3 -= contract("ikmc,jmba->ijkabc", tW, l2)
    l3 -= contract("kjmb,imac->ijkabc", tW, l2)
    l3 -= contract("jkmc,imab->ijkabc", tW, l2)

    l3 += contract("ijmc,kmba->ijkabc", Wooov, l2)
    l3 += contract("ikmb,jmca->ijkabc", Wooov, l2)
    l3 += contract("kjma,imbc->ijkabc", Wooov, l2)
    l3 += contract("jimc,kmab->ijkabc", Wooov, l2)
    l3 += contract("jkma,imcb->ijkabc", Wooov, l2)
    l3 += contract("kimb,jmac->ijkabc", Wooov, l2)

    return l3 / t3_denom(F, no)


# ---------------------------------------------------------------------------
# Lambda-CC3 extra residual terms over the full T3/L3
# ---------------------------------------------------------------------------

def cc3_lambda_extra(F, ERI, L, t1, t2, l1, l2, no, real_time=False,
                     F_ref=None):
    o, v = slices(no)
    Fov = build_Fme(F, L, t1, no)
    t3, (Woooo, Wovoo, Wooov, Wvovv, Wvvvo) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=F_ref)
    Wovov, Wovvo, Wvvvv = cc3_lambda_intermediates(ERI, t1, no)

    Lo = L[o, o, v, v]
    Eo = ERI[o, o, v, v]

    # t3 -> L1 couplings
    Zmndi = contract("lmndef,ilef->mndi", t3, Eo)
    Zmndi -= contract("lmnfed,ilef->mndi", t3, Lo)
    Zmdfa = contract("lmndef,nlea->mdfa", t3, Eo)
    Zmdfa -= contract("lmndfe,nlea->mdfa", t3, Lo)
    Znf = contract("lmde,lmndef->nf", l2, t3 - t3.swapaxes(3, 5))

    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)

    # l3 terms
    l3 = l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no)

    Zbide = contract("jkbc,kijcde->bide", t2, l3)
    Zblad1 = contract("jkbc,kijcad->biad", t2, l3)
    Zblad2 = contract("jkbc,kijcda->biad", t2, l3)
    Zjlma = contract("pkbc,kijcab->pija", t2, l3)
    Zjlid1 = contract("pkbc,kijcbd->pijd", t2, l3)
    Zjlid2 = contract("pkbc,kijcdb->pijd", t2, l3)

    Y1 += contract("bide,deab->ia", Zbide, Wvvvv)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Woooo)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)

    Y2 = contract("kijdeb,edak->ijab", l3, Wvvvo)
    Y2 -= contract("kijdab,ldjk->ilab", l3, Wovoo)

    return Y1, Y2 + Y2.permute(1, 0, 3, 2)


# ---------------------------------------------------------------------------
# CC3 one-electron densities over the full T3/L3
# ---------------------------------------------------------------------------

def _pdm_blocks(cc, t1, t2, l1, l2, Doo, Dvv, Dov):
    """(opdm, opdm_cc3): the CC one-pdm with the triples Dov, and the
    (nact, nact) matrix of the triples Doo/Dvv blocks."""
    from ..ccdensity import onepdm
    no, nact = cc.no, cc.nact
    o, v = slices(no)
    opdm = onepdm(cc.model, t1, t2, l1, l2, no, nact, Dov_x=Dov)
    opdm_cc3 = torch.zeros((nact, nact), dtype=t1.dtype, device=t1.device)
    opdm_cc3[o, o] = Doo
    opdm_cc3[v, v] = Dvv
    return opdm, opdm_cc3


def cc3_onepdm(cc, t1, t2, l1, l2, real_time=False):
    no = cc.no
    F, (ERI, L) = cc.H.F, eri_views(cc)
    if t1.is_complex():
        F = F.to(t1.dtype)

    Fov = build_Fme(F, L, t1, no)
    t3, (Woooo, Wovoo, Wooov, Wvovv, Wvvvo) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=cc.H.F)
    l3 = l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no)

    Zlmdi = contract("ijkdef,kpfe->ijdp", l3, t2)
    Dov = contract("ijkabc,jkbc->ia", t3 - t3.swapaxes(3, 4), l2)
    Dov -= contract("lmdp,lmda->pa", Zlmdi, t2)

    Doo = -0.5 * contract("lmiabc,lmjabc->ij", t3, l3)
    Dvv = 0.5 * contract("ijkbdc,ijkadc->ab", t3, l3)
    return _pdm_blocks(cc, t1, t2, l1, l2, Doo, Dvv, Dov)


# ---------------------------------------------------------------------------
# The slab forms of the residuals: one (i, j) T3 slab at a time
# ---------------------------------------------------------------------------

def _cc3_t3_slab(i, F, Wabei_o, Wmbij_t, t2, eps_o, eps_v, real_time,
                 F_ref, no):
    """The T1-dressed T3[i] row slab (j,k,a,b,c), o^2 v^3 elements, with
    the real-time perturbation term: every `_cc3_t3_slab_pair` of row i
    at once.  Takes the occupied-major layouts from `slab_layouts`."""
    t3 = _t3c_slab(i, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        tmp = contract("ld,jad->jal", _Vov(F, F_ref, no, True), t2[i])
        t3p = contract("jal,klcb->jkabc", tmp, t2)
        denom = (eps_o[i] + eps_o[:, None, None, None, None]
                 + eps_o[None, :, None, None, None]
                 - eps_v[None, None, :, None, None]
                 - eps_v[None, None, None, :, None]
                 - eps_v[None, None, None, None, :])
        t3 = t3 - t3p / denom
    return t3


def _cc3_t3_slab_pair(i, j, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                      real_time):
    """The T1-dressed T3[i, j] slab (k,a,b,c), with the real-time
    perturbation term."""
    t3 = _t3c_slab_ij(i, j, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        tmp = contract("ld,ad->al", Vov, t2[i, j])
        t3p = contract("al,klcb->kabc", tmp, t2)
        denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
                 - eps_v[None, :, None, None]
                 - eps_v[None, None, :, None]
                 - eps_v[None, None, None, :])
        t3 = t3 - t3p / denom
    return t3


def _t3c_pair_chunk(i, j, k0, kc, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                    real_time):
    """The k-window [k0, k0+kc) of `_cc3_t3_slab_pair`: (K,a,b,c)."""
    t3 = _t3c_chunk_ij(i, j, k0, kc, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        tmp = contract("ld,ad->al", Vov, t2[i, j])
        t3p = contract("al,klcb->kabc", tmp, _dslice(t2, k0, kc))
        eo = _dslice(eps_o, k0, kc)
        denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
                 - eps_v[None, :, None, None]
                 - eps_v[None, None, :, None]
                 - eps_v[None, None, None, :])
        t3 = t3 - t3p / denom
    return t3


def cc3_scan_prep(F, ERI, L, vvvv, t1, t2, no, real_time=False, F_ref=None,
                  ladder=vvvv_nt):
    """The CCSD residual part (ladder through `ladder`) and the T1-dressed
    intermediates of the slab-form CC3 residual, none larger than o v^3:
    (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, Vov)."""
    o, v = slices(no)
    F_ref = F if F_ref is None else F_ref
    r1, r2 = residuals_ccsd(F, ERI, L, vvvv, t1, t2, no, ladder=ladder)
    Fme = build_Fme(F, L, t1, no)
    _, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    return (r1, r2, Fme, Wamef.contiguous(), Wmnie.contiguous(), Wabei_o,
            Wmbij_t, F.diagonal(), L[o, o, v, v].contiguous(),
            _Vov(F, F_ref, no, real_time))


def _cc3_row_xs(i, carry, Wabei_o, Wmbij_t, t2, eps, Lo, Fme, Wamef, Wmnie,
                Vov, no, real_time):
    """The T3 contributions to X1/X2 from occupied row i (a loop over j),
    added in place to carry = (X1, X2), which is returned."""
    X1, X2 = carry
    eps_o, eps_v = eps[:no], eps[no:]
    for j in range(no):
        t3 = _cc3_t3_slab_pair(i, j, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                               real_time)
        td = t3 - t3.swapaxes(1, 3)
        T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
        del t3
        X1[i] += contract("kabc,kbc->a", td, Lo[j])
        X2[i, j] += (contract("kabc,kc->ab", td, Fme)
                     + contract("kabc,dkbc->ad", T, Wamef))
        X2[i] -= contract("kabc,klc->lab", T, Wmnie[j])
    return X1, X2


def _cc3_row_xs_chunked(i, carry, Wabei_o, Wmbij_t, t2, eps, Lo, Fme,
                        Wamef, Wmnie, Vov, no, real_time, kc):
    """`_cc3_row_xs` with each pair slab built and consumed in k-windows
    of kc: peak slab memory kc v^3 instead of no v^3."""
    X1, X2 = carry
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    z = dict(dtype=X2.dtype, device=X2.device)
    for j in range(no):
        x1 = torch.zeros((nv,), **z)
        x2ij = torch.zeros((nv, nv), **z)
        x2l = torch.zeros((no, nv, nv), **z)
        for k0 in range(0, no, kc):
            t3 = _t3c_pair_chunk(i, j, k0, kc, Vov, Wabei_o, Wmbij_t, t2,
                                 eps_o, eps_v, real_time)
            td = t3 - t3.swapaxes(1, 3)
            T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
            del t3
            x1 += contract("kabc,kbc->a", td, _dslice(Lo[j], k0, kc))
            x2ij += contract("kabc,kc->ab", td, _dslice(Fme, k0, kc))
            x2ij += contract("kabc,dkbc->ad", T, Wamef[:, k0:k0 + kc])
            x2l += contract("kabc,klc->lab", T, _dslice(Wmnie[j], k0, kc))
        X1[i] += x1
        X2[i, j] += x2ij
        X2[i] -= x2l
    return X1, X2


def _cc3_xs_rows(r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, Vov,
                 t2, no, real_time):
    """The T3 slab loop of the slab-form residuals: every occupied row
    through `_cc3_row_xs` (or its k-chunked form past no v^3 = 2^27),
    added to the CCSD part (r1, r2)."""
    nv = t2.shape[-1]
    X1, X2 = torch.zeros_like(r1), torch.zeros_like(r2)
    args = (Wabei_o, Wmbij_t, t2, eps, Lo, Fme, Wamef, Wmnie, Vov, no,
            real_time)
    if _chunked(no, nv):
        kc = _t_df_kc(no, nv)
        for i in range(no):
            _cc3_row_xs_chunked(i, (X1, X2), *args, kc)
    else:
        for i in range(no):
            _cc3_row_xs(i, (X1, X2), *args)
    return r1 + X1, r2 + X2 + X2.permute(1, 0, 3, 2)


def residuals_cc3_scan(F, ERI, L, vvvv, t1, t2, no, real_time=False,
                       F_ref=None, ladder=vvvv_nt):
    """`residuals_cc3` with O(o v^3) triples memory: the T3 contributions
    accumulated one (i, j) slab at a time."""
    (r1, r2, *rest) = cc3_scan_prep(F, ERI, L, vvvv, t1, t2, no,
                                    real_time=real_time, F_ref=F_ref,
                                    ladder=ladder)
    return _cc3_xs_rows(r1, r2, *rest, t2, no, real_time)


# ---------------------------------------------------------------------------
# The energy over Cholesky/DF factors
# ---------------------------------------------------------------------------

def cc3_scan_prep_df(F, dfb, t1, t2, no, real_time=False, F_ref=None,
                     nblocks=None, ladder=vvvv_nt):
    """`cc3_scan_prep` from factors: the CCSD part by the DF residuals
    (their ladder through K1, a block at a time) and the dressed W's from
    `cc3_intermediates_df`, already in slab layout."""
    from .dfccsd import _eri_oovv, residuals_ccsd_df

    o, v = slices(no)
    F_ref = F if F_ref is None else F_ref
    r1, r2 = residuals_ccsd_df(F, dfb, t1, t2, no, nblocks=nblocks,
                               ladder=ladder)
    e = _eri_oovv(dfb)
    Lo = 2.0 * e - e.swapaxes(2, 3)
    Fme = F[o, v] + contract("nf,mnef->me", t1, Lo)
    _, Wmbij_t, Wmnie, Wamef, Wabei_o = cc3_intermediates_df(
        dfb, t1, no, scan_layout=True)
    return (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, F.diagonal(), Lo,
            _Vov(F, F_ref, no, real_time))


def residuals_cc3_scan_df(F, dfb, t1, t2, no, real_time=False, F_ref=None,
                          nblocks=None, ladder=vvvv_nt):
    """CC3 T1/T2 residuals over Cholesky/DF factors with O(o v^3) triples
    memory: the storage='df' counterpart of `residuals_cc3_scan`, equal
    to it given exact factors."""
    (r1, r2, *rest) = cc3_scan_prep_df(F, dfb, t1, t2, no,
                                       real_time=real_time, F_ref=F_ref,
                                       nblocks=nblocks, ladder=ladder)
    return _cc3_xs_rows(r1, r2, *rest, t2, no, real_time)


# ---------------------------------------------------------------------------
# L3 slabs: one leading row, one (i, j) pair, or a pair's k-window
# ---------------------------------------------------------------------------

def l3_slab(i, L4, l1, l2, Fov, Wvovv, Wooov, eps_o, eps_v):
    """The l3[i] row slab (j,k,a,b,c), o^2 v^3 elements: `l3_full` with
    its first occupied index fixed (L4 is L[o,o,v,v]); every
    `_l3_slab_ij` of row i at once."""
    Lo = L4
    Loi = Lo[i]
    LoTi = Lo[:, i]
    l2i = l2[i]
    l2Ti = l2[:, i]
    l3 = contract("jab,kc->jkabc", Loi, l1) - contract("jac,kb->jkabc", Loi, l1)
    l3 += contract("kac,jb->jkabc", Loi, l1) - contract("kab,jc->jkabc", Loi, l1)
    l3 += contract("jba,kc->jkabc", LoTi, l1) - contract("jbc,ka->jkabc", LoTi, l1)
    l3 += contract("kca,jb->jkabc", LoTi, l1) - contract("kcb,ja->jkabc", LoTi, l1)
    l3 += contract("jkbc,a->jkabc", Lo, l1[i]) - contract("jkba,c->jkabc", Lo, l1[i])
    l3 += contract("kjcb,a->jkabc", Lo, l1[i]) - contract("kjca,b->jkabc", Lo, l1[i])

    l3 += contract("a,jkbc->jkabc", Fov[i], l2) - contract("b,jkac->jkabc", Fov[i], l2)
    l3 += contract("a,kjcb->jkabc", Fov[i], l2) - contract("c,kjab->jkabc", Fov[i], l2)
    l3 += contract("jb,kac->jkabc", Fov, l2i) - contract("ja,kbc->jkabc", Fov, l2i)
    l3 += contract("kc,jab->jkabc", Fov, l2i) - contract("ka,jcb->jkabc", Fov, l2i)
    l3 += contract("jb,kca->jkabc", Fov, l2Ti) - contract("jc,kba->jkabc", Fov, l2Ti)
    l3 += contract("kc,jba->jkabc", Fov, l2Ti) - contract("kb,jca->jkabc", Fov, l2Ti)

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    l3 += contract("ejab,kce->jkabc", tW, l2Ti)
    l3 += contract("ekac,jbe->jkabc", tW, l2Ti)
    l3 += contract("eba,kjce->jkabc", tW[:, i], l2)
    l3 += contract("eca,jkbe->jkabc", tW[:, i], l2)
    l3 += contract("ekbc,jae->jkabc", tW, l2i)
    l3 += contract("ejcb,kae->jkabc", tW, l2i)
    del tW

    l3 -= contract("ebc,jkea->jkabc", Wvovv[:, i], l2)
    l3 -= contract("ecb,kjea->jkabc", Wvovv[:, i], l2)
    l3 -= contract("ekba,jec->jkabc", Wvovv, l2Ti)
    l3 -= contract("ejac,keb->jkabc", Wvovv, l2i)
    l3 -= contract("ejca,keb->jkabc", Wvovv, l2Ti)
    l3 -= contract("ekab,jec->jkabc", Wvovv, l2i)

    tW2 = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("jma,kmcb->jkabc", tW2[:, i], l2)
    l3 -= contract("kma,jmbc->jkabc", tW2[:, i], l2)
    l3 -= contract("jmb,kmca->jkabc", tW2[i], l2)
    l3 -= contract("kmc,jmba->jkabc", tW2[i], l2)
    l3 -= contract("kjmb,mac->jkabc", tW2, l2i)
    l3 -= contract("jkmc,mab->jkabc", tW2, l2i)

    l3 += contract("jmc,kmba->jkabc", Wooov[i], l2)
    l3 += contract("kmb,jmca->jkabc", Wooov[i], l2)
    l3 += contract("kjma,mbc->jkabc", Wooov, l2i)
    l3 += contract("jmc,kmab->jkabc", Wooov[:, i], l2)
    l3 += contract("jkma,mcb->jkabc", Wooov, l2i)
    l3 += contract("kmb,jmac->jkabc", Wooov[:, i], l2)

    denom = (eps_o[i] + eps_o[:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    return l3 / denom


def _l3_slab_ij(i, j, L4, l1, l2, Fov, Wvovv, Wooov, eps_o, eps_v):
    """The l3[i, j] slab (k,a,b,c): `l3_full` with its first two occupied
    indices fixed (L4 is L[o,o,v,v]); the whole k-range of
    `_l3_slab_ij_chunk`."""
    return _l3_slab_ij_chunk(i, j, 0, eps_o.shape[0], L4, l1, l2, Fov,
                             Wvovv, Wooov, eps_o, eps_v)


def _l3_slab_ij_chunk(i, j, k0, kc, L4, l1, l2, Fov, Wvovv, Wooov,
                      eps_o, eps_v):
    """`_l3_slab_ij` restricted to the k-window [k0, k0+kc): every operand
    that carries k is windowed, every term otherwise verbatim.  Peak slab
    memory kc v^3 instead of no v^3."""
    Lo = L4
    Loi = Lo[i]
    LoTi = Lo[:, i]
    l2i = l2[i]
    l2Ti = l2[:, i]

    def sl(x):
        return _dslice(x, k0, kc)
    l1k, Fovk = sl(l1), sl(Fov)
    Loik, LoTik = sl(Loi), sl(LoTi)
    Lojk, LoTjk = sl(Lo[j]), sl(Lo[:, j])
    l2k = sl(l2)
    l2ik, l2Tik = sl(l2i), sl(l2Ti)
    l2jk, l2Tjk = sl(l2[j]), sl(l2[:, j])

    l3 = contract("ab,kc->kabc", Loi[j], l1k) - contract("ac,kb->kabc", Loi[j], l1k)
    l3 += contract("kac,b->kabc", Loik, l1[j]) - contract("kab,c->kabc", Loik, l1[j])
    l3 += contract("ba,kc->kabc", LoTi[j], l1k) - contract("bc,ka->kabc", LoTi[j], l1k)
    l3 += contract("kca,b->kabc", LoTik, l1[j]) - contract("kcb,a->kabc", LoTik, l1[j])
    l3 += contract("kbc,a->kabc", Lojk, l1[i]) - contract("kba,c->kabc", Lojk, l1[i])
    l3 += contract("kcb,a->kabc", LoTjk, l1[i]) - contract("kca,b->kabc", LoTjk, l1[i])

    l3 += contract("a,kbc->kabc", Fov[i], l2jk) - contract("b,kac->kabc", Fov[i], l2jk)
    l3 += contract("a,kcb->kabc", Fov[i], l2Tjk) - contract("c,kab->kabc", Fov[i], l2Tjk)
    l3 += contract("b,kac->kabc", Fov[j], l2ik) - contract("a,kbc->kabc", Fov[j], l2ik)
    l3 += contract("kc,ab->kabc", Fovk, l2i[j]) - contract("ka,cb->kabc", Fovk, l2i[j])
    l3 += contract("b,kca->kabc", Fov[j], l2Tik) - contract("c,kba->kabc", Fov[j], l2Tik)
    l3 += contract("kc,ba->kabc", Fovk, l2Ti[j]) - contract("kb,ca->kabc", Fovk, l2Ti[j])

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    tWk = tW[:, k0:k0 + kc]
    Wvk = Wvovv[:, k0:k0 + kc]
    l3 += contract("eab,kce->kabc", tW[:, j], l2Tik)
    l3 += contract("ekac,be->kabc", tWk, l2Ti[j])
    l3 += contract("eba,kce->kabc", tW[:, i], l2Tjk)
    l3 += contract("eca,kbe->kabc", tW[:, i], l2jk)
    l3 += contract("ekbc,ae->kabc", tWk, l2i[j])
    l3 += contract("ecb,kae->kabc", tW[:, j], l2ik)
    del tW, tWk

    l3 -= contract("ebc,kea->kabc", Wvovv[:, i], l2jk)
    l3 -= contract("ecb,kea->kabc", Wvovv[:, i], l2Tjk)
    l3 -= contract("ekba,ec->kabc", Wvk, l2Ti[j])
    l3 -= contract("eac,keb->kabc", Wvovv[:, j], l2ik)
    l3 -= contract("eca,keb->kabc", Wvovv[:, j], l2Tik)
    l3 -= contract("ekab,ec->kabc", Wvk, l2i[j])

    tW2 = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("ma,kmcb->kabc", tW2[j, i], l2k)
    l3 -= contract("kma,mbc->kabc", sl(tW2[:, i]), l2[j])
    l3 -= contract("mb,kmca->kabc", tW2[i, j], l2k)
    l3 -= contract("kmc,mba->kabc", sl(tW2[i]), l2[j])
    l3 -= contract("kmb,mac->kabc", sl(tW2[:, j]), l2i)
    l3 -= contract("kmc,mab->kabc", sl(tW2[j]), l2i)

    l3 += contract("mc,kmba->kabc", Wooov[i, j], l2k)
    l3 += contract("kmb,mca->kabc", sl(Wooov[i]), l2[j])
    l3 += contract("kma,mbc->kabc", sl(Wooov[:, j]), l2i)
    l3 += contract("mc,kmab->kabc", Wooov[j, i], l2k)
    l3 += contract("kma,mcb->kabc", sl(Wooov[j]), l2i)
    l3 += contract("kmb,mac->kabc", sl(Wooov[:, i]), l2[j])

    eo = sl(eps_o)
    denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return l3 / denom


# ---------------------------------------------------------------------------
# The slab form of the Lambda-CC3 extras
# ---------------------------------------------------------------------------

def cc3_lambda_prep(F, ERI, L, t1, t2, no, real_time=False, F_ref=None):
    """The intermediates of the slab-form Lambda-CC3 extras: (Fov, Wmnij,
    Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv, eps, Lo, Eo,
    Vov)."""
    o, v = slices(no)
    F_ref = F if F_ref is None else F_ref
    Fov = build_Fme(F, L, t1, no)
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    del Wabei, Wmbij
    Wovov, Wovvo, Wvvvv = cc3_lambda_intermediates(ERI, t1, no)
    return (Fov, Wmnij, Wmnie.contiguous(), Wamef.contiguous(), Wabei_o,
            Wmbij_t, Wovov, Wovvo, Wvvvv, F.diagonal(),
            L[o, o, v, v].contiguous(), ERI[o, o, v, v].contiguous(),
            _Vov(F, F_ref, no, real_time))


def cc3_lambda_prep_df(F, dfb, t1, t2, no, real_time=False, F_ref=None):
    """`cc3_lambda_prep` from factors: the W's of `cc3_intermediates_df`
    (slab layout) and `cc3_lambda_intermediates_df`, with Bd_ae in the
    Wvvvv slot (the implicit dressed-bilinear form) instead of the v^4
    tensor, and L and <oo|vv> assembled from the factors."""
    from .dfccsd import _eri_oovv

    o, v = slices(no)
    F_ref = F if F_ref is None else F_ref
    e = _eri_oovv(dfb)
    Lo = 2.0 * e - e.swapaxes(2, 3)
    Fov = F[o, v] + contract("nf,mnef->me", t1, Lo)
    Wmnij, Wmbij_t, Wmnie, Wamef, Wabei_o = cc3_intermediates_df(
        dfb, t1, no, scan_layout=True)
    Wovov, Wovvo, Bd_ae = cc3_lambda_intermediates_df(dfb, t1, no)
    return (Fov, Wmnij, Wmnie.contiguous(), Wamef.contiguous(), Wabei_o,
            Wmbij_t, Wovov, Wovvo, Bd_ae, F.diagonal(), Lo.contiguous(),
            e.contiguous(), _Vov(F, F_ref, no, real_time))


def _wvvvv_y1(Zbide, Wvvvv):
    """'bide,deab->ia' of the Lambda-CC3 Y1: against the v^4 Wvvvv of
    `cc3_lambda_prep`, or, when the slot holds the dressed factor Bd_ae
    (naux, v, v) of `cc3_lambda_prep_df`, against the implicit
    Wvvvv[deab] = sum_P Bd[P,d,a] Bd[P,e,b]."""
    if Wvvvv.dim() == 3:
        K = contract("bide,Peb->Pid", Zbide, Wvvvv)
        return contract("Pid,Pda->ia", K, Wvvvv)
    return contract("bide,deab->ia", Zbide, Wvvvv)


def _cc3_lambda_row_t3(l, carry, Wabei_o, Wmbij_t, t2, l2, eps, Lo, Eo,
                       Vov, no, real_time):
    """The t3-side Z accumulations for leading index l (a loop over m),
    in place on carry = (Zmndi, Zmdfa, Znf)."""
    Zmndi, Zmdfa, Znf = carry
    eps_o, eps_v = eps[:no], eps[no:]
    for m in range(no):
        s = _cc3_t3_slab_pair(l, m, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                              real_time)   # [n,d,e,f]
        Zmndi[m] += (contract("ndef,pef->ndp", s, Eo[:, l])
                     - contract("nfed,pef->ndp", s, Lo[:, l]))
        Zmdfa[m] += (contract("ndef,nea->dfa", s, Eo[:, l])
                     - contract("ndfe,nea->dfa", s, Lo[:, l]))
        Znf += contract("de,ndef->nf", l2[l, m], s - s.swapaxes(1, 3))
    return carry


def _cc3_lambda_row_t3_chunked(l, carry, Wabei_o, Wmbij_t, t2, l2, eps,
                               Lo, Eo, Vov, no, real_time, kc):
    """`_cc3_lambda_row_t3` with the slab's free occupied index n in
    k-windows of kc: peak slab memory kc v^3 instead of no v^3."""
    Zmndi, Zmdfa, Znf = carry
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    z = dict(dtype=Zmdfa.dtype, device=Zmdfa.device)
    for m in range(no):
        zndp = torch.zeros((no, nv, no), **z)
        zdfa = torch.zeros((nv, nv, nv), **z)
        znf = torch.zeros((no, nv), **z)
        for k0 in range(0, no, kc):
            s = _t3c_pair_chunk(l, m, k0, kc, Vov, Wabei_o, Wmbij_t, t2,
                                eps_o, eps_v, real_time)
            zndp[k0:k0 + kc] += (contract("ndef,pef->ndp", s, Eo[:, l])
                                 - contract("nfed,pef->ndp", s, Lo[:, l]))
            zdfa += (contract("ndef,nea->dfa", s, _dslice(Eo[:, l], k0, kc))
                     - contract("ndfe,nea->dfa", s, _dslice(Lo[:, l], k0, kc)))
            znf[k0:k0 + kc] += contract("de,ndef->nf", l2[l, m],
                                        s - s.swapaxes(1, 3))
        Zmndi[m] += zndp
        Zmdfa[m] += zdfa
        Znf += znf
    return carry


def _cc3_lambda_row_l3(k, carry, t2, l1, l2, Fov, Wamef, Wmnie, Wabei_o,
                       Wmbij_t, eps, Lo, no):
    """The l3-side Z and Y2 accumulations for leading index k (a loop over
    i), in place on carry = (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2,
    Y2)."""
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry
    eps_o, eps_v = eps[:no], eps[no:]
    tk = t2[:, k]
    for i in range(no):
        s = _l3_slab_ij(k, i, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o, eps_v)
        # s[j, c, d, e] == l3_full[k, i, j, c, d, e]
        Zbide[:, i] += contract("jbc,jcde->bde", tk, s)
        Zblad1[:, i] += contract("jbc,jcad->bad", tk, s)
        Zblad2[:, i] += contract("jbc,jcda->bad", tk, s)
        Zjlma[:, i] += contract("pbc,jcab->pja", tk, s)
        Zjlid1[:, i] += contract("pbc,jcbd->pjd", tk, s)
        Zjlid2[:, i] += contract("pbc,jcdb->pjd", tk, s)
        Y2[i] += (contract("jdeb,eda->jab", s, Wabei_o[k])
                  - contract("jdab,jld->lab", s, Wmbij_t[:, k]))
    return carry


def _cc3_lambda_row_l3_chunked(k, carry, t2, l1, l2, Fov, Wamef, Wmnie,
                               Wabei_o, Wmbij_t, eps, Lo, no, kc):
    """`_cc3_lambda_row_l3` with the slab's free occupied index in
    k-windows of kc (`_l3_slab_ij_chunk`): the same accumulations with
    peak slab memory kc v^3."""
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    z = dict(dtype=Y2.dtype, device=Y2.device)
    tk = t2[:, k]
    for i in range(no):
        zbde = torch.zeros((nv, nv, nv), **z)
        zbad1 = torch.zeros((nv, nv, nv), **z)
        zbad2 = torch.zeros((nv, nv, nv), **z)
        zpja = torch.zeros((no, no, nv), **z)
        zpjd1 = torch.zeros((no, no, nv), **z)
        zpjd2 = torch.zeros((no, no, nv), **z)
        yjab = torch.zeros((no, nv, nv), **z)
        ylab = torch.zeros((no, nv, nv), **z)
        for k0 in range(0, no, kc):
            K = slice(k0, k0 + kc)
            s = _l3_slab_ij_chunk(k, i, k0, kc, Lo, l1, l2, Fov, Wamef,
                                  Wmnie, eps_o, eps_v)
            tkw = _dslice(tk, k0, kc)
            zbde += contract("jbc,jcde->bde", tkw, s)
            zbad1 += contract("jbc,jcad->bad", tkw, s)
            zbad2 += contract("jbc,jcda->bad", tkw, s)
            zpja[:, K] += contract("pbc,jcab->pja", tk, s)
            zpjd1[:, K] += contract("pbc,jcbd->pjd", tk, s)
            zpjd2[:, K] += contract("pbc,jcdb->pjd", tk, s)
            yjab[K] += contract("jdeb,eda->jab", s, Wabei_o[k])
            ylab += contract("jdab,jld->lab", s, _dslice(Wmbij_t[:, k], k0,
                                                         kc))
        Zbide[:, i] += zbde
        Zblad1[:, i] += zbad1
        Zblad2[:, i] += zbad2
        Zjlma[:, i] += zpja
        Zjlid1[:, i] += zpjd1
        Zjlid2[:, i] += zpjd2
        Y2[i] += yjab - ylab
    return carry


def _cc3_lambda_t3_rows(prep, t2, l2, no, real_time):
    """The t3 side of the slab-form extras: every leading row through
    `_cc3_lambda_row_t3` (k-chunked past no v^3 = 2^27), then its Y1."""
    (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv,
     eps, Lo, Eo, Vov) = prep
    nv = t2.shape[2]
    z = dict(dtype=t2.dtype, device=t2.device)
    carry = (torch.zeros((no, no, nv, no), **z),
             torch.zeros((no, nv, nv, nv), **z), torch.zeros((no, nv), **z))
    args = (Wabei_o, Wmbij_t, t2, l2, eps, Lo, Eo, Vov, no, real_time)
    if _chunked(no, nv):
        kc = _t_df_kc(no, nv)
        for l in range(no):
            _cc3_lambda_row_t3_chunked(l, carry, *args, kc)
    else:
        for l in range(no):
            _cc3_lambda_row_t3(l, carry, *args)
    Zmndi, Zmdfa, Znf = carry
    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)
    return Y1


def _cc3_lambda_l3_rows(prep, t2, l1, l2, no):
    """The l3 side of the slab-form extras: every leading row through
    `_cc3_lambda_row_l3` (k-chunked past no v^3 = 2^27), then its Y1
    and the Y2 before its pair symmetrisation; prep is
    `cc3_lambda_prep`'s or `cc3_lambda_prep_df`'s."""
    (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv,
     eps, Lo, Eo, Vov) = prep
    nv = t2.shape[2]
    z = dict(dtype=t2.dtype, device=t2.device)
    carry = (torch.zeros((nv, no, nv, nv), **z),
             torch.zeros((nv, no, nv, nv), **z),
             torch.zeros((nv, no, nv, nv), **z),
             torch.zeros((no, no, no, nv), **z),
             torch.zeros((no, no, no, nv), **z),
             torch.zeros((no, no, no, nv), **z),
             torch.zeros((no, no, nv, nv), **z))
    args = (t2, l1, l2, Fov, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, no)
    if _chunked(no, nv):
        kc = _t_df_kc(no, nv)
        for k in range(no):
            _cc3_lambda_row_l3_chunked(k, carry, *args, kc)
    else:
        for k in range(no):
            _cc3_lambda_row_l3(k, carry, *args)
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry
    Y1 = _wvvvv_y1(Zbide, Wvvvv)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Wmnij)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)
    return Y1, Y2


def cc3_lambda_extra_scan(F, ERI, L, t1, t2, l1, l2, no, real_time=False,
                          F_ref=None):
    """`cc3_lambda_extra` with O(o v^3) triples memory: the t3 and the l3
    sides one (i, j) slab at a time."""
    prep = cc3_lambda_prep(F, ERI, L, t1, t2, no, real_time=real_time,
                           F_ref=F_ref)
    Y1 = _cc3_lambda_t3_rows(prep, t2, l2, no, real_time)
    Y1l, Y2 = _cc3_lambda_l3_rows(prep, t2, l1, l2, no)
    return Y1 + Y1l, Y2 + Y2.permute(1, 0, 3, 2)


def cc3_lambda_extra_scan_df(F, dfb, t1, t2, l1, l2, no, real_time=False,
                             F_ref=None):
    """`cc3_lambda_extra_scan` over Cholesky/DF factors: the prep from the
    factors (`cc3_lambda_prep_df`), the same t3 and l3 slab rows, and the
    one v^4 consumer (the Y1 Wvvvv term) against the dressed bilinear
    factors; equal to the dense extras given exact factors."""
    prep = cc3_lambda_prep_df(F, dfb, t1, t2, no, real_time=real_time,
                              F_ref=F_ref)
    Y1 = _cc3_lambda_t3_rows(prep, t2, l2, no, real_time)
    Y1l, Y2 = _cc3_lambda_l3_rows(prep, t2, l1, l2, no)
    return Y1 + Y1l, Y2 + Y2.permute(1, 0, 3, 2)


# ---------------------------------------------------------------------------
# The slab form of the CC3 one-pdm
# ---------------------------------------------------------------------------

# slab elements above which the pdm row assembles each pair's t3/l3 from
# k-chunked builds (tests lower it to force the assembly at a tiny size)
_PDM_CHUNK_ELEMS = 3e7


def _cc3_onepdm_row(i, carry, Wabei_o, Wmbij_t, t2, l1, l2, Fov, Wamef,
                    Wmnie, eps, Lo, Vov, no, kc, real_time):
    """One leading-index row of the triples one-pdm corrections, in place
    on carry = (Dov, Zlmdi, Doo, Dvv).  Each pair's t3 and l3 slabs are
    built whole when kc == no, else assembled from kc-windows into one
    (no, v, v, v) buffer each, which bounds the builds' temporaries to
    kc v^3 while the four consumers read the whole slabs."""
    Dov, Zlmdi, Doo, Dvv = carry
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    for j in range(no):
        if kc == no:
            t3 = _cc3_t3_slab_pair(i, j, Vov, Wabei_o, Wmbij_t, t2, eps_o,
                                   eps_v, real_time)
            l3 = _l3_slab_ij(i, j, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o,
                             eps_v)
        else:
            t3 = torch.empty((no, nv, nv, nv), dtype=t2.dtype,
                             device=t2.device)
            l3 = torch.empty_like(t3)
            for k0 in range(0, no, kc):
                t3[k0:k0 + kc] = _t3c_pair_chunk(
                    i, j, k0, kc, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                    real_time)
                l3[k0:k0 + kc] = _l3_slab_ij_chunk(
                    i, j, k0, kc, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o,
                    eps_v)
        Zlmdi[i, j] += contract("kdef,kpfe->dp", l3, t2)
        Dov[i] += contract("kabc,kbc->a", t3 - t3.swapaxes(1, 2), l2[j])
        # this pair is (lead, m); the free occupied axes of t3/l3 are p/q
        Doo -= 0.5 * contract("pabc,qabc->pq", t3, l3)
        Dvv += 0.5 * contract("kbdc,kadc->ab", t3, l3)
    return carry


def cc3_onepdm_scan(cc, t1, t2, l1, l2, real_time=False):
    """`cc3_onepdm` with O(o v^3) triples memory: one (i, j) t3 and l3
    slab pair at a time (`_cc3_onepdm_row`); under storage='df' the W's
    come from the factors (`cc3_lambda_prep_df`)."""
    no, nv = cc.no, cc.nv
    o, v = slices(no)
    F = cc.H.F
    if t1.is_complex():
        F = F.to(t1.dtype)
    if getattr(cc, "storage", "full") == "df":
        (Fov, _, Wmnie, Wamef, Wabei_o, Wmbij_t, _, _, _, eps, Lo, _,
         Vov) = cc3_lambda_prep_df(F, cc.dfb, t1, t2, no,
                                   real_time=real_time, F_ref=cc.H.F)
    else:
        ERI, L = eri_views(cc)
        Fov = build_Fme(F, L, t1, no)
        _, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
        Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
        Wamef, Wmnie = Wamef.contiguous(), Wmnie.contiguous()
        del Wabei, Wmbij
        eps = F.diagonal()
        Lo = L[o, o, v, v].contiguous()
        Vov = _Vov(F, cc.H.F, no, real_time)
    kc = _t_df_kc(no, nv, _PDM_CHUNK_ELEMS)
    z = dict(dtype=t1.dtype, device=t1.device)
    carry = (torch.zeros((no, nv), **z), torch.zeros((no, no, nv, no), **z),
             torch.zeros((no, no), **z), torch.zeros((nv, nv), **z))
    for i in range(no):
        _cc3_onepdm_row(i, carry, Wabei_o, Wmbij_t, t2, l1, l2, Fov, Wamef,
                        Wmnie, eps, Lo, Vov, no, kc, real_time)
    Dov, Zlmdi, Doo, Dvv = carry
    Dov = Dov - contract("lmdp,lmda->pa", Zlmdi, t2)
    return _pdm_blocks(cc, t1, t2, l1, l2, Doo, Dvv, Dov)
