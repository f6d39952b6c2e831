"""Density-fitted (Cholesky-factorized) CCSD amplitude equations.

Plain functions over torch tensors: the counterpart of the fused path of
pycc_tpu/models/dfccsd.py, term for term.  The same spin-adapted
closed-shell equations as models/ccsd.py, re-derived so that no
four-index quantity larger than o^2 v^2 exists except one block of the
ladder: the Hamiltonian enters as three-index Cholesky factors

    ERI[p,q,r,s] = <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s]

split into occ/vir blocks Boo/Bov/Bvv (ops/cholesky.py builds B).

* every <= o^2 v^2 integral class (oovv, ovvo, ovov, oooo, ooov, ovoo) is
  assembled once per residual evaluation from B;
* every ovvv-class term is reordered so the v^3 tensor never forms (t1/t2
  first contract with one B factor, then with the other);
* the particle-particle ladder folds its t1 contamination (the dense
  equations' Zmbij term) into a LEFT-DRESSED factor
  BL[P,a,e] = 0.5 B[P,a,e] - sum_m t1[m,a] B[P,m,e], so the ladder is one
  dressed contraction

      r2 += sum_ef tau[i,j,e,f] * sum_P BL[P,a,e] B[P,b,f]

  evaluated in a-blocks: per block a (blk*v, naux) x (naux, v^2) assembly
  product (torch.matmul) makes W, and the (o^2, v^2) x (blk*v, v^2)^T
  application product runs through the K1 kernel (`vvvv_nt`), both in
  `dfhbar.ladder_apply`.

pycc_tpu's other residual forms (the seven-program split, the f64 scan
residual, the grid ladder) fit the TPU's 15.75 GB of HBM and its emulated
f64 dots; they are not ported (ROADMAP.md "Not ported").
"""

from typing import NamedTuple

import torch

from ..ops.contract import contract, seed
from ..ops.kernels.vvvv import vvvv_nt
from ..parallel.mesh import dense, per_piece


class DFERI(NamedTuple):
    """Cholesky/DF factors of the active-space ERI, blocked by MO space.

    Boo (naux,o,o), Bov (naux,o,v), Bvv (naux,v,v); B[P] is symmetric, so
    the vo block is Bov transposed.
    """
    Boo: torch.Tensor
    Bov: torch.Tensor
    Bvv: torch.Tensor


def whole_bvv(df):
    """df with Bvv whole where it lives, for the terms that contract it
    outside a ladder: on a mesh (Bvv Sharded, parallel/mesh.py) assembled
    on the home device, once a call of whoever asks."""
    return df._replace(Bvv=dense(df.Bvv))


def df_blocks(B, no):
    """Split full B (naux, nact, nact) into a DFERI of contiguous blocks."""
    return DFERI(Boo=B[:, :no, :no].contiguous(),
                 Bov=B[:, :no, no:].contiguous(),
                 Bvv=B[:, no:, no:].contiguous())


# ---------------------------------------------------------------------------
# <= o^2 v^2 integral classes, assembled on the fly
# ---------------------------------------------------------------------------

def _eri_oovv(df):   # <mn|ef> = (me|nf)
    return contract("Pme,Pnf->mnef", df.Bov, df.Bov)


def _eri_ovvo(df):   # <mb|ej> = (me|bj)
    return contract("Pme,Pjb->mbej", df.Bov, df.Bov)


def _eri_ovov(df):   # <mb|je> = (mj|be)
    return contract("Pmj,Pbe->mbje", df.Boo, df.Bvv)


def _eri_oooo(df):   # <mn|ij> = (mi|nj)
    return contract("Pmi,Pnj->mnij", df.Boo, df.Boo)


def _eri_ooov(df):   # <mn|ie> = (mi|ne)
    return contract("Pmi,Pne->mnie", df.Boo, df.Bov)


def _eri_ovoo(df):   # <mb|ij> = (mi|bj)
    return contract("Pmi,Pjb->mbij", df.Boo, df.Bov)


# ---------------------------------------------------------------------------
# one-particle intermediates
# ---------------------------------------------------------------------------

def _tau(t1, t2, f1=1.0, f2=1.0):
    return f1 * t2 + f2 * (t1[:, None, :, None] * t1[None, :, None, :])


def build_Fae_df(F, df, Loovv, t1, t2, no):
    # contract('mf,mafe->ae', t1, L[o,v,v,v]) with L[mafe] = 2(mf|ae)-(me|af)
    dP = contract("Pmf,mf->P", df.Bov, t1)
    Cam = contract("Paf,mf->Pam", df.Bvv, t1)
    ovvv_term = (2.0 * contract("P,Pae->ae", dP, df.Bvv)
                 - contract("Pam,Pme->ae", Cam, df.Bov))
    tau_h = _tau(t1, t2, 1.0, 0.5)
    o, v = slice(0, no), slice(no, None)
    return (F[v, v]
            - 0.5 * contract("me,ma->ae", F[o, v], t1)
            + ovvv_term
            - contract("mnaf,mnef->ae", tau_h, Loovv))


def build_Fmi_df(F, Looov, Loovv, t1, t2, no):
    o, v = slice(0, no), slice(no, None)
    tau_h = _tau(t1, t2, 1.0, 0.5)
    return (F[o, o]
            + 0.5 * contract("ie,me->mi", t1, F[o, v])
            + contract("ne,mnie->mi", t1, Looov)
            + contract("inef,mnef->mi", tau_h, Loovv))


def build_Fme_df(F, Loovv, t1, no):
    o, v = slice(0, no), slice(no, None)
    return F[o, v] + contract("nf,mnef->me", t1, Loovv)


# ---------------------------------------------------------------------------
# two-particle intermediates
# ---------------------------------------------------------------------------

def build_Wmnij_df(eri_oooo, eri_ooov, eri_oovv, t1, t2):
    tau = _tau(t1, t2)
    return (eri_oooo
            + contract("je,mnie->mnij", t1, eri_ooov)
            # <mn|ej> = <nm|je>: reuse the ooov assembly transposed
            + contract("ie,nmje->mnij", t1, eri_ooov)
            + contract("ijef,mnef->mnij", tau, eri_oovv))


def build_Wmbej_df(df, eri_ovvo, eri_oovv, Loovv, eri_ooov, t1, t2):
    # contract('jf,mbef->mbej', t1, <mb|ef>=(me|bf)) without the ovvv tensor
    Cbj = contract("Pbf,jf->Pbj", df.Bvv, t1)
    ovvv_term = contract("Pme,Pbj->mbej", df.Bov, Cbj)
    tau_x = _tau(t1, t2, 0.5, 1.0)
    return (eri_ovvo
            + ovvv_term
            # <mn|ej> = <nm|je>
            - contract("nb,nmje->mbej", t1, eri_ooov)
            - contract("jnfb,mnef->mbej", tau_x, eri_oovv)
            + 0.5 * contract("njfb,mnef->mbej", t2, Loovv))


def build_Wmbje_df(df, eri_ovov, eri_oovv, eri_ooov, t1, t2):
    # contract('jf,mbfe->mbje', t1, <mb|fe>=(mf|be)) without the ovvv tensor
    Dmj = contract("Pmf,jf->Pmj", df.Bov, t1)
    ovvv_term = contract("Pmj,Pbe->mbje", Dmj, df.Bvv)
    tau_x = _tau(t1, t2, 0.5, 1.0)
    return (-eri_ovov
            - ovvv_term
            + contract("nb,mnje->mbje", t1, eri_ooov)
            + contract("jnfb,mnfe->mbje", tau_x, eri_oovv))


# ---------------------------------------------------------------------------
# the dressed particle-particle ladder
# ---------------------------------------------------------------------------

# The W block budget, in elements.  pycc_tpu's default, 2**26, was sized
# for 16 GB of TPU HBM and gives (H2O)_6/aug-cc-pVDZ (v = 216) 36 blocks
# of 6: K1 launches of (M, N, K) = (576, 1296, 46656), whose 64 x 128
# tiles make a grid of 99 blocks for 132 SMs.  2**28 (a 1.9 GB float64
# block, twice that with its (a,b,e,f) copy, on an 80 GB card) gives 9
# blocks of 24: (576, 5184, 46656), a grid of 369.  The budget changes
# only the memory, never the result.
LADDER_MAX_ELEMS = 2 ** 28


def _ladder_blocks(nv, naux, max_elems=LADDER_MAX_ELEMS):
    """Number of a-blocks so one (blk, v, v, v) assembly stays under
    ~max_elems elements; a divisor of nv where one is near."""
    return _block_count(nv, nv * nv * nv, max_elems)


def _block_count(n, row_elems, max_elems):
    """Number of blocks of n rows of row_elems elements each so that one
    block stays under ~max_elems elements; a divisor of n where one is
    near."""
    blk = max(1, int(max_elems // row_elems))
    nblk = max(1, -(-n // blk))
    while n % nblk:
        nblk += 1
    return nblk


def ladder_W(BL_blk, BR):
    """One a-block of the ladder integrals as K1's B operand:
    W[a,b,e,f] = sum_P BL[P,a,e] BR[P,b,f] for the block's a, as a
    contiguous (blk*nb, ne*nf) matrix with k = (e, f) along its rows.  The
    assembly is one (blk*ne, naux) @ (naux, nb*nf) product, (a e, b f);
    the (a, b, e, f) copy puts (e, f) last."""
    naux, blk, ne = BL_blk.shape
    nb, nf = BR.shape[1], BR.shape[2]
    W = BL_blk.reshape(naux, blk * ne).T @ BR.reshape(naux, nb * nf)
    return W.view(blk, ne, nb, nf).transpose(1, 2).reshape(blk * nb,
                                                           ne * nf)


def ladder_df(df, t1, t2, nblocks=None, ladder=vvvv_nt):
    """sum_ef tau[ijef] * W[abef] with
    W[abef] = sum_P (0.5 B[Pae] - sum_m t1[ma] B[Pme]) B[Pbf]:
    the vvvv ladder and the dense equations' `- t1*Zmbij` term in one
    dressed contraction, assembled in a-blocks by `dfhbar.ladder_apply`
    (peak blk*v^3, never v^4; nblocks=None takes `_ladder_blocks`), one
    `ladder` call (K1 by default) a block."""
    from .dfhbar import ladder_apply
    # piece by piece on Bvv's layout (one piece unless on a mesh)
    BL = per_piece(df.Bvv, lambda p, sl: 0.5 * p - contract(
        "ma,Pme->Pae", t1[:, sl[1]].to(p.device),
        df.Bov[:, :, sl[2]].to(p.device)))
    return ladder_apply(BL, df.Bvv, _tau(t1, t2), nblocks=nblocks,
                        ladder=ladder)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _r_T1_df(F, df, eri_oovv, Loovv, eri_ooov, t1, t2, Fae, Fme, Fmi, no):
    o, v = slice(0, no), slice(no, None)
    t2s = 2.0 * t2 - t2.swapaxes(2, 3)
    # contract('nf,nafi->ia', t1, L[o,v,v,o]): L[nafi] = 2(nf|ai) - (ni|af)
    dP = contract("Pnf,nf->P", df.Bov, t1)
    Can = contract("Paf,nf->Pan", df.Bvv, t1)
    lovvo_term = (2.0 * contract("P,Pia->ia", dP, df.Bov)
                  - contract("Pan,Pni->ia", Can, df.Boo))
    # contract('mief,maef->ia', t2s, <ma|ef>=(me|af))
    Vif = contract("Pme,mief->Pif", df.Bov, t2s)
    ovvv_term = contract("Pif,Paf->ia", Vif, df.Bvv)
    # contract('mnae,nmei->ia', t2, L[o,o,v,o]) with
    # L[nmei] = 2<nm|ei> - <nm|ie> = 2(ne|mi) - (ni|me); since
    # eri_ooov[m,n,i,e] = (mi|ne), (ne|mi) = eri_ooov[m,n,i,e] and
    # (ni|me) = eri_ooov[n,m,i,e]:
    Loovo_term = (2.0 * contract("mnae,mnie->ia", t2, eri_ooov)
                  - contract("mnae,nmie->ia", t2, eri_ooov))
    return (F[o, v]
            + contract("ie,ae->ia", t1, Fae)
            - contract("ma,mi->ia", t1, Fmi)
            + contract("imae,me->ia", t2s, Fme)
            + lovvo_term
            + ovvv_term
            - Loovo_term)


def residuals_ccsd_df(F, df, t1, t2, no, nblocks=None, ladder=vvvv_nt):
    """DF-CCSD residuals: same fixed point as models/ccsd.residuals_ccsd
    evaluated on the B-reconstructed ERI (exactly, given exact factors);
    the ladder's blocks go through `ladder` (K1 by default)."""
    # the ladder reads Bvv's pieces (dfs), every other term Bvv whole
    dfs, df = df, whole_bvv(df)
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)
    eri_oooo = _eri_oooo(df)
    eri_ovvo = _eri_ovvo(df)
    eri_ovov = _eri_ovov(df)
    eri_ovoo = _eri_ovoo(df)

    Fae = build_Fae_df(F, df, Loovv, t1, t2, no)
    Fmi = build_Fmi_df(F, Looov, Loovv, t1, t2, no)
    Fme = build_Fme_df(F, Loovv, t1, no)
    Wmnij = build_Wmnij_df(eri_oooo, eri_ooov, eri_oovv, t1, t2)
    Wmbej = build_Wmbej_df(df, eri_ovvo, eri_oovv, Loovv, eri_ooov, t1, t2)
    Wmbje = build_Wmbje_df(df, eri_ovov, eri_oovv, eri_ooov, t1, t2)
    tau = _tau(t1, t2)

    r1 = _r_T1_df(F, df, eri_oovv, Loovv, eri_ooov, t1, t2,
                  Fae, Fme, Fmi, no)

    r2 = seed(0.5 * eri_oovv, t2)
    r2 += contract("ijae,be->ijab", t2, Fae)
    r2 -= 0.5 * contract("ijae,be->ijab", t2, contract("mb,me->be", t1, Fme))
    r2 -= contract("imab,mj->ijab", t2, Fmi)
    r2 -= 0.5 * contract("imab,jm->ijab", t2, contract("je,me->jm", t1, Fme))
    r2 += 0.5 * contract("mnij,mnab->ijab", Wmnij, tau)
    # dressed ladder == 0.5*vvvv ladder - t1*Zmbij of the dense equations
    r2 += ladder_df(dfs, t1, t2, nblocks=nblocks, ladder=ladder)
    r2 += contract("imae,mbej->ijab", t2 - t2.swapaxes(2, 3), Wmbej)
    r2 += contract("imae,mbej->ijab", t2, Wmbej + Wmbje.swapaxes(2, 3))
    r2 += contract("mjae,mbie->ijab", t2, Wmbje)
    tt = contract("ie,ma->imea", t1, t1)
    r2 -= contract("imea,mbej->ijab", tt, eri_ovvo)
    r2 -= contract("imeb,maje->ijab", tt, eri_ovov)
    # contract('ie,abej->ijab', t1, <ab|ej>=(ae|bj)) without the vvvo tensor
    Eia = contract("Pae,ie->Pia", df.Bvv, t1)
    r2 += contract("Pia,Pjb->ijab", Eia, df.Bov)
    r2 -= contract("ma,mbij->ijab", t1, eri_ovoo)
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def residuals_ccd_df(F, df, t1, t2, no, nblocks=None, ladder=vvvv_nt):
    """DF-CCD: models/ccsd.residuals_ccd with factorized integrals."""
    # the ladder reads Bvv's pieces (dfs), every other term Bvv whole
    dfs, df = df, whole_bvv(df)
    o, v = slice(0, no), slice(no, None)
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    Fae = F[v, v] - contract("mnaf,mnef->ae", t2, Loovv)
    Fmi = F[o, o] + contract("inef,mnef->mi", t2, Loovv)
    Wmnij = _eri_oooo(df) + contract("ijef,mnef->mnij", t2, eri_oovv)
    eri_ovvo = _eri_ovvo(df)
    eri_ovov = _eri_ovov(df)
    Wmbej = (eri_ovvo
             - 0.5 * contract("jnfb,mnef->mbej", t2, eri_oovv)
             + 0.5 * contract("njfb,mnef->mbej", t2, Loovv))
    Wmbje = -eri_ovov + 0.5 * contract("jnfb,mnfe->mbje", t2, eri_oovv)

    r1 = torch.zeros_like(t1)
    r2 = seed(0.5 * eri_oovv, t2)
    r2 += contract("ijae,be->ijab", t2, Fae)
    r2 -= contract("imab,mj->ijab", t2, Fmi)
    r2 += 0.5 * contract("mnij,mnab->ijab", Wmnij, t2)
    # undressed ladder: t1 = 0 makes BL = 0.5 * Bvv and tau = t2 (a real
    # zero, so that BL stays real under real-time CC's complex t2)
    r2 += ladder_df(dfs, torch.zeros_like(t1.real), t2, nblocks=nblocks,
                    ladder=ladder)
    r2 += contract("imae,mbej->ijab", t2 - t2.swapaxes(2, 3), Wmbej)
    r2 += contract("imae,mbej->ijab", t2, Wmbej + Wmbje.swapaxes(2, 3))
    r2 += contract("mjae,mbie->ijab", t2, Wmbje)
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def residuals_cc2_df(F, df, t1, t2, no, nblocks=None):
    """DF-CC2: models/ccsd.residuals_cc2 with factorized integrals.  The
    t1^2 vvvv and ovvv terms collapse to rank-1-in-t1 B contractions, so
    CC2 needs no ladder blocks at all (`nblocks` is accepted and unused)."""
    df = whole_bvv(df)      # Bvv whole (assembled on a mesh)
    o, v = slice(0, no), slice(no, None)
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)
    eri_oooo = _eri_oooo(df)
    eri_ovvo = _eri_ovvo(df)
    eri_ovov = _eri_ovov(df)
    eri_ovoo = _eri_ovoo(df)

    Fae = build_Fae_df(F, df, Loovv, t1, t2, no)
    Fmi = build_Fmi_df(F, Looov, Loovv, t1, t2, no)
    Fme = build_Fme_df(F, Loovv, t1, no)
    Wmnij = (eri_oooo
             + contract("je,mnie->mnij", t1, eri_ooov)
             + contract("ie,nmje->mnij", t1, eri_ooov)
             + contract("jf,mnif->mnij", t1,
                        contract("ie,mnef->mnif", t1, eri_oovv)))
    # Zmbij(CC2) = sum_ef <mb|ef> t1[ie] t1[jf] = sum_P (Bov.t1)(Bvv.t1)
    Dmi = contract("Pme,ie->Pmi", df.Bov, t1)
    Cbj = contract("Pbf,jf->Pbj", df.Bvv, t1)
    Zmbij = contract("Pmi,Pbj->mbij", Dmi, Cbj)

    r1 = _r_T1_df(F, df, eri_oovv, Loovv, eri_ooov, t1, t2,
                  Fae, Fme, Fmi, no)

    r2 = seed(0.5 * eri_oovv, t2)
    fae = F[v, v] - 0.5 * contract("me,ma->ae", F[o, v], t1)
    r2 += contract("ijae,be->ijab", t2, fae)
    r2 -= 0.5 * contract("ijae,be->ijab", t2,
                         contract("mb,me->be", t1, F[o, v]))
    fmi = F[o, o] + 0.5 * contract("ie,me->mi", t1, F[o, v])
    r2 -= contract("imab,mj->ijab", t2, fmi)
    r2 -= 0.5 * contract("imab,jm->ijab", t2,
                         contract("je,me->jm", t1, F[o, v]))
    r2 += 0.5 * contract("ma,mbij->ijab", t1,
                         contract("nb,mnij->mbij", t1, Wmnij))
    # 0.5 * t1[ie] t1[jf] <ab|ef>: rank-1 dressed — no v^4, no blocks
    Eia = contract("Pae,ie->Pia", df.Bvv, t1)
    r2 += 0.5 * contract("Pia,Pjb->ijab", Eia, Eia)
    r2 -= contract("ma,mbij->ijab", t1, Zmbij)
    r2 -= contract("ma,mbij->ijab", t1,
                   contract("ie,mbej->mbij", t1, eri_ovvo))
    r2 -= contract("mb,maji->ijab", t1,
                   contract("ie,maje->maji", t1, eri_ovov))
    r2 += contract("Pia,Pjb->ijab", Eia, df.Bov)
    r2 -= contract("ma,mbij->ijab", t1, eri_ovoo)
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def cc_energy_df(F, df, t1, t2, no):
    """The CC correlation energy from the factors (with t1 = 0, the CCD
    energy)."""
    o, v = slice(0, no), slice(no, None)
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    ecc = 2.0 * contract("ia,ia->", F[o, v], t1)
    return ecc + contract("ijab,ijab->", _tau(t1, t2), Loovv)
