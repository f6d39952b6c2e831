"""DF (Cholesky-factorized) similarity-transformed Hamiltonian.

The counterpart of pycc_tpu/models/dfhbar.py, term for term.  The dense
HBAR (cchbar.py) stores three blocks that cannot exist at DF sizes: Hvvvv
(v^4), Hvovv and Hvvvo (o v^3).  This module keeps every block larger
than o^3 v implicit in the Cholesky factors

    ERI[p,q,r,s] = <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s]

with two t1-dressed factor variants covering the pure-t1 parts of the big
blocks exactly:

    Bd_ae[P,a,e] = Bvv[P,a,e] - sum_n t1[n,a] Bov[P,n,e]
        => Hvovv[amef] = sum_P Bd_ae[P,a,e] Bov[P,m,f]          (exact)
        => Hvvvv[abef] = sum_P Bd_ae[P,a,e] Bd_ae[P,b,f]
                         + sum_mn t2[mnab] <mn|ef>               (CCSD)
    Bd_mi[P,m,i] = Boo[P,m,i] + sum_f t1[i,f] Bov[P,m,f]
        => Hooov[mnie] = sum_P Bd_mi[P,m,i] Bov[P,n,e]          (exact)

Every consumer of the implicit blocks (the Lambda residuals, the EOM
sigmas, the response residuals of dfresponse.py) is re-derived so that
its largest intermediate is (naux, o, v) or o^2 v^2, except the
particle-particle ladders, which go through `ladder_apply`: W assembled a
block of a at a time on `torch.matmul`, and each block's product with the
amplitudes one launch of the K1 kernel (`vvvv_nt`; its plain version on
CPU tensors).

The EOM sigmas and their helpers take a leading batch of vectors
(`...` in their contractions), so that a Davidson block of k vectors is
one batched evaluation whose ladder is one K1 launch an a-block for all
k vectors.

Not ported (ROADMAP.md "Not ported"): pycc_tpu's five-program split
Lambda (`lambda_r2_small_a_df` ... `lambda_residuals_df_split`), sized
for 15.75 GB of TPU HBM, and the CTensor branch of `ladder_apply` (torch
has complex dtypes: a complex W is one K1 product a block here).
"""

from typing import NamedTuple

import torch

from ..ops.contract import contract
from ..ops.kernels.vvvv import (ladder_product, stack_rows,
                                unstack_product, vvvv_nt)
from ..parallel.mesh import Sharded, dense, per_piece, region, split_ranges
from .dfccsd import (DFERI, LADDER_MAX_ELEMS, _block_count, _eri_oooo,
                     _eri_ooov, _eri_oovv, _eri_ovoo, _eri_ovov, _eri_ovvo,
                     _ladder_blocks, _tau, ladder_W, whole_bvv)


class DFHBar(NamedTuple):
    """HBAR over Cholesky factors: explicit blocks <= o^3 v, plus the
    dressed factors that generate the implicit Hvovv/Hvvvo/Hvvvv."""
    Hov: torch.Tensor      # (o, v)
    Hvv: torch.Tensor      # (v, v)
    Hoo: torch.Tensor      # (o, o)
    Hoooo: torch.Tensor    # (o, o, o, o)
    Hooov: torch.Tensor    # (o, o, o, v)
    Hovvo: torch.Tensor    # (o, v, v, o)
    Hovov: torch.Tensor    # (o, v, o, v)
    Hovoo: torch.Tensor    # (o, v, o, o)
    df: DFERI              # undressed factors
    Bd_ae: torch.Tensor    # (naux, v, v) creation-virtual dressed
    Bd_mi: torch.Tensor    # (naux, o, o) annihilation-occupied dressed


def dress_factors(df, t1):
    """The two t1 dressings (see the module docstring).  Bd_ae is dressed
    piece by piece on Bvv's layout and keeps it (`parallel/mesh.
    per_piece`: one piece unless on a mesh)."""
    Bd_ae = per_piece(df.Bvv, lambda p, sl: p - contract(
        "na,Pne->Pae", t1[:, sl[1]].to(p.device),
        df.Bov[:, :, sl[2]].to(p.device)))
    Bd_mi = df.Boo + contract("if,Pmf->Pmi", t1, df.Bov)
    return Bd_ae, Bd_mi


def _pair_sym(x):
    """x[..., i, j, a, b] + x[..., j, i, b, a]."""
    return x + x.transpose(-4, -3).transpose(-2, -1)


# ---------------------------------------------------------------------------
# the blocked particle-particle ladder, through K1
# ---------------------------------------------------------------------------

def ladder_apply(BL, BR, x2, nblocks=None, ladder=vvvv_nt):
    """sum_ef x2[..., e, f] W[a, b, e, f] with
    W[abef] = sum_P BL[P,a,e] BR[P,b,f], for x2 of any leading shape: the
    general form of dfccsd.ladder_df (the ground-state tau ladder, the
    Lambda/EOM/response Hvvvv ladders, the t1- and X1-dressed ladders of
    the densities and the response).

    W is assembled a block of a at a time (`dfccsd.ladder_W`: one
    torch.matmul, then laid out as K1's (blk*nb, ne*nf) B operand), and
    every block's product with x2, flattened to (M, ne*nf), is one call of
    `ladder(A, B)` = A @ B.T: the K1 kernel by default,
    `vvvv_nt_reference` for the plain product.  nblocks=None takes the
    port's budget (`dfccsd._ladder_blocks`); the blocks write into one
    preallocated output, a ragged last block needs no padding.

    On a mesh (BL or BR Sharded, parallel/mesh.py) each cell takes its
    a-range and b-range: the factor slices BL[:, A] and BR[:, B] gathered
    onto its device, W assembled there a block of its a at a time, one
    `ladder` call a block, and the block's (a, b) columns copied into the
    output on x2's device.  With nblocks=None a shard's blocks are sized
    to the same budget (`dfccsd._block_count`).

    A complex x2 goes in as one real product, its real and imaginary rows
    stacked.  A complex factor makes W complex (real-time CC's factors,
    dressed by complex t1): each block's W is assembled complex and goes
    in as [Re W; Im W], so the block is still ONE product
    (`ops/kernels/vvvv.complex_product`), on a quarter of the real block
    budget (W complex and its stacked copy).  A complex BL against a real
    BR and a real x2 (the response's X1-dressed factor) stays two real
    ladders.  bfloat16 operands take K1's bf16 mode and give a bfloat16
    result (`ladder_product`)."""
    complex_W = BL.is_complex() or BR.is_complex()
    if complex_W and not BR.is_complex() and not x2.is_complex():
        return (ladder_apply(BL.real, BR, x2, nblocks, ladder)
                + 1j * ladder_apply(BL.imag, BR, x2, nblocks, ladder))
    if complex_W:
        dt = torch.promote_types(BL.dtype, BR.dtype)
        BL, BR = BL.to(dt), BR.to(dt)
    naux, na, ne = BL.shape
    nb, nf = BR.shape[1], BR.shape[2]
    lead = x2.shape[:-2]
    A = x2.reshape(-1, ne * nf)
    m = A.shape[0]
    As = stack_rows(A).contiguous()
    budget = LADDER_MAX_ELEMS // 4 if complex_W else LADDER_MAX_ELEMS
    mesh = next((x.mesh for x in (BL, BR) if isinstance(x, Sharded)), None)
    if mesh is None:
        if nblocks is None:
            nblocks = _ladder_blocks(na, naux, budget)
        cells = [(slice(0, na), slice(0, nb), -(-na // nblocks), BL, BR,
                  As)]
    else:
        cells = _mesh_cells(mesh, BL, BR, As, nblocks, budget, ne * nf)
    if complex_W:
        z = torch.empty((m, na, nb), dtype=torch.promote_types(A.dtype, dt),
                        device=A.device)
    else:
        z = torch.empty((As.shape[0], na, nb), dtype=As.dtype,
                        device=A.device)
    for sa, sb, blk, BLc, BRc, Ac in cells:
        nA, nB = sa.stop - sa.start, sb.stop - sb.start
        for a0 in range(0, nA, blk):
            a1 = min(a0 + blk, nA)
            W = ladder_W(BLc[:, a0:a1], BRc)
            if complex_W:
                out = unstack_product(
                    ladder_product(ladder, Ac, stack_rows(W)),
                    A.is_complex(), True)
            else:
                out = ladder_product(ladder, Ac, W)
            z[:, sa.start + a0:sa.start + a1, sb].copy_(
                out.view(-1, a1 - a0, nB))
            del W, out
    if x2.is_complex() and not complex_W:
        z = torch.complex(z[:m], z[m:])
    return z.view(*lead, na, nb)


def _mesh_cells(mesh, BL, BR, As, nblocks, budget, kf):
    """(a-range, b-range, block, BL[:, A], BR[:, B], As) of every mesh
    cell with work, the factor slices and As on the cell's device (As
    copied once a device)."""
    na, nb = BL.shape[1], BR.shape[1]
    on = {}
    cells = []
    for i, j, dev in mesh.cells():
        sa = slice(*split_ranges(na, mesh.shape[0])[i])
        sb = slice(*split_ranges(nb, mesh.shape[1])[j])
        nA, nB = sa.stop - sa.start, sb.stop - sb.start
        if nA * nB == 0:
            continue
        if dev not in on:
            on[dev] = As.to(dev)
        blk = (-(-na // nblocks) if nblocks is not None
               else -(-nA // _block_count(nA, nB * kf, budget)))
        cells.append((sa, sb, blk, region(BL, (slice(None), sa), dev),
                       region(BR, (slice(None), sb), dev), on[dev]))
    return cells


def whole_factors(dfh):
    """dfh with Bd_ae and Bvv whole where they live, for the implicit-block
    terms, which contract them outside a ladder: on a mesh assembled on
    the home device, once a call (`dfccsd.whole_bvv`)."""
    return dfh._replace(df=whole_bvv(dfh.df), Bd_ae=dense(dfh.Bd_ae))


def _ea_layout(Bd_ae):
    """Bd_ae[P,a,e] -> [P,e,a]: ladder_apply wants the OUTPUT index first
    (W[abef] = BL[P,a,e] BR[P,b,f]); Hvvvv[efab] contracts x2 over its
    first two (creation) indices, so the output a,b are the annihilation
    columns of Bd_ae."""
    return Bd_ae.transpose(1, 2)


def hvvvv_x2_df(dfh, t2, x2, nblocks=None, ladder=vvvv_nt):
    """0.5 * sum_ef x2[ijef] Hvvvv[efab] (no pair symmetrization): the DF
    form of 0.5 * models/ccsd.vvvv_contract_efab(x2, Hvvvv), the Lambda
    r2 and response Y2 ladder.

    Hvvvv[efab] = sum_P Bd_ae[P,e,a] Bd_ae[P,f,b]   (pure-t1 part, exact)
                + sum_mn t2[mnef] <mn|ab>           (CCSD tau-residue)"""
    BL = _ea_layout(dfh.Bd_ae)
    out = 0.5 * ladder_apply(BL, BL, x2, nblocks=nblocks, ladder=ladder)
    X = contract("ijef,mnef->ijmn", x2, t2)
    return out + 0.5 * contract("ijmn,mnab->ijab", X, _eri_oovv(dfh.df))


def hvvvv_x2_abef_df(dfh, t2, x2, nblocks=None, ladder=vvvv_nt):
    """0.5 * sum_ef x2[..., ijef] Hvvvv[abef]: the DF form of
    0.5 * models/ccsd.vvvv_contract(x2, Hvvvv) (the EOM sigma2 ladder; a
    block of vectors is one `ladder` call an a-block).
    Hvvvv[abef] = sum_P Bd_ae[P,a,e] Bd_ae[P,b,f] + t2[mnab] <mn|ef>."""
    out = 0.5 * ladder_apply(dfh.Bd_ae, dfh.Bd_ae, x2, nblocks=nblocks,
                             ladder=ladder)
    X = contract("...ijef,mnef->...ijmn", x2, _eri_oovv(dfh.df))
    return out + 0.5 * contract("...ijmn,mnab->...ijab", X, t2)


def loovv_df(df):
    """L[o,o,v,v] = 2<mn|ef> - <mn|fe> assembled from factors."""
    e = _eri_oovv(df)
    return 2.0 * e - e.swapaxes(2, 3)


# ---------------------------------------------------------------------------
# the tau * <mb|ef> one-time o^3 v block for Hovoo
# ---------------------------------------------------------------------------

def _tau_ovvv_ovoo(df, tau):
    """sum_ef tau[ijef] <mb|ef> -> (m, b, i, j); <mb|ef> = (me|bf).  A
    loop over m, so that the largest live array is (naux, o^2, v)."""
    no, nv = df.Bov.shape[1], df.Bov.shape[2]
    dt = torch.promote_types(tau.dtype, df.Bov.dtype)
    out = torch.empty((no, nv, no, no), dtype=dt, device=tau.device)
    for m in range(no):
        Z = contract("Pe,ijef->Pijf", df.Bov[:, m], tau)   # (naux, o, o, v)
        out[m] = contract("Pijf,Pbf->bij", Z, df.Bvv)
        del Z
    return out


# ---------------------------------------------------------------------------
# HBAR build (CCSD forms; the CC2 forms with model='CC2')
# ---------------------------------------------------------------------------

def build_hbar_df(F, dfb, t1, t2, no, model="CCSD"):
    """All <= o^3 v HBAR blocks from factors, equal to the dense
    cchbar.build_hbar(model, ...) blocks (given exact factors), plus the
    dressed factors for the implicit blocks.  model='CC2' produces the CC2
    forms: the doubles blocks are pure t1-dressed integrals, which is what
    the dressed-factor bilinears give, plus bare-Fock t2 terms in
    Hovoo/Hvvvo.  CCD shares the CCSD forms (they coincide at t1 = 0)."""
    o, v = slice(0, no), slice(no, None)
    # Bd_ae is dressed on Bvv's layout; the blocks read Bvv whole
    Bd_ae, Bd_mi = dress_factors(dfb, t1)
    df = whole_bvv(dfb)
    cc2 = model == "CC2"
    tau = _tau(t1, t2)

    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)

    Hov = F[o, v] + contract("nf,mnef->me", t1, Loovv)

    # Hvv: the ovvv term sum_mf t1[mf] L[amef], L[amef] = 2(ae|mf)-(af|me)
    dP = contract("Pmf,mf->P", df.Bov, t1)
    Cam = contract("Paf,mf->Pam", df.Bvv, t1)
    ovvv_t = (2.0 * contract("P,Pae->ae", dP, df.Bvv)
              - contract("Pam,Pme->ae", Cam, df.Bov))
    Hvv = (F[v, v]
           - contract("me,ma->ae", F[o, v], t1)
           + ovvv_t
           - contract("mnfa,mnfe->ae", tau, Loovv))

    Hoo = (F[o, o]
           + contract("ie,me->mi", t1, F[o, v])
           + contract("ne,mnie->mi", t1, Looov)
           + contract("inef,mnef->mi", tau, Loovv))

    eri_oooo = _eri_oooo(df)
    tmp = contract("je,mnie->mnij", t1, eri_ooov)
    Hoooo = eri_oooo + tmp + tmp.permute(1, 0, 3, 2)
    if cc2:
        # the t1.t1 bilinear instead of tau
        Hoooo = Hoooo + contract("jf,mnif->mnij", t1,
                                 contract("ie,mnef->mnif", t1, eri_oovv))
    else:
        Hoooo = Hoooo + contract("ijef,mnef->mnij", tau, eri_oovv)

    # Hooov[mnie] = sum_P Bd_mi[P,m,i] Bov[P,n,e]  (exact; module doc)
    Hooov = contract("Pmi,Pne->mnie", Bd_mi, df.Bov)

    eri_ovvo = _eri_ovvo(df)
    eri_ovov = _eri_ovov(df)
    eri_ovoo = _eri_ovoo(df)
    eri_oovo = contract("Pme,Pni->mnei", df.Bov, df.Boo)  # <mn|ei> = (me|ni)

    # Hovvo[mbej]: the t1 ovvv term by the rank-1 dressing
    Cbj = contract("Pbf,jf->Pbj", df.Bvv, t1)
    Hovvo = (eri_ovvo
             + contract("Pme,Pbj->mbej", df.Bov, Cbj)
             - contract("nb,mnej->mbej", t1, eri_oovo))
    Dmj = contract("Pmf,jf->Pmj", df.Bov, t1)
    Hovov = (eri_ovov
             + contract("Pmj,Pbe->mbje", Dmj, df.Bvv)
             - contract("nb,mnje->mbje", t1, eri_ooov))
    if not cc2:
        Hovvo = (Hovvo
                 - contract("jnfb,mnef->mbej", tau, eri_oovv)
                 + contract("njfb,mnef->mbej", t2, Loovv))
        Hovov = Hovov - contract("jnfb,nmef->mbje", tau, eri_oovv)

    if cc2:
        # Hovoo CC2: the dressed integral + bare-Fock t2; the three t1
        # dressings assemble from the rank-1 factors above
        Hovoo = (eri_ovoo
                 + contract("me,ijeb->mbij", F[o, v], t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + contract("Pmi,Pbj->mbij", Dmj, Cbj)
                 + contract("Pmi,Pbj->mbij", df.Boo, Cbj)
                 + contract("Pmi,Pjb->mbij", Dmj, df.Bov))
    else:
        Hovoo = (eri_ovoo
                 + contract("me,ijeb->mbij", Hov, t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + _tau_ovvv_ovoo(df, tau))
        tmpo = eri_ovov - contract("infb,mnfe->mbie", t2, eri_oovv)
        Hovoo = (Hovoo
                 - contract("ineb,nmje->mbij", t2, eri_ooov)
                 - contract("jneb,mnie->mbij", t2, eri_ooov)
                 + contract("njeb,mnie->mbij", t2, Looov)
                 + contract("je,mbie->mbij", t1, tmpo))
        tmpv = (contract("Pjb,Pme->bmje", df.Bov, df.Bov)
                - contract("jnfb,mnef->bmje", t2, eri_oovv)
                + contract("njfb,mnef->bmje", t2, Loovv))
        Hovoo = Hovoo + contract("ie,bmje->mbij", t1, tmpv)

    return DFHBar(Hov=Hov, Hvv=Hvv, Hoo=Hoo, Hoooo=Hoooo, Hooov=Hooov,
                  Hovvo=Hovvo, Hovov=Hovov, Hovoo=Hovoo,
                  df=dfb, Bd_ae=Bd_ae, Bd_mi=Bd_mi)


# ---------------------------------------------------------------------------
# implicit-Hvovv consumers (Hvovv[amef] = sum_P Bd_ae[P,a,e] Bov[P,m,f])
# ---------------------------------------------------------------------------

def zvv_c1_hvovv(dfh, C1):
    """2 'amef,mf->ae' - 'amfe,mf->ae' over Hvovv (the EOM Zvv), for C1
    of any leading shape."""
    dfh = whole_factors(dfh)
    s = contract("Pmf,...mf->...P", dfh.df.Bov, C1)
    # the second term: C1[mf] Hvovv[amfe] = C1[mf] Bd[P,a,f] Bov[P,m,e]
    E = contract("Paf,...mf->...Pam", dfh.Bd_ae, C1)
    return (2.0 * contract("...P,Pae->...ae", s, dfh.Bd_ae)
            - contract("...Pam,Pme->...ae", E, dfh.df.Bov))


def r1_c2_hvovv(dfh, C2):
    """2 'imef,amef->ia' - 'imef,amfe->ia' (the EOM sigma1), for C2 of
    any leading shape.  Largest intermediate (naux, o, v) a vector."""
    dfh = whole_factors(dfh)
    Z = contract("...imef,Pmf->...Pie", C2, dfh.df.Bov)
    Z2 = contract("...imef,Pme->...Pif", C2, dfh.df.Bov)
    return (2.0 * contract("...Pie,Pae->...ia", Z, dfh.Bd_ae)
            - contract("...Pif,Paf->...ia", Z2, dfh.Bd_ae))


def r1_gvv_hvovv(dfh, Gvv):
    """-2 'ef,eifa->ia' + 'ef,eiaf->ia' over Hvovv (the Lambda r1)."""
    dfh = whole_factors(dfh)
    s = contract("ef,Pef->P", Gvv, dfh.Bd_ae)
    T = contract("ef,Pea->Pfa", Gvv, dfh.Bd_ae)
    return (-2.0 * contract("P,Pia->ia", s, dfh.df.Bov)
            + contract("Pfa,Pif->ia", T, dfh.df.Bov))


def r2_l1_hvovv(dfh, l1):
    """2 'ie,ejab->ijab' - 'ie,ejba->ijab' over Hvovv (the Lambda r2)."""
    dfh = whole_factors(dfh)
    A = contract("ie,Pea->Pia", l1, dfh.Bd_ae)
    t1_ = contract("Pia,Pjb->ijab", A, dfh.df.Bov)
    A2 = contract("ie,Peb->Pib", l1, dfh.Bd_ae)
    t2_ = contract("Pib,Pja->ijab", A2, dfh.df.Bov)
    return 2.0 * t1_ - t2_


# ---------------------------------------------------------------------------
# implicit-Hvvvo consumers
# ---------------------------------------------------------------------------

def r1_l2_hvvvo(dfh, t1, t2, l2, Hov, cc2=False):
    """'imef,efam->ia' over the FULL CCSD Hvvvo without the o v^3 block.
    Renaming Hvvvo[abei] -> [e,f,a,m], each of the nine dense terms
    reduces to factor assemblies with <= (naux,o,v) / o^2 v^2
    intermediates; the derivation is in this function term by term.

    cc2=True evaluates the CC2 Hvvvo instead: bare F[o,v] in (2) (pass it
    as Hov), the t1.t1 bilinear for tau in (4), the t1-dressed-only
    Hvvvv in (3), bare integrals in (8)/(9), and no t2 ring terms
    (5)-(7)."""
    dfh = whole_factors(dfh)
    df = dfh.df
    Bov, Boo, Bvv = df.Bov, df.Boo, df.Bvv
    tau = _tau(t1, t2)

    # (1) <ef|am> = (ea|fm):  Z[P,i,e] = l2[imef] Bov[P,m,f]
    Z = contract("imef,Pmf->Pie", l2, Bov)
    out = contract("Pie,Pea->ia", Z, Bvv)
    # (2) -Hov[na] t2[nmef]   (CC2: F[o,v] instead of Hov)
    out -= contract("in,na->ia", contract("imef,nmef->in", l2, t2), Hov)
    # (3) t1[mg] Hvvvv[efag]:
    #     factor part: E[P,m,f] = t1[mg] Bd_ae[P,f,g];
    #     Z3[P,i,e] = l2[imef] E[P,m,f]; out += Z3[P,i,e] Bd_ae[P,e,a]
    E = contract("mg,Pfg->Pmf", t1, dfh.Bd_ae)
    Z3 = contract("imef,Pmf->Pie", l2, E)
    out += contract("Pie,Pea->ia", Z3, dfh.Bd_ae)
    if not cc2:
        # the t2 residue of Hvvvv, through o^3 v intermediates
        l2t = contract("imef,mg->igef", l2, t1)
        X = contract("igef,pqef->igpq", l2t, t2)
        Y = contract("igpq,Pqg->Pip", X, Bov)
        out += contract("Pip,Ppa->ia", Y, Bov)
    # (4) tau[pqef] <pq|am> = (pa|qm)   (CC2: t1[pe] t1[qf] bilinear)
    if cc2:
        lt4 = contract("imef,qf->imeq", l2, t1)
        T4 = contract("imeq,pe->ipqm", lt4, t1)
    else:
        T4 = contract("imef,pqef->ipqm", l2, tau)
    Y4 = contract("ipqm,Pqm->Pip", T4, Boo)
    out += contract("Pip,Ppa->ia", Y4, Bov)
    if cc2:
        # (8') -t1[pf] <ep|am>, <ep|am> = (ea|pm)
        lt = contract("imef,pf->imep", l2, t1)
        W8 = contract("imep,Ppm->Pie", lt, Boo)
        out -= contract("Pie,Pea->ia", W8, Bvv)
        # (9') -t1[pe] <fp|ma>, <fp|ma> = (fm|pa)
        ZT = contract("pe,Pie->Pip", t1, Z)
        out -= contract("Pip,Ppa->ia", ZT, Bov)
        return out
    # (5) -t2[mpge] <fp|ga> = (fg|pa):  U[i,f,p,g] = l2[imef] t2[mpge]
    U = contract("imef,mpge->ifpg", l2, t2)
    W5 = contract("ifpg,Pfg->Pip", U, Bvv)
    out -= contract("Pip,Ppa->ia", W5, Bov)
    # (6) -t2[mpgf] <ep|ag> = (ea|pg):  V[i,e,p,g] = l2[imef] t2[mpgf]
    V = contract("imef,mpgf->iepg", l2, t2)
    W6 = contract("iepg,Ppg->Pie", V, Bov)
    out -= contract("Pie,Pea->ia", W6, Bvv)
    # (7) +t2[pmgf] L[epag] = 2(ea|pg) - (eg|pa)
    Vp = contract("imef,pmgf->iepg", l2, t2)
    W7 = contract("iepg,Ppg->Pie", Vp, Bov)
    out += 2.0 * contract("Pie,Pea->ia", W7, Bvv)
    W7b = contract("iepg,Peg->Pip", Vp, Bvv)
    out -= contract("Pip,Ppa->ia", W7b, Bov)
    # (8) -t1[pf] tmp1[e,p,a,m], tmp1 = <ep|am> - t2[mqge] <qp|ga>
    #     <ep|am> = (ea|pm):
    lt = contract("imef,pf->imep", l2, t1)
    W8 = contract("imep,Ppm->Pie", lt, Boo)
    out -= contract("Pie,Pea->ia", W8, Bvv)
    #     + t2[mqge] <pq|ga>, <pq|ga> = (pg|qa): pair p with g, q with a
    K8 = contract("imef,mqge->ifqg", l2, t2)
    C8 = contract("pf,Ppg->Pfg", t1, Bov)
    M8 = contract("ifqg,Pfg->Piq", K8, C8)
    out += contract("Piq,Pqa->ia", M8, Bov)
    # (9) -t1[pe] tmp2[f,p,m,a],
    #     tmp2 = <fp|ma> - t2[mngf] <pn|ga> + t2[nmgf] L[pnga]
    #     <fp|ma> = (fm|pa):  ZT[P,i,p] = t1[pe] Z[P,i,e]   (Z from (1))
    ZT = contract("pe,Pie->Pip", t1, Z)
    out -= contract("Pip,Ppa->ia", ZT, Bov)
    #     + t2[mngf] <pn|ga>, <pn|ga> = (pa|ng): pair n with g, p with a
    l2t1 = contract("imef,pe->imfp", l2, t1)
    X9 = contract("imfp,mngf->ipng", l2t1, t2)
    W9 = contract("ipng,Png->Pip", X9, Bov)
    out += contract("Pip,Ppa->ia", W9, Bov)
    #     - t2[nmgf] L[pnag], L[pnag] = 2(pa|ng) - (pg|na):
    X9b = contract("imfp,nmgf->ipng", l2t1, t2)
    W9b = contract("ipng,Png->Pip", X9b, Bov)
    out -= 2.0 * contract("Pip,Ppa->ia", W9b, Bov)
    W9c = contract("ipng,Ppg->Pin", X9b, Bov)
    out += contract("Pin,Pna->ia", W9c, Bov)
    return out


def s2_c1_hvvvo(dfh, t1, t2, C1, Hov):
    """'ie,abej->ijab' over the FULL CCSD Hvvvo (the EOM sigma2) without
    the o v^3 block, for C1 of any leading shape; o^2 v^2 output a vector.
    The same nine dense terms as `r1_l2_hvvvo`, contracted over e with C1
    first."""
    dfh = whole_factors(dfh)
    df = dfh.df
    Bov, Boo, Bvv = df.Bov, df.Boo, df.Bvv
    tau = _tau(t1, t2)
    Eia = contract("...ie,Pae->...Pia", C1, Bvv)      # C1-dressed vv factor
    CB = contract("...ie,Pme->...Pim", C1, Bov)

    # (1) (ae|bj)
    out = contract("...Pia,Pjb->...ijab", Eia, Bov)
    # (2) -C1[ie] Hov[me] t2[mjab]
    out -= contract("...im,mjab->...ijab",
                    contract("...ie,me->...im", C1, Hov), t2)
    # (3) +C1[ie] t1[jf] Hvvvv[abef]: rank-1 ladder + t2 residue
    #     Hvvvv[abef] = Bd[P,a,e] Bd[P,b,f] + t2[mnab] <mn|ef>
    x2 = contract("...ie,jf->...ijef", C1, t1)
    EiaD = contract("...ie,Pae->...Pia", C1, dfh.Bd_ae)
    TjbD = contract("jf,Pbf->Pjb", t1, dfh.Bd_ae)
    out += contract("...Pia,Pjb->...ijab", EiaD, TjbD)
    X = contract("...ijef,mnef->...ijmn", x2, _eri_oovv(df))
    out += contract("...ijmn,mnab->...ijab", X, t2)
    # (4) +C1[ie] tau[mnab] <mn|ej> = (me|nj)
    G4 = contract("...Pim,Pnj->...ijmn", CB, Boo)
    out += contract("...ijmn,mnab->...ijab", G4, tau)
    # (5) -C1[ie] t2[jmfa] <bm|fe> = (bf|me)
    D5 = contract("...Pim,Pbf->...imbf", CB, Bvv)
    out -= contract("jmfa,...imbf->...ijab", t2, D5)
    del D5
    # (6) -C1[ie] t2[jmfb] <am|ef> = (ae|mf)
    D6 = contract("...Pia,Pmf->...iamf", Eia, Bov)
    out -= contract("jmfb,...iamf->...ijab", t2, D6)
    # (7) +C1[ie] t2[mjfb] L[amef],  L[amef] = 2(ae|mf) - (af|me)
    D7 = contract("...Pim,Paf->...imaf", CB, Bvv)
    out += contract("mjfb,...iamf->...ijab", t2, 2.0 * D6)
    out -= contract("mjfb,...imaf->...ijab", t2, D7)
    del D6, D7
    # (8) -t1[mb] (C1[ie]<am|ej> - C1[ie] t2[jnfa] <mn|fe>)
    #     <am|ej> = (ae|mj); <mn|fe> = (mf|ne): pair m-f, n-e
    #     (C1[ie] Bov[P,n,e] is CB again)
    G8 = contract("...Pia,Pmj->...iamj", Eia, Boo)
    K8b = contract("...Pin,Pmf->...imnf", CB, Bov)    # C1[ie] <mn|fe>
    T8 = G8 - contract("jnfa,...imnf->...iamj", t2, K8b)
    out -= contract("mb,...iamj->...ijab", t1, T8)
    K8 = contract("...Pim,Pnf->...imnf", CB, Bov)     # C1[ie] <mn|ef>

    # (9) -t1[ma] (C1[ie]<bm|je> - C1[ie] t2[jnfb] <mn|ef>
    #              + C1[ie] t2[njfb] L[mnef])
    #     <bm|je> = (bj|me); <mn|ef> = (me|nf); L[mnef] = 2(me|nf)-(mf|ne)
    G9 = contract("...Pim,Pjb->...imjb", CB, Bov)
    T9 = G9 - contract("jnfb,...imnf->...imjb", t2, K8)
    # the L part: C1[ie] L[mnef] = 2 C1[ie]<mn|ef> - C1[ie]<mn|fe>
    #   = 2 K8 - K8b
    T9 = T9 + contract("njfb,...imnf->...imjb", t2, 2.0 * K8 - K8b)
    out -= contract("ma,...imjb->...ijab", t1, T9)
    return out


# ---------------------------------------------------------------------------
# Lambda residuals over the DF-HBAR (cclambda.lambda_residuals)
# ---------------------------------------------------------------------------

def lambda_residuals_df(dfh, t1, t2, l1, l2, no, S1=None, S2=None,
                        nblocks=None, model="CCSD", F=None,
                        ladder=vvvv_nt):
    """r_L1, r_L2 over factors: every big-block contraction of the dense
    cclambda.lambda_residuals replaced by its factor-implicit form; equal
    to the dense path given exact factors.  CCD is exact here because the
    CCSD HBAR forms reduce to the CCD ones at t1 = 0 (and CCD keeps
    t1 = 0).  CC2 needs the bare Fock matrix F for its one-body r2 terms;
    dfh must be built with model='CC2'.  The Hvvvv ladder is one `ladder`
    call an a-block (K1 by default)."""
    ccd = model == "CCD"
    if model == "CC2":
        return _lambda_residuals_cc2_df(dfh, F, t1, t2, l1, l2, no,
                                        S1=S1, S2=S2)
    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)
    Loovv = loovv_df(dfh.df)
    Hovvo_s = 2.0 * dfh.Hovvo - dfh.Hovov.swapaxes(2, 3)

    if ccd:
        r1 = torch.zeros_like(l1)
    else:
        r1 = 2.0 * dfh.Hov
        if S1 is not None:
            r1 = r1 + S1
        r1 = r1 + contract("ie,ea->ia", l1, dfh.Hvv)
        r1 -= contract("ma,im->ia", l1, dfh.Hoo)
        r1 += r1_l2_hvvvo(dfh, t1, t2, l2, dfh.Hov)
        r1 -= contract("mnae,iemn->ia", l2, dfh.Hovoo)
        r1 += contract("me,ieam->ia", l1, Hovvo_s)
        r1 += r1_gvv_hvovv(dfh, Gvv)
        r1 -= 2.0 * contract("mn,mina->ia", Goo, dfh.Hooov)
        r1 += contract("mn,imna->ia", Goo, dfh.Hooov)

    r2 = Loovv
    if not ccd:
        if S2 is not None:
            r2 = r2 + 0.5 * S2
        r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, dfh.Hov)
        r2 -= contract("ja,ib->ijab", l1, dfh.Hov)
        r2 += r2_l1_hvovv(dfh, l1)
        r2 -= 2.0 * contract("mb,jima->ijab", l1, dfh.Hooov)
        r2 += contract("mb,ijma->ijab", l1, dfh.Hooov)
    r2 = r2 + contract("ijeb,ea->ijab", l2, dfh.Hvv)
    r2 -= contract("mjab,im->ijab", l2, dfh.Hoo)
    r2 += 0.5 * contract("mnab,ijmn->ijab", l2, dfh.Hoooo)
    r2 += hvvvv_x2_df(dfh, t2, l2, nblocks=nblocks, ladder=ladder)
    r2 += contract("mjeb,ieam->ijab", l2, Hovvo_s)
    r2 -= contract("mibe,jema->ijab", l2, dfh.Hovov)
    r2 -= contract("mieb,jeam->ijab", l2, dfh.Hovvo)
    r2 += contract("ae,ijeb->ijab", Gvv, Loovv)
    r2 -= contract("mi,mjab->ijab", Goo, Loovv)
    return r1, _pair_sym(r2)


def _lambda_residuals_cc2_df(dfh, F, t1, t2, l1, l2, no, S1=None, S2=None):
    """CC2 Lambda residuals over factors: the heavy-block terms (Hvvvv
    ladder, Hovvo/Hovov rings, Goo/Gvv) are absent in CC2; what remains
    is the implicit-Hvovv / implicit-Hvvvo l1/l2 terms plus bare-Fock
    one-body r2 terms.  dfh must be a model='CC2' build."""
    if F is None:
        raise ValueError("CC2 DF Lambda residuals need the Fock matrix F "
                         "(the dense CC2 r2 uses bare-Fock one-body terms)")
    o, v = slice(0, no), slice(no, None)
    tau = _tau(t1, t2)
    eri_oovv = _eri_oovv(dfh.df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    Hovvo_s = 2.0 * dfh.Hovvo - dfh.Hovov.swapaxes(2, 3)

    r1 = 2.0 * dfh.Hov
    if S1 is not None:
        r1 = r1 + S1
    r1 = r1 + contract("ie,ea->ia", l1, dfh.Hvv)
    r1 -= contract("ma,im->ia", l1, dfh.Hoo)
    r1 += r1_l2_hvvvo(dfh, t1, t2, l2, F[o, v], cc2=True)
    r1 -= contract("mnae,iemn->ia", l2, dfh.Hovoo)
    r1 += contract("me,ieam->ia", l1, Hovvo_s)
    tmp = contract("me,nmfe->nf", l1, t2)
    r1 += 2.0 * contract("nf,inaf->ia", tmp, Loovv)
    tmp = contract("me,mnfe->nf", l1, tau)
    r1 -= 2.0 * contract("nf,inaf->ia", tmp, eri_oovv)
    r1 += contract("nf,inaf->ia", tmp, eri_oovv.swapaxes(2, 3))

    r2 = Loovv
    if S2 is not None:
        r2 = r2 + 0.5 * S2
    r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, dfh.Hov)
    r2 -= contract("ja,ib->ijab", l1, dfh.Hov)
    r2 += r2_l1_hvovv(dfh, l1)
    r2 -= 2.0 * contract("mb,jima->ijab", l1, dfh.Hooov)
    r2 += contract("mb,ijma->ijab", l1, dfh.Hooov)
    r2 += contract("ijeb,ea->ijab", l2,
                   F[v, v] - contract("me,ma->ae", F[o, v], t1))
    r2 -= contract("mjab,im->ijab", l2,
                   F[o, o] + contract("ie,me->mi", t1, F[o, v]))
    return r1, _pair_sym(r2)


# ---------------------------------------------------------------------------
# EOM sigmas over the DF-HBAR (cceom.sigma1/sigma2), batched over vectors
# ---------------------------------------------------------------------------

def sigma1_df(dfh, C1, C2, Loovv, no):
    """cceom.sigma1 with the Hvovv terms factor-implicit, for C1 (..., o,
    v) and C2 (..., o, o, v, v) of any common leading shape."""
    s1 = contract("...ie,ae->...ia", C1, dfh.Hvv)
    s1 -= contract("mi,...ma->...ia", dfh.Hoo, C1)
    s1 += 2.0 * contract("maei,...me->...ia", dfh.Hovvo, C1)
    s1 -= contract("maie,...me->...ia", dfh.Hovov, C1)
    s1 += 2.0 * contract("...miea,me->...ia", C2, dfh.Hov)
    s1 -= contract("...imea,me->...ia", C2, dfh.Hov)
    s1 += r1_c2_hvovv(dfh, C2)
    s1 -= 2.0 * contract("mnie,...mnae->...ia", dfh.Hooov, C2)
    s1 += contract("nmie,...mnae->...ia", dfh.Hooov, C2)
    return s1


def sigma2_df(dfh, C1, C2, Loovv, t1, t2, no, nblocks=None, ladder=vvvv_nt):
    """cceom.sigma2 with Hvovv/Hvvvo/Hvvvv factor-implicit, for a leading
    batch of vectors as `sigma1_df`: the batch's Hvvvv ladder is one
    `ladder` call an a-block (K1 by default)."""
    Zvv = zvv_c1_hvovv(dfh, C1)
    Zvv -= contract("...nmaf,nmef->...ae", C2, Loovv)

    Zoo = -2.0 * contract("mnie,...ne->...mi", dfh.Hooov, C1)
    Zoo += contract("nmie,...ne->...mi", dfh.Hooov, C1)
    Zoo -= contract("mnef,...inef->...mi", Loovv, C2)

    s2 = s2_c1_hvvvo(dfh, t1, t2, C1, dfh.Hov)
    s2 -= contract("mbij,...ma->...ijab", dfh.Hovoo, C1)
    s2 += contract("ijeb,...ae->...ijab", t2, Zvv)
    s2 += contract("...mi,mjab->...ijab", Zoo, t2)
    s2 += contract("...ijeb,ae->...ijab", C2, dfh.Hvv)
    s2 -= contract("mi,...mjab->...ijab", dfh.Hoo, C2)
    s2 += 0.5 * contract("mnij,...mnab->...ijab", dfh.Hoooo, C2)
    s2 += hvvvv_x2_abef_df(dfh, t2, C2, nblocks=nblocks, ladder=ladder)
    s2 -= contract("...imeb,maje->...ijab", C2, dfh.Hovov)
    s2 -= contract("...imea,mbej->...ijab", C2, dfh.Hovvo)
    s2 += 2.0 * contract("...miea,mbej->...ijab", C2, dfh.Hovvo)
    s2 -= contract("...miea,mbje->...ijab", C2, dfh.Hovov)
    return _pair_sym(s2)
