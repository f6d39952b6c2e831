"""Local-scaling pair-space residuals (CCD, CCSD, CC2), padded-batched.

The counterpart of pycc_tpu/lccwfn_local.py, term for term: the
overlap-stitched pair-space equations with every per-pair loop written as
one contraction over stacked padded tensors.  All integral transforms
(iteration-independent) are made once by `precompute_*`; an iteration
then costs O(no^4 D^3)-type contractions with no dependence on the full
virtual dimension.

Index conventions: i,j,m,n occupied; a,b,e,f,x,y padded local-virtual
slots; QLr[i,j] is the (nv, D) canonical->semicanonical-local transform of
pair ij; Sr[i,j,m,n] = QL[ij]^T QL[mn].

The pair-local vvvv blocks (VV, VV2) are products of four transforms
with <vw|xy>, one pair at a time (`_pair_vvvv`), as pycc_tpu's screened
stacks are made; they are einsums in pycc_tpu too, not a Pallas kernel.
Contractions of three or more operands list them in the order they
contract, pairwise from the left (torch.einsum's order where opt_einsum is
not installed), and the o^3 D^3 stacks are made one row of their first
index at a time (`_rows`), so that no intermediate outgrows the stacks
themselves.

Over a device mesh (lccwfn(mesh=)) the pair-leading stacks are
`parallel.Sharded` (`parallel.mesh.shard_pair_stacks`) and every
contraction that reads one runs piece by piece (`contract_pieces`, C
here: the plain einsum when nothing is sharded).  The two o^4 D^2
intermediates (the overlap-stitched amplitudes of Fae and of the Wmnij
term) stay on the pieces (keep=True); a stack added whole to a term is
read whole once a call (`dense`).
"""

import torch

from .parallel.mesh import contract_pieces as C
from .parallel.mesh import dense


def _rows(subscripts, *operands):
    """C one value of the output's first index at a time, stacked:
    bounds the intermediates of a contraction whose operands share that
    index to 1/n of their size.  The index may occur at most once in each
    operand."""
    ins, out = subscripts.split("->")
    terms = ins.split(",")
    c = out[0]
    n = next(x.shape[t.index(c)] for t, x in zip(terms, operands) if c in t)
    spec = ",".join(t.replace(c, "") for t in terms) + "->" + out[1:]
    return torch.stack([
        C(spec, *(x.select(t.index(c), k) if c in t else x
                  for t, x in zip(terms, operands)))
        for k in range(n)])


def _pair_vvvv(QA, QB, QE, QF, Evvvv):
    """out[p, a, b, e, f] = QA[p, v, a] QB[p, w, b] <vw|xy> QE[p, x, e]
    QF[p, y, f], one pair at a time: the live intermediate is D nv^3."""
    out = []
    for qa, qb, qe, qf in zip(QA, QB, QE, QF):
        A = C("va,vwxy->awxy", qa, Evvvv)
        A = C("wb,awxy->abxy", qb, A)
        A = C("xe,abxy->abey", qe, A)
        out.append(C("yf,abey->abef", qf, A))
    return torch.stack(out)


def precompute_ccd(H, Local, no, nv):
    """Iteration-independent transformed-integral stacks."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    Sr = Local.Sp.reshape(no, no, no, no, D, D)
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]

    pre = {}
    pre["QLr"] = QLr
    pre["Sr"] = Sr
    pre["F_oo"] = H.F[o, o]
    pre["ERI_oooo"] = H.ERI[o, o, o, o]
    # local Fock vv blocks
    pre["Fvv"] = C("ijva,vw,ijwb->ijab", QLr, H.F[v, v], QLr)
    # Fae tail: QL[ij]^T L[mn] QL[mn]
    pre["TL"] = C("mnvw,mnwx,ijva->ijmnax", L4, QLr, QLr)
    # Fmi tail: (QL[jn]^T L[mn] QL[jn]) rows m
    pre["BL"] = C("jnva,mnvw,jnwb->jnmab", QLr, L4, QLr)
    # Wmnij tail + r2 seed: QL[ij]^T ERI[mn] QL[ij]
    pre["BE"] = C("ijva,mnvw,ijwb->ijmnab", QLr, E4, QLr)
    # Wmbej/Wmbje/Wmbie one-electron-like heads
    pre["W1"] = C("ijvb,mvwj,imwe->ijmbe", QLr, H.ERI[o, v, v, o], QLr)
    pre["W1je"] = C("ijvb,mvjw,imwe->ijmbe", QLr, H.ERI[o, v, o, v], QLr)
    pre["W1ie"] = C("ijvb,mviw,mjwe->ijmbe", QLr, H.ERI[o, v, o, v], QLr)
    # cross-pair transformed oovv blocks
    pre["XE"] = C("imve,mnvw,jnwf->imjnef", QLr, E4, QLr)
    pre["XL"] = C("imve,mnvw,njwf->imnjef", QLr, L4, QLr)
    pre["XE2"] = C("jnvf,mnvw,imwe->jnmife", QLr, E4, QLr)
    pre["XE3"] = C("invf,mnvw,mjwe->inmjfe", QLr, E4, QLr)
    # pair-local vvvv block
    Qf = QLr.reshape(no * no, nv, D)
    pre["VV"] = _pair_vvvv(Qf, Qf, Qf, Qf, H.vvvv).reshape(no, no, D, D,
                                                           D, D)
    # energy block: QL[ij]^T L[ij] QL[ij]
    pre["Ldiag"] = C("ijva,ijvw,ijwb->ijab", QLr, L4, QLr)
    # diagonal overlap gathers
    pre["Sijjn"] = torch.einsum("ijjnby->ijnby", Sr)
    pre["Sijnj"] = torch.einsum("ijnjby->ijnby", Sr)
    pre["Sijim"] = torch.einsum("ijimby->ijmby", Sr)
    pre["Sijin"] = torch.einsum("ijinby->ijnby", Sr)
    pre["Sijmj"] = torch.einsum("ijmjby->ijmby", Sr)
    return pre


def residuals_ccd_local(pre, t2r):
    """r2 (no,no,D,D) from local CCD equations; t2r is (no,no,D,D)."""
    Sr = pre["Sr"]
    t2s = t2r - t2r.swapaxes(2, 3)

    # Fae
    ST = C("ijmnax,mnxy->ijmnay", Sr, t2r, keep=True)
    Fae = dense(pre["Fvv"]) - C("ijmnay,ijmney->ijae", ST, pre["TL"])
    # Fmi
    Fmi = pre["F_oo"] + C("jnab,jnmab->mj", t2r, pre["BL"])
    # Wmnij
    Wmnij = pre["ERI_oooo"] + C("ijef,ijmnef->mnij", t2r, pre["BE"])
    # Wmbej
    G = C("ijnby,jnfy->ijnbf", pre["Sijjn"], t2r)
    Wmbej = dense(pre["W1"]) - 0.5 * C("ijnbf,imjnef->ijmbe", G, pre["XE"])
    G = C("ijnby,njfy->ijnbf", pre["Sijnj"], t2r)
    Wmbej = Wmbej + 0.5 * C("ijnbf,imnjef->ijmbe", G, pre["XL"])
    # Wmbje
    G = C("ijnby,jnxy->ijnbx", pre["Sijjn"], t2r)
    Wmbje = -dense(pre["W1je"]) + 0.5 * C("ijnbx,jnmixe->ijmbe", G,
                                          pre["XE2"])
    # Wmbie
    G = C("ijnby,inxy->ijnbx", pre["Sijin"], t2r)
    Wmbie = -dense(pre["W1ie"]) + 0.5 * C("ijnbx,inmjxe->ijmbe", G,
                                          pre["XE3"])

    # r_T2
    r2 = 0.5 * C("ijijab->ijab", pre["BE"])
    r2 = r2 + C("ijae,ijbe->ijab", t2r, Fae)
    r2 = r2 + 0.5 * C("ijef,ijabef->ijab", t2r, pre["VV"])
    D3 = C("ijmax,imxy,ijmby->ijmab", pre["Sijim"], t2r, pre["Sijim"])
    r2 = r2 - C("ijmab,mj->ijab", D3, Fmi)
    D5 = C("ijmax,imxe->ijmae", pre["Sijim"], t2s)
    r2 = r2 + C("ijmae,ijmbe->ijab", D5, Wmbej)
    D6 = C("ijmax,imxe->ijmae", pre["Sijim"], t2r)
    r2 = r2 + C("ijmae,ijmbe->ijab", D6, Wmbej + Wmbje)
    D7 = C("ijmax,mjxe->ijmae", pre["Sijmj"], t2r)
    r2 = r2 + C("ijmae,ijmbe->ijab", D7, Wmbie)
    D8 = C("ijmnay,mnyx,ijmnbx->ijmnab", Sr, t2r, Sr, keep=True)
    r2 = r2 + 0.5 * C("ijmnab,mnij->ijab", D8, Wmnij)

    return r2 + r2.permute(1, 0, 3, 2)


def energy_ccd_local(pre, t2r):
    return C("ijab,ijab->", t2r, pre["Ldiag"])


# ---------------------------------------------------------------------------
# CCSD (local-scaling, padded-batched)
# ---------------------------------------------------------------------------

def precompute_ccsd(H, Local, no, nv):
    """Iteration-independent transformed-integral stacks for local CCSD."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    QLd = torch.einsum("iiva->iva", QLr)  # diagonal-pair transforms QL[ii]
    Sr = Local.Sp.reshape(no, no, no, no, D, D)
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]
    Eovvv = H.ERI[o, v, v, v]
    Fov = H.F[o, v]
    R = _rows

    pre = precompute_ccd(H, Local, no, nv)
    pre["QLd"] = QLd
    pre["Fov_loc"] = C("mv,ijve->ijme", Fov, QLr)     # F[o,v] QL[ij]
    pre["Fov_ii"] = C("iv,iva->ia", Fov, QLd)
    pre["FovD"] = C("mv,jve->jme", Fov, QLd)          # pair jj rows
    # Fae singles tails
    pre["TLm"] = R("mvwz,mwb,ijva,ijzc->ijmabc", H.L[o, v, v, v], QLd,
                   QLr, QLr)
    pre["TLnn"] = C("mnvw,nwf,ijve->ijmnef", L4, QLd, QLr)
    # Fmi singles tails
    pre["LooovD"] = C("mnjv,nve->mnje", H.L[o, o, o, v], QLd)
    pre["TL2"] = C("mnvw,nwf,jve->mnjef", L4, QLd, QLd)
    # Wmnij singles tails
    pre["EooovD"] = C("mniv,jve->mnije", H.ERI[o, o, o, v], QLd)
    pre["EoovoD"] = C("mnvj,ive->mnije", H.ERI[o, o, v, o], QLd)
    pre["TE2"] = C("mnvw,ive,jwf->mnijef", E4, QLd, QLd)
    # Zmbij
    pre["EovvvP"] = R("ijvb,ijwe,mvwz,ijzf->ijmbef", QLr, QLr, Eovvv, QLr)
    pre["Eovvv_iijj"] = R("iwe,mvwz,ijvb,jzf->ijmbef", QLd, Eovvv, QLr, QLd)
    # Wmbej singles tails
    pre["TE_mbe"] = R("imwe,mvwz,ijvb,jzf->ijmbef", QLr, Eovvv, QLr, QLd)
    pre["Eoovo_loc"] = C("mnvj,imve->ijmne", H.ERI[o, o, v, o], QLr)
    pre["XEjj"] = C("imve,mnvw,jwf->ijmnef", QLr, E4, QLd)
    # Wmbje/Wmbie singles tails
    pre["TE_bFe"] = R("imze,mvwz,ijvb,jwf->ijmbfe", QLr, Eovvv, QLr, QLd)
    pre["Eooov_loc"] = C("mnjv,imve->ijmne", H.ERI[o, o, o, v], QLr)
    pre["XE5"] = C("jvf,mnvw,imwe->ijmnfe", QLd, E4, QLr)
    pre["TE_bFe_mj"] = R("iwf,mvwz,ijvb,mjze->ijmbfe", QLd, Eovvv, QLr, QLr)
    pre["Eooov_mj"] = C("mniv,mjve->ijmne", H.ERI[o, o, o, v], QLr)
    pre["XE6"] = C("ivf,mnvw,mjwe->ijmnfe", QLd, E4, QLr)
    # r_T1 pieces
    pre["Eovvv_mi"] = R("iva,mvwz,miwe,mizf->imaef", QLd, Eovvv, QLr, QLr)
    pre["Lnvvi"] = C("nvwi,iva,nwf->inaf", H.L[o, v, v, o], QLd, QLd)
    pre["LoovoD"] = C("nmvi,mnve->mnie", H.L[o, o, v, o], QLr)
    # r_T2 pieces
    Qf = QLr.reshape(no * no, nv, D)
    Qi = QLd[:, None].expand(no, no, nv, D).reshape(no * no, nv, D)
    Qj = QLd[None, :].expand(no, no, nv, D).reshape(no * no, nv, D)
    pre["VV2"] = _pair_vvvv(Qf, Qf, Qi, Qj, H.vvvv).reshape(no, no, D, D,
                                                            D, D)
    pre["Evvvo_loc"] = R("ijva,vwzj,ijwb,ize->ijabe", QLr,
                         H.ERI[v, v, v, o], QLr, QLd)
    pre["E9"] = C("mvwj,ijva,iwe->ijmae", H.ERI[o, v, v, o], QLr, QLd)
    pre["E11"] = C("mvjw,ijva,iwe->ijmae", H.ERI[o, v, o, v], QLr, QLd)
    pre["Eovoo_loc"] = C("mvij,ijvb->ijmb", H.ERI[o, v, o, o], QLr)
    # energy singles block
    pre["LdiagX"] = C("ijvw,iva,jwb->ijab", L4, QLd, QLd)
    # extra diagonal overlap gathers
    pre["Sijmm"] = torch.einsum("ijmmax->ijmax", Sr)
    pre["Sijnn"] = pre["Sijmm"]
    pre["Siimm"] = torch.einsum("iimmax->imax", Sr)
    pre["Siiim"] = torch.einsum("iiimax->imax", Sr)
    pre["Siimn"] = torch.einsum("iimnax->imnax", Sr)
    return pre


def _singles_intermediates(pre, t1loc, t2r, Sb_t1mm):
    """Fae, Fmi and Fme of the CCSD singles (shared with CC2)."""
    Sr = pre["Sr"]
    ST = C("ijmnax,mnxy->ijmnay", Sr, t2r, keep=True)
    Fae = dense(pre["Fvv"]) - C("ijmnay,ijmney->ijae", ST, pre["TL"])
    Fae = Fae - 0.5 * C("ijma,ijme->ijae", Sb_t1mm, pre["Fov_loc"])
    Fae = Fae + C("mb,ijmabe->ijae", t1loc, pre["TLm"])
    Fae = Fae - 0.5 * C("nf,ijmnef,ijma->ijae", t1loc, pre["TLnn"], Sb_t1mm)

    Fmi = pre["F_oo"] + C("jnab,jnmab->mj", t2r, pre["BL"])
    Fmi = Fmi + 0.5 * C("je,jme->mj", t1loc, pre["FovD"])
    Fmi = Fmi + C("ne,mnje->mj", t1loc, pre["LooovD"])
    Fmi = Fmi + 0.5 * C("nf,mnjef,je->mj", t1loc, pre["TL2"], t1loc)

    Fme = dense(pre["Fov_loc"]) + C("nf,ijmnef->ijme", t1loc, pre["TLnn"])
    return Fae, Fmi, Fme


def _r_T1(pre, t1loc, t2r, Fae, Fmi, Fme):
    t2s2 = 2.0 * t2r - t2r.swapaxes(2, 3)
    Fme_im = torch.einsum("imme->ime", Fme)
    Fae_ii = torch.einsum("iiae->iae", Fae)
    r1 = pre["Fov_ii"] + C("ie,iae->ia", t1loc, Fae_ii)
    St1_iimm = C("imax,mx->ima", pre["Siimm"], t1loc)
    r1 = r1 - C("ima,mi->ia", St1_iimm, Fmi)
    T1a = C("imax,imxe->imae", pre["Siiim"], t2s2)
    r1 = r1 + C("imae,ime->ia", T1a, Fme_im)
    r1 = r1 + C("imaef,mief->ia", pre["Eovvv_mi"], t2s2)
    r1 = r1 + C("nf,inaf->ia", t1loc, pre["Lnvvi"])
    ST1 = C("imnax,mnxe->imnae", pre["Siimn"], t2r)
    return r1 - C("imnae,mnie->ia", ST1, pre["LoovoD"])


def residuals_ccsd_local(pre, t1loc, t2r):
    """(r1 (no,D), r2 (no,no,D,D)) from the local CCSD equations."""
    Sr = pre["Sr"]
    t2s = t2r - t2r.swapaxes(2, 3)

    Sb_t1mm = C("ijmbx,mx->ijmb", pre["Sijmm"], t1loc)
    Sb_t1nn = C("ijnbx,nx->ijnb", pre["Sijnn"], t1loc)

    Fae, Fmi, Fme = _singles_intermediates(pre, t1loc, t2r, Sb_t1mm)
    FmeD = torch.einsum("jjme->jme", Fme)

    # ---- Wmnij
    Wmnij = pre["ERI_oooo"] + C("ijef,ijmnef->mnij", t2r, pre["BE"])
    Wmnij = Wmnij + C("je,mnije->mnij", t1loc, pre["EooovD"])
    Wmnij = Wmnij + C("ie,mnije->mnij", t1loc, pre["EoovoD"])
    Wmnij = Wmnij + C("ie,jf,mnijef->mnij", t1loc, t1loc, pre["TE2"])

    # ---- Zmbij
    Zmb = C("ijef,ijmbef->ijmb", t2r, pre["EovvvP"])
    Zmb = Zmb + C("ie,jf,ijmbef->ijmb", t1loc, t1loc, pre["Eovvv_iijj"])

    # ---- Wmbej
    G = C("ijnby,jnfy->ijnbf", pre["Sijjn"], t2r)
    Wmbej = dense(pre["W1"]) - 0.5 * C("ijnbf,imjnef->ijmbe", G, pre["XE"])
    Gn = C("ijnby,njfy->ijnbf", pre["Sijnj"], t2r)
    Wmbej = Wmbej + 0.5 * C("ijnbf,imnjef->ijmbe", Gn, pre["XL"])
    Wmbej = Wmbej + C("jf,ijmbef->ijmbe", t1loc, pre["TE_mbe"])
    Wmbej = Wmbej - C("ijnb,ijmne->ijmbe", Sb_t1nn, pre["Eoovo_loc"])
    Wmbej = Wmbej - C("jf,ijnb,ijmnef->ijmbe", t1loc, Sb_t1nn, pre["XEjj"])

    # ---- Wmbje
    G = C("ijnby,jnxy->ijnbx", pre["Sijjn"], t2r)
    Wmbje = -dense(pre["W1je"]) + 0.5 * C("ijnbx,jnmixe->ijmbe", G,
                                          pre["XE2"])
    Wmbje = Wmbje - C("jf,ijmbfe->ijmbe", t1loc, pre["TE_bFe"])
    Wmbje = Wmbje + C("ijnb,ijmne->ijmbe", Sb_t1nn, pre["Eooov_loc"])
    Wmbje = Wmbje + C("jf,ijnb,ijmnfe->ijmbe", t1loc, Sb_t1nn, pre["XE5"])

    # ---- Wmbie
    G = C("ijnby,inxy->ijnbx", pre["Sijin"], t2r)
    Wmbie = -dense(pre["W1ie"]) + 0.5 * C("ijnbx,inmjxe->ijmbe", G,
                                          pre["XE3"])
    Wmbie = Wmbie - C("if,ijmbfe->ijmbe", t1loc, pre["TE_bFe_mj"])
    Wmbie = Wmbie + C("ijnb,ijmne->ijmbe", Sb_t1nn, pre["Eooov_mj"])
    Wmbie = Wmbie + C("if,ijnb,ijmnfe->ijmbe", t1loc, Sb_t1nn, pre["XE6"])

    r1 = _r_T1(pre, t1loc, t2r, Fae, Fmi, Fme)

    # ---- r_T2
    r2 = 0.5 * C("ijijab->ijab", pre["BE"])
    r2 = r2 + C("ijae,ijbe->ijab", t2r, Fae)
    r2 = r2 + 0.5 * C("ijef,ijabef->ijab", t2r, pre["VV"])
    r2 = r2 + 0.5 * C("ie,jf,ijabef->ijab", t1loc, t1loc, pre["VV2"])
    r2 = r2 + C("ie,ijabe->ijab", t1loc, pre["Evvvo_loc"])
    r2 = r2 - 0.5 * C("ijmb,ijme,ijae->ijab", Sb_t1mm, Fme, t2r)
    D3 = C("ijmax,imxy,ijmby->ijmab", pre["Sijim"], t2r, pre["Sijim"])
    r2 = r2 - C("ijmab,mj->ijab", D3, Fmi)
    s4 = C("je,jme->jm", t1loc, FmeD)
    r2 = r2 - 0.5 * C("ijmab,jm->ijab", D3, s4)
    r2 = r2 - C("ijma,ijmb->ijab", Sb_t1mm, Zmb)
    D5 = C("ijmax,imxe->ijmae", pre["Sijim"], t2s)
    r2 = r2 + C("ijmae,ijmbe->ijab", D5, Wmbej)
    D6 = C("ijmax,imxe->ijmae", pre["Sijim"], t2r)
    r2 = r2 + C("ijmae,ijmbe->ijab", D6, Wmbej + Wmbje)
    D7 = C("ijmax,mjxe->ijmae", pre["Sijmj"], t2r)
    r2 = r2 + C("ijmae,ijmbe->ijab", D7, Wmbie)
    r2 = r2 - C("ie,ijmbe,ijma->ijab", t1loc, pre["E9"], Sb_t1mm)
    r2 = r2 - C("ijmae,ie,ijmb->ijab", pre["E11"], t1loc, Sb_t1mm)
    r2 = r2 - C("ijma,ijmb->ijab", Sb_t1mm, pre["Eovoo_loc"])
    D8 = C("ijmnay,mnyx,ijmnbx->ijmnab", Sr, t2r, Sr, keep=True)
    r2 = r2 + 0.5 * C("ijmnab,mnij->ijab", D8, Wmnij)
    r2 = r2 + 0.5 * C("ijma,mnij,ijnb->ijab", Sb_t1mm, Wmnij, Sb_t1nn)

    return r1, r2 + r2.permute(1, 0, 3, 2)


def residuals_cc2_local(pre, t1loc, t2r):
    """(r1, r2) from the local CC2 equations (pair-space,
    overlap-stitched), pycc_tpu's: r1 is the full CCSD singles equation
    (CC2's singles are untruncated); r2 keeps only the bare-Fock doubles
    coupling plus T1-dressed integrals."""
    Sb_t1mm = C("ijmbx,mx->ijmb", pre["Sijmm"], t1loc)
    Sb_t1nn = C("ijnbx,nx->ijnb", pre["Sijnn"], t1loc)

    Fae, Fmi, Fme = _singles_intermediates(pre, t1loc, t2r, Sb_t1mm)
    r1 = _r_T1(pre, t1loc, t2r, Fae, Fmi, Fme)

    # ---- CC2 doubles: bare Fock coupling + T1-dressed integrals;
    # the effective fae/fmi fold the two canonical 0.5-halves into one
    fae = dense(pre["Fvv"]) - C("ijmb,ijme->ijbe", Sb_t1mm, pre["Fov_loc"])
    fmi = pre["F_oo"] + C("je,jme->mj", t1loc, pre["FovD"])

    Wmnij = pre["ERI_oooo"]
    Wmnij = Wmnij + C("je,mnije->mnij", t1loc, pre["EooovD"])
    Wmnij = Wmnij + C("ie,mnije->mnij", t1loc, pre["EoovoD"])
    Wmnij = Wmnij + C("ie,jf,mnijef->mnij", t1loc, t1loc, pre["TE2"])

    Zmb = C("ie,jf,ijmbef->ijmb", t1loc, t1loc, pre["Eovvv_iijj"])

    r2 = 0.5 * C("ijijab->ijab", pre["BE"])
    r2 = r2 + C("ijae,ijbe->ijab", t2r, fae)
    D3 = C("ijmax,imxy,ijmby->ijmab", pre["Sijim"], t2r, pre["Sijim"])
    r2 = r2 - C("ijmab,mj->ijab", D3, fmi)
    r2 = r2 + 0.5 * C("ijma,mnij,ijnb->ijab", Sb_t1mm, Wmnij, Sb_t1nn)
    r2 = r2 + 0.5 * C("ie,jf,ijabef->ijab", t1loc, t1loc, pre["VV2"])
    r2 = r2 - C("ijma,ijmb->ijab", Sb_t1mm, Zmb)
    r2 = r2 - C("ie,ijmbe,ijma->ijab", t1loc, pre["E9"], Sb_t1mm)
    r2 = r2 - C("ijmae,ie,ijmb->ijab", pre["E11"], t1loc, Sb_t1mm)
    r2 = r2 + C("ie,ijabe->ijab", t1loc, pre["Evvvo_loc"])
    r2 = r2 - C("ijma,ijmb->ijab", Sb_t1mm, pre["Eovoo_loc"])

    return r1, r2 + r2.permute(1, 0, 3, 2)


def energy_ccsd_local(pre, t1loc, t2r):
    e = 2.0 * C("ia,ia->", pre["Fov_ii"], t1loc)
    e = e + C("ijab,ijab->", t2r, pre["Ldiag"])
    return e + C("ia,ijab,jb->", t1loc, pre["LdiagX"], t1loc)
