"""Pair-screened local CCD/CCSD: compact strong-pair stacks.

The counterpart of pycc_tpu/lccwfn_screened.py.  The padded-batch local
equations (lccwfn_local.py) hold pair-pair stacks of shape (no, no, no,
no, D, D): no^4 D^2 memory.  Here every pair-pair quantity lives over a
compact strong-pair list: pairs whose local-MP2 pair energy is below
`pair_cutoff` are frozen at their MP2 amplitudes and left out of both
sides of every stack, so memory scales as P^2 D^2 + P no D^2 with P the
number of strong pairs, and pair_cutoff = 0 (every pair strong) gives
exactly the unscreened equations.

The residual keeps the (no, no, D, D) amplitude layout: weak-pair rows of
the returned residual are zero, so the Jacobi update never moves them off
their MP2 values, and the energy picks up their frozen local-MP2
contribution.  pycc_tpu's `jax.lax.map` scans (over pairs for the
ladders, over rows for the cross blocks, over m in the residual) are
Python loops over the same slices here, which bound the live
intermediates the same way.

Over a device mesh the compact stacks are `parallel.Sharded` over 'va'
on their leading strong-pair axis (the (no, no)-leading ones over ('va',
'vb'), `parallel.mesh.shard_pair_stacks`): a contraction reads them
piece by piece (`contract_pieces`, C here), a cross-pair gather through
`take`, and a stack added whole to a term is read whole once a call
(`dense`).  Without a mesh each of these is the plain operation.
"""

import numpy as np
import torch

from .lccwfn_local import _pair_vvvv
from .parallel.mesh import contract_pieces as C
from .parallel.mesh import dense, take


def mp2_pair_energies(H, Local, no, nv):
    """Local-MP2 pair energies e_ij (host numpy, (no, no)) from the padded
    PNO stacks."""
    o, v = slice(0, no), slice(no, None)
    QLp = Local.QLp
    E4 = H.ERI[o, o, v, v].reshape(no * no, nv, nv)
    L4 = H.L[o, o, v, v].reshape(no * no, nv, nv)
    eri_loc = QLp.mT @ E4 @ QLp
    L_loc = QLp.mT @ L4 @ QLp
    t2 = eri_loc / Local._D2p
    e = C("pab,pab->p", t2, L_loc)
    return e.reshape(no, no).cpu().numpy()


def screen_pairs(H, Local, no, nv, pair_cutoff):
    """Strong-pair index tensors (pidx (no, no), pi, pj (P,)) on the
    device.  Diagonal pairs are always strong, and the list is
    (i,j)<->(j,i) symmetric so the pair transpose stays inside it."""
    e_ij = np.abs(mp2_pair_energies(H, Local, no, nv))
    strong = (e_ij >= pair_cutoff) | (e_ij.T >= pair_cutoff)
    np.fill_diagonal(strong, True)
    pi, pj = np.nonzero(strong)
    pidx = -np.ones((no, no), dtype=np.int64)
    pidx[pi, pj] = np.arange(len(pi))
    dev = Local.QLp.device
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=dev)
                 for x in (pidx, pi, pj))


def _safe(idx):
    """(idx with the weak slots -1 pointed at 0, the mask of strong ones)."""
    return idx.clamp(min=0), idx >= 0


def precompute_ccd_screened(H, Local, no, nv, pair_cutoff=0.0):
    """Compact strong-pair transformed-integral stacks (CCD).

    Every tensor of lccwfn_local.precompute_ccd reappears here gathered
    to the strong-pair list: (P, P, D, D) for pair-pair couplings and
    (P, no, D, D) for the per-m W heads."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    pidx, pi, pj = screen_pairs(H, Local, no, nv, pair_cutoff)
    P = int(pi.shape[0])
    QLg = QLr[pi, pj]                       # (P, nv, D)
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]
    E4g = E4[pi, pj]                        # (P, nv, nv) block of pair q
    L4g = L4[pi, pj]

    pre = {"pidx": pidx, "pi": pi, "pj": pj, "P": P, "no": no, "D": D}
    pre["F_oo"] = H.F[o, o]
    # ERI_oooo gathered on both pair axes: [q, p] = <m n | i j>
    pre["ERI_oooo_g"] = _oooo_gather(H.ERI[o, o, o, o], pi, pj)
    pre["Fvv"] = QLg.mT @ H.F[v, v] @ QLg
    pre["Sg"] = C("pva,qvb->pqab", QLg, QLg)
    # TL[p,q,a,x] = QL[p]^T L4[q-block] QL[q]
    half = L4g @ QLg
    pre["TLg"] = C("pva,qvx->pqax", QLg, half)
    # BE[p,q,a,b] = QL[p]^T E4[q-block] QL[p]
    pre["BEg"] = C("pva,qvw,pwb->pqab", QLg, E4g, QLg)
    # BL[q=(j,n), m, a, b] = QL[q]^T L4[m, n] QL[q]
    L4_n = L4[:, pj]                        # (no_m, P, nv, nv)
    pre["BLg"] = C("qva,mqvw,qwb->qmab", QLg, L4_n, QLg)
    # W heads (p=(i,j), m): QL[im] per (p, m)
    idx_im = pidx[pi]                       # [p, m] -> pair (i, m)
    im_safe, mask_im = _safe(idx_im)
    QLim = QLg[im_safe] * mask_im[:, :, None, None]    # (P, no, nv, D)
    ERIovvo_j = H.ERI[o, v, v, o][:, :, :, pj]         # (no_m, nv, nv, P)
    pre["W1g"] = C("pvb,mvwp,pmwe->pmbe", QLg, ERIovvo_j, QLim)
    ERIovov_j = H.ERI[o, v, o, v][:, :, pj]            # (no_m, nv, P, nv)
    pre["W1jeg"] = C("pvb,mvpw,pmwe->pmbe", QLg, ERIovov_j, QLim)
    # W1ie[ij,m,b,e] = QL[ij,vb] ERI[ovov][m,v,i,w] QL[mj,we]
    idx_mj = pidx[:, pj].T                             # [p, m] -> (m, j)
    mj_safe, mask_mj = _safe(idx_mj)
    QLmj = QLg[mj_safe] * mask_mj[:, :, None, None]
    ERIovov_i = H.ERI[o, v, o, v][:, :, pi]            # (no_m, nv, P, nv)
    pre["W1ieg"] = C("pvb,mvpw,pmwe->pmbe", QLg, ERIovov_i, QLmj)
    # cross-pair oovv blocks over (row r, col s) pair axes:
    #   XE[r=(i,m), s=(j,n)] = QL[r]^T E4[m, n] QL[s]
    pre["XEg"] = _cross_block(QLg, E4, pj, pj, QLg)
    #   XL[r=(i,m), s=(n,j)] = QL[r]^T L4[m, n] QL[s]
    pre["XLg"] = _cross_block(QLg, L4, pj, pi, QLg)
    #   XE2[r=(j,n), s=(i,m)] = QL[r]^T E4[m, n] QL[s]
    pre["XE2g"] = _cross_block(QLg, E4.swapaxes(0, 1), pj, pj, QLg)
    #   XE3[r=(i,n), s=(m,j)] = QL[r]^T E4[n, m] QL[s]
    pre["XE3g"] = _cross_block(QLg, E4.swapaxes(0, 1), pj, pi, QLg)
    # pair-local vvvv block, one pair at a time
    pre["VVg"] = _pair_vvvv(QLg, QLg, QLg, QLg, H.vvvv)
    pre["idx_im"], pre["mask_im"] = idx_im, mask_im
    pre["idx_mj"], pre["mask_mj"] = idx_mj, mask_mj
    # transpose map p -> (j,i) slot (always present; the list is symmetric)
    pre["ptrans"] = pidx[pj, pi]
    # energy block over the full pair layout (no^2 D^2): weak pairs then
    # contribute their frozen local-MP2 energy
    QLf = Local.QLp
    pre["Ldiag_full"] = (QLf.mT @ L4.reshape(no * no, nv, nv) @ QLf) \
        .reshape(no, no, D, D)
    return pre


def energy_ccd_screened(pre, t2r):
    return C("ijab,ijab->", t2r, pre["Ldiag_full"])


def precompute_ccsd_screened(H, Local, no, nv, pair_cutoff=0.0):
    """Compact strong-pair stacks for local CCSD (singles-dressed).

    Extends precompute_ccd_screened with the singles tails of
    lccwfn_local.precompute_ccsd, every pair-pair tensor gathered to the
    strong list: (P, no, ...) for per-m heads, (Q, P, ...) for the Wmnij
    couplings, (P, D, D, D[, D]) for the pair-local ladders.  Diagonal
    pairs are always strong, so the QLd transforms are plain gathers."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    pre = precompute_ccd_screened(H, Local, no, nv, pair_cutoff)
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    QLg = QLr[pi, pj]
    rng = torch.arange(no, device=pi.device)
    diag = pidx[rng, rng]                    # always >= 0
    QLd = QLg[diag]                          # (no, nv, D)
    QLd_pi, QLd_pj = QLd[pi], QLd[pj]
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]
    Eovvv = H.ERI[o, v, v, v]
    Eooov = H.ERI[o, o, o, v]
    Eoovo = H.ERI[o, o, v, o]
    Fov = H.F[o, v]

    im_safe, mask_im = _safe(pre["idx_im"])     # [p, m] -> (i, m)
    mj_safe, mask_mj = _safe(pre["idx_mj"])     # [p, m] -> (m, j)
    QLim = QLg[im_safe] * mask_im[:, :, None, None]
    QLmj = QLg[mj_safe] * mask_mj[:, :, None, None]

    pre["diag"] = diag
    Sg = pre["Sg"]
    pre["Sdiag_g"] = Sg[:, diag]                        # S(p, (m,m))
    pre["Siimm"] = Sg[diag][:, diag]                    # S((i,i),(m,m))
    safe_f, mask_f = _safe(pidx)
    # S((i,i),(i,m)) over the full (i, m) grid, weak (i,m) masked
    pre["Siiim"] = Sg[diag][rng[:, None], safe_f] \
        * mask_f[:, :, None, None]

    pre["Fov_g"] = C("mv,pve->pme", Fov, QLg)
    pre["Fov_ii"] = C("iv,iva->ia", Fov, QLd)
    pre["FovD"] = C("mv,jve->jme", Fov, QLd)
    # Fae singles tails
    pre["TLm_g"] = C("mvwz,mwb,pva,pzc->pmabc", H.L[o, v, v, v], QLd, QLg, QLg)
    pre["TLnn_g"] = C("mnvw,nwf,pve->pmnef", L4, QLd, QLg)
    # Fmi singles tails (full occupied layout)
    pre["LooovD"] = C("mnjv,nve->mnje", H.L[o, o, o, v], QLd)
    pre["TL2"] = C("mnvw,nwf,jve->mnjef", L4, QLd, QLd)
    # Wmnij singles tails, both pair axes strong: [q=(m,n), p=(i,j)]
    A = Eooov[pi[:, None], pj[:, None], pi[None, :]]    # (Q, P, nv)
    pre["EooovD_g"] = C("qpv,pve->qpe", A, QLd_pj)
    A = Eoovo.swapaxes(2, 3)[pi[:, None], pj[:, None], pj[None, :]]
    pre["EoovoD_g"] = C("qpv,pve->qpe", A, QLd_pi)
    E4q = E4[pi, pj]
    pre["TE2_g"] = C("qvw,pve,pwf->qpef", E4q, QLd_pi, QLd_pj)
    # Zmbij tails
    pre["EovvvP_g"] = C("pvb,pwe,mvwz,pzf->pmbef", QLg, QLg, Eovvv, QLg)
    pre["Eovvv_iijj_g"] = C("pvb,pwe,mvwz,pzf->pmbef", QLg, QLd_pi, Eovvv,
                            QLd_pj)
    # Wmbej singles tails
    pre["TE_mbe_g"] = C("pvb,pzf,mvwz,pmwe->pmbef", QLg, QLd_pj, Eovvv, QLim)
    B = torch.movedim(Eoovo, 3, 0)[pj]                  # (P, no_m, no_n, nv)
    pre["Eoovo_g"] = C("pmnv,pmve->pmne", B, QLim)
    pre["XEjj_g"] = C("pmve,mnvw,pwf->pmnef", QLim, E4, QLd_pj)
    # Wmbje singles tails
    pre["TE_bFe_g"] = C("pvb,pwf,mvwz,pmze->pmbfe", QLg, QLd_pj, Eovvv, QLim)
    B = torch.movedim(Eooov, 2, 0)[pj]
    pre["Eooov_g"] = C("pmnv,pmve->pmne", B, QLim)
    pre["XE5_g"] = C("pvf,mnvw,pmwe->pmnfe", QLd_pj, E4, QLim)
    # Wmbie singles tails
    pre["TE_bFe_mj_g"] = C("pvb,pwf,mvwz,pmze->pmbfe", QLg, QLd_pi, Eovvv,
                           QLmj)
    B = torch.movedim(Eooov, 2, 0)[pi]
    pre["Eooov_mj_g"] = C("pmnv,pmve->pmne", B, QLmj)
    pre["XE6_g"] = C("pvf,mnvw,pmwe->pmnfe", QLd_pi, E4, QLmj)
    # r_T1 pieces (full occupied layouts; weak (m,i) pairs masked)
    QLmi_f = QLg[safe_f.T] * mask_f.T[:, :, None, None]     # [m, i] -> (m,i)
    QLmi_f = QLmi_f.swapaxes(0, 1)                          # [i, m]
    pre["Eovvv_mi"] = C("mvwz,iva,imwe,imzf->imaef", Eovvv, QLd, QLmi_f,
                        QLmi_f)
    pre["Lnvvi"] = C("nvwi,iva,nwf->inaf", H.L[o, v, v, o], QLd, QLd)
    A = H.L[o, o, v, o][pj, pi]                         # L[n, m, v, i] at q
    pre["LoovoD_g"] = C("qvi,qve->qie", A, QLg)
    # r_T2 pieces: pair-local ladders one pair at a time
    pre["VV2_g"] = _pair_vvvv(QLg, QLg, QLd_pi, QLd_pj, H.vvvv)
    Evvvo = H.ERI[v, v, v, o]
    pre["Evvvo_g"] = torch.stack([
        C("ze,abz->abe", qi,
                 C("wb,awz->abz", q,
                          C("va,vwz->awz", q, Evvvo[:, :, :, j])))
        for q, qi, j in zip(QLg, QLd_pi, pj.tolist())])
    B = torch.movedim(H.ERI[o, v, v, o], 3, 0)[pj]      # (P, no_m, nv, nv)
    pre["E9_g"] = C("pmvw,pva,pwe->pmae", B, QLg, QLd_pi)
    B = torch.movedim(H.ERI[o, v, o, v], 2, 0)[pj]
    pre["E11_g"] = C("pmvw,pva,pwe->pmae", B, QLg, QLd_pi)
    B = torch.movedim(H.ERI[o, v, o, o], (2, 3), (0, 1))[pi, pj]
    pre["Eovoo_g"] = C("pmv,pvb->pmb", B, QLg)
    # energy singles block (full layout)
    pre["LdiagX"] = C("ijvw,iva,jwb->ijab", L4, QLd, QLd)
    return pre


def energy_ccsd_screened(pre, t1loc, t2r):
    e = 2.0 * C("ia,ia->", pre["Fov_ii"], t1loc)
    e = e + C("ijab,ijab->", t2r, pre["Ldiag_full"])
    return e + C("ia,ijab,jb->", t1loc, pre["LdiagX"], t1loc)


def _oooo_gather(Eoooo, pi, pj):
    """<pi[q] pj[q] | pi[p] pj[p]> -> (Q, P)."""
    return Eoooo[pi[:, None], pj[:, None], pi[None, :], pj[None, :]]


def _cross_block(QLrow, E4, row_k, col_k, QLcol):
    """A[r, s, e, f] = QLrow[r,v,e] E4[row_k[r], col_k[s], v, w]
    QLcol[s,w,f]: the generic (P, P, D, D) cross-pair transformed block,
    one row at a time to bound the live gather to (P, nv, nv)."""
    rows = []
    for qr, kr in zip(QLrow, row_k.tolist()):
        h = E4[kr][col_k] @ QLcol           # (P, nv, D)
        rows.append(qr.mT @ h)              # (P, D, D)
    return torch.stack(rows)


def _gathers(pre, t2c, t2sc):
    """The per-(p, n) gathers both residuals read: index maps and masks
    of the pairs (i,m), (m,j), (j,n), (n,j), (i,n) of each strong p, the
    overlaps S[p, that pair] and the amplitudes of that pair."""
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    Sg = pre["Sg"]
    g = {}
    g["im"] = _safe(pre["idx_im"])
    g["mj"] = _safe(pre["idx_mj"])
    g["jn"] = _safe(pidx[pj])
    g["nj"] = _safe(pidx[:, pj].T)
    g["in"] = _safe(pidx[pi])
    rowg = torch.arange(Sg.shape[0], device=pidx.device)[:, None]
    S = {k: take(Sg, rowg, s) * m[:, :, None, None]
         for k, (s, m) in g.items()}
    t = {k: t2c[s] * m[:, :, None, None] for k, (s, m) in g.items()}
    t["sim"] = t2sc[g["im"][0]] * g["im"][1][:, :, None, None]
    G = dict(jn=C("pnby,pnfy->pnbf", S["jn"], t["jn"]),
             nj=C("pnby,pnfy->pnbf", S["nj"], t["nj"]),
             jnx=C("pnby,pnxy->pnbx", S["jn"], t["jn"]),
             inx=C("pnby,pnxy->pnbx", S["in"], t["in"]))
    return g, S, t, G


def _w_terms(pre, m, g, S, t, G, Wmbej_t1=None, Wmbje_t1=None,
             Wmbie_t1=None, fmi=None):
    """The m-th term of the ring sums: Wmbej, Wmbje, Wmbie of every strong
    pair at occupied m (the XE-type blocks gathered at (p, n)), then their
    products with the m-rows of the amplitudes; fmi (P,) is the Fmi
    factor of the D3 term at (m, j_p)."""
    im_safe, mask_im = g["im"]
    mj_safe, mask_mj = g["mj"]
    jn_safe, mask_jn = g["jn"]
    nj_safe, mask_nj = g["nj"]
    in_safe, mask_in = g["in"]
    rows = torch.arange(im_safe.shape[0], device=im_safe.device)
    r_im = im_safe[:, m]
    msk_im = mask_im[:, m][:, None, None, None]
    XE_pm = take(pre["XEg"], r_im[:, None], jn_safe) \
        * mask_jn[:, :, None, None] * msk_im
    Wmbej = take(pre["W1g"], rows, m) \
        - 0.5 * C("pnbf,pnef->pbe", G["jn"], XE_pm)
    XL_pm = take(pre["XLg"], r_im[:, None], nj_safe) \
        * mask_nj[:, :, None, None] * msk_im
    Wmbej = Wmbej + 0.5 * C("pnbf,pnef->pbe", G["nj"], XL_pm)
    XE2_pm = take(pre["XE2g"], jn_safe, r_im[:, None]) \
        * mask_jn[:, :, None, None] * msk_im
    Wmbje = -take(pre["W1jeg"], rows, m) \
        + 0.5 * C("pnbx,pnxe->pbe", G["jnx"], XE2_pm)
    r_mj = mj_safe[:, m]
    msk_mj = mask_mj[:, m][:, None, None, None]
    XE3_pm = take(pre["XE3g"], in_safe, r_mj[:, None]) \
        * mask_in[:, :, None, None] * msk_mj
    Wmbie = -take(pre["W1ieg"], rows, m) \
        + 0.5 * C("pnbx,pnxe->pbe", G["inx"], XE3_pm)
    if Wmbej_t1 is not None:
        Wmbej = Wmbej + Wmbej_t1[:, m]
        Wmbje = Wmbje + Wmbje_t1[:, m]
        Wmbie = Wmbie + Wmbie_t1[:, m]

    Sim, Smj = S["im"][:, m], S["mj"][:, m]
    D3 = C("pax,pxy,pby->pab", Sim, t["im"][:, m], Sim)
    out = -D3 * fmi[:, None, None]
    D5 = C("pax,pxe->pae", Sim, t["sim"][:, m])
    out = out + C("pae,pbe->pab", D5, Wmbej)
    D6 = C("pax,pxe->pae", Sim, t["im"][:, m])
    out = out + C("pae,pbe->pab", D6, Wmbej + Wmbje)
    D7 = C("pax,pxe->pae", Smj, t["mj"][:, m])
    return out + C("pae,pbe->pab", D7, Wmbie)


def _scatter(pre, r2c, no, D):
    """Pair symmetrisation, r2[ij] += r2[ji]^T(ab), and the scatter back
    to the (no, no, D, D) layout; weak rows stay zero."""
    pi, pj = pre["pi"], pre["pj"]
    r2c = r2c + r2c[pre["ptrans"]].swapaxes(1, 2)
    out = torch.zeros((no * no,) + tuple(r2c.shape[1:]), dtype=r2c.dtype,
                      device=r2c.device)
    out[pi * no + pj] = r2c
    return out.reshape(no, no, D, D)


def _fmi_ccd(pre, t2c, no):
    """Fmi (no_m, no_j) of the doubles: F_oo plus the sum over the strong
    pairs q = (j, n) of t2c[q] . BLg[q, m]."""
    term = C("qab,qmab->qm", t2c, pre["BLg"])
    seg = torch.zeros((no, term.shape[1]), dtype=term.dtype,
                      device=term.device)
    seg.index_add_(0, pre["pi"], term)
    return pre["F_oo"] + seg.T


def residuals_ccd_screened(pre, t2r):
    """r2 (no,no,D,D): the lccwfn_local.residuals_ccd_local equations over
    the compact strong-pair stacks; weak-pair rows return 0."""
    pi, pj = pre["pi"], pre["pj"]
    no, D = t2r.shape[0], t2r.shape[2]
    Sg, TLg, BEg = pre["Sg"], pre["TLg"], pre["BEg"]
    t2c = t2r.reshape(no * no, D, D)[pi * no + pj]
    t2sc = t2c - t2c.swapaxes(1, 2)

    # Fae[p,a,e] = Fvv - sum_q (Sg[p,q] t2c[q]) . TLg[p,q]
    ST = C("pqax,qxy->pqay", Sg, t2c, keep=True)
    Fae = dense(pre["Fvv"]) - C("pqay,pqey->pae", ST, TLg)
    Fmi = _fmi_ccd(pre, t2c, no)
    # Wmnij[q, p] = <mn|ij> + t2c[p] . BEg[p, q]
    Wmnij = dense(pre["ERI_oooo_g"]) + C("pef,pqef->qp", t2c, BEg)

    g, S, t, G = _gathers(pre, t2c, t2sc)
    r2c = sum(_w_terms(pre, m, g, S, t, G, fmi=Fmi[m, pj])
              for m in range(no))

    # m-independent terms
    diag = torch.arange(Sg.shape[0], device=pi.device)
    r2c = r2c + 0.5 * take(BEg, diag, diag)
    r2c = r2c + C("pae,pbe->pab", t2c, Fae)
    r2c = r2c + 0.5 * C("pef,pabef->pab", t2c, pre["VVg"])
    D8 = C("pqay,qyx,pqbx->pqab", Sg, t2c, Sg, keep=True)
    r2c = r2c + 0.5 * C("pqab,qp->pab", D8, Wmnij)
    return _scatter(pre, r2c, no, D)


def residuals_ccsd_screened(pre, t1loc, t2r):
    """(r1 (no,D), r2 (no,no,D,D)): lccwfn_local.residuals_ccsd_local over
    the compact strong-pair stacks.  Weak-pair r2 rows return 0 (frozen at
    MP2); couplings through weak pairs are masked out: the standard
    strong/weak partition, exact when pair_cutoff=0."""
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    no, D = t2r.shape[0], t2r.shape[2]
    Sg, TLg, BEg = pre["Sg"], pre["TLg"], pre["BEg"]
    t2c = t2r.reshape(no * no, D, D)[pi * no + pj]
    t2sc = t2c - t2c.swapaxes(1, 2)
    t2s2c = 2.0 * t2c - t2c.swapaxes(1, 2)
    diag = pre["diag"]
    t1i, t1j = t1loc[pi], t1loc[pj]

    # Sb[p, m, a] = S(p, (m,m)) t1[m]  (== Sb_t1mm == Sb_t1nn)
    Sb = C("pmax,mx->pma", pre["Sdiag_g"], t1loc)

    # ---- Fae (P, D, D)
    ST = C("pqax,qxy->pqay", Sg, t2c, keep=True)
    Fae = dense(pre["Fvv"]) - C("pqay,pqey->pae", ST, TLg)
    Fae = Fae - 0.5 * C("pma,pme->pae", Sb, pre["Fov_g"])
    Fae = Fae + C("mb,pmabe->pae", t1loc, pre["TLm_g"])
    Fae = Fae - 0.5 * C("nf,pmnef,pma->pae", t1loc, pre["TLnn_g"], Sb)

    # ---- Fmi (no_m, no_j)
    Fmi = _fmi_ccd(pre, t2c, no)
    Fmi = Fmi + 0.5 * C("je,jme->mj", t1loc, pre["FovD"])
    Fmi = Fmi + C("ne,mnje->mj", t1loc, pre["LooovD"])
    Fmi = Fmi + 0.5 * C("nf,mnjef,je->mj", t1loc, pre["TL2"], t1loc)

    # ---- Fme (P, no_m, D)
    Fme = dense(pre["Fov_g"]) + C("nf,pmnef->pme", t1loc, pre["TLnn_g"])
    FmeD = Fme[diag]                                    # [j, m, e]
    s4 = C("je,jme->jm", t1loc, FmeD)

    # ---- Wmnij (Q, P)
    Wmnij = dense(pre["ERI_oooo_g"]) + C("pef,pqef->qp", t2c, BEg)
    Wmnij = Wmnij + C("pe,qpe->qp", t1j, pre["EooovD_g"])
    Wmnij = Wmnij + C("pe,qpe->qp", t1i, pre["EoovoD_g"])
    Wmnij = Wmnij + C("pe,pf,qpef->qp", t1i, t1j, pre["TE2_g"])

    # ---- Zmbij (P, no, D)
    Zmb = C("pef,pmbef->pmb", t2c, pre["EovvvP_g"])
    Zmb = Zmb + C("pe,pf,pmbef->pmb", t1i, t1j, pre["Eovvv_iijj_g"])

    # ---- W singles tails, m-resolved (P, no, D, D)
    Wmbej_t1 = C("pf,pmbef->pmbe", t1j, pre["TE_mbe_g"])
    Wmbej_t1 = Wmbej_t1 - C("pnb,pmne->pmbe", Sb, pre["Eoovo_g"])
    Wmbej_t1 = Wmbej_t1 - C("pf,pnb,pmnef->pmbe", t1j, Sb, pre["XEjj_g"])
    Wmbje_t1 = -C("pf,pmbfe->pmbe", t1j, pre["TE_bFe_g"])
    Wmbje_t1 = Wmbje_t1 + C("pnb,pmne->pmbe", Sb, pre["Eooov_g"])
    Wmbje_t1 = Wmbje_t1 + C("pf,pnb,pmnfe->pmbe", t1j, Sb, pre["XE5_g"])
    Wmbie_t1 = -C("pf,pmbfe->pmbe", t1i, pre["TE_bFe_mj_g"])
    Wmbie_t1 = Wmbie_t1 + C("pnb,pmne->pmbe", Sb, pre["Eooov_mj_g"])
    Wmbie_t1 = Wmbie_t1 + C("pf,pnb,pmnfe->pmbe", t1i, Sb, pre["XE6_g"])

    g, S, t, G = _gathers(pre, t2c, t2sc)
    r2c = sum(_w_terms(pre, m, g, S, t, G, Wmbej_t1, Wmbje_t1, Wmbie_t1,
                       fmi=Fmi[m, pj] + 0.5 * s4[pj, m])
              for m in range(no))

    # m-independent terms
    rowg = torch.arange(Sg.shape[0], device=pi.device)
    r2c = r2c + 0.5 * take(BEg, rowg, rowg)
    r2c = r2c + C("pae,pbe->pab", t2c, Fae)
    r2c = r2c + 0.5 * C("pef,pabef->pab", t2c, pre["VVg"])
    r2c = r2c + 0.5 * C("pe,pf,pabef->pab", t1i, t1j, pre["VV2_g"])
    r2c = r2c + C("pe,pabe->pab", t1i, pre["Evvvo_g"])
    r2c = r2c - 0.5 * C("pmb,pme,pae->pab", Sb, Fme, t2c)
    r2c = r2c - C("pma,pmb->pab", Sb, Zmb)
    r2c = r2c - C("pe,pmbe,pma->pab", t1i, pre["E9_g"], Sb)
    r2c = r2c - C("pmae,pe,pmb->pab", pre["E11_g"], t1i, Sb)
    r2c = r2c - C("pma,pmb->pab", Sb, pre["Eovoo_g"])
    D8 = C("pqay,qyx,pqbx->pqab", Sg, t2c, Sg, keep=True)
    r2c = r2c + 0.5 * C("pqab,qp->pab", D8, Wmnij)
    r2c = r2c + 0.5 * C("pqa,qp,pqb->pab", Sb[:, pi], Wmnij, Sb[:, pj])
    r2 = _scatter(pre, r2c, no, D)

    # ---- r_T1 (full occupied layout; weak (i,m)/(m,i) couplings masked)
    rng = torch.arange(no, device=pi.device)
    safe_f, mask_f = _safe(pidx)
    t2s2_im = t2s2c[safe_f] * mask_f[:, :, None, None]
    t2s2_mi = t2s2c[safe_f.T] * mask_f.T[:, :, None, None]
    Fme_im = Fme[safe_f, rng[None, :]] * mask_f[:, :, None]

    Fae_ii = Fae[diag]
    r1 = pre["Fov_ii"] + C("ie,iae->ia", t1loc, Fae_ii)
    St1 = C("imax,mx->ima", pre["Siimm"], t1loc)
    r1 = r1 - C("ima,mi->ia", St1, Fmi)
    T1a = C("imax,imxe->imae", pre["Siiim"], t2s2_im)
    r1 = r1 + C("imae,ime->ia", T1a, Fme_im)
    r1 = r1 + C("imaef,imef->ia", pre["Eovvv_mi"], t2s2_mi)
    r1 = r1 + C("nf,inaf->ia", t1loc, pre["Lnvvi"])
    ST1 = C("iqax,qxe->iqae", take(Sg, diag), t2c)
    r1 = r1 - C("iqae,qie->ia", ST1, pre["LoovoD_g"])

    return r1, r2
