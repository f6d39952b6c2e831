"""Integral-direct Cholesky decomposition of the AO two-electron integrals.

A copy of pycc_tpu/scf/df.py (host numpy and the native engine) with one
change: without the native engine `cholesky_factor_ao` raises instead of
falling back to the dense AO ERI.

The ERI supermatrix V[(mu nu),(la si)] = (mu nu|la si) is symmetric PSD, so
a pivoted Cholesky truncated at `tol` yields three-index factors

    (mu nu|la si) ~= sum_P B[P,mu,nu] B[P,la,si],      naux = O(few * nbf)

This module builds B *directly from shell-pair integral batches* — the full
nao^4 tensor never exists anywhere (host or device): factor generation,
SCF Fock builds, and the DF-CC solver stack (models/dfccsd.py) all run
from B alone, so system size is bounded by O(naux * nao^2) memory.

Algorithm (shell-pair-blocked pivoted Cholesky, Koch/Aquilante style):
repeatedly pick the largest residual diagonal element, compute the
*entire shell-pair column batch* (ab|kl) containing it with the native
McMurchie-Davidson engine (native/mdints.cpp, md_eri_cols), subtract the
known factors with one GEMM, and eliminate every in-batch pivot whose
residual diagonal is still significant.  Schwarz screening
|(ab|cd)| <= sqrt((ab|ab)(cd|cd)) skips negligible bra pairs inside the
native batch loop.
"""

import numpy as np
from ..utils.log import logger as log


def _shell_maps(basis):
    """(shell index of each AO function, offsets, transforms)."""
    from .integrals import shell_transform

    shells = basis.shells
    func_shell = np.empty(basis.nbf, dtype=int)
    for i, (sh, off) in enumerate(zip(shells, basis.offsets)):
        func_shell[off:off + sh.nfunc] = i
    T = [shell_transform(sh) for sh in shells]
    return func_shell, T


def _diag_and_schwarz(ctx, basis):
    """Residual diagonal d[mu,nu] = (mu nu|mu nu) over final AOs, plus
    per-shell-pair Schwarz bounds sqrt(max diag)."""
    _, T = _shell_maps(basis)
    shells = basis.shells
    d = np.zeros((basis.nbf, basis.nbf))
    schwarz = np.zeros(ctx.npairs)
    for p, blk in enumerate(ctx.diag_blocks()):
        i, j = ctx.pair_shells[p]
        Tij = np.kron(T[i], T[j])             # (nfi*nfj, ncab)
        blk_s = Tij @ blk @ Tij.T
        dij = np.diag(blk_s).reshape(shells[i].nfunc, shells[j].nfunc)
        oi, oj = basis.offsets[i], basis.offsets[j]
        d[oi:oi + shells[i].nfunc, oj:oj + shells[j].nfunc] = dij
        d[oj:oj + shells[j].nfunc, oi:oi + shells[i].nfunc] = dij.T
        schwarz[p] = np.sqrt(max(dij.max(), 0.0))
    return d, schwarz


def _transform_cols(ctx, basis, p, schwarz, thresh):
    """Final-AO column batch (mu nu | k l) for ket shell pair p:
    returns (nbf*nbf, nfk*nfl)."""
    from .native import cart_to_ao_matrix

    _, T = _shell_maps(basis)
    i, j = ctx.pair_shells[p]
    cols = ctx.cols(p, schwarz=schwarz, thresh=thresh)   # (Nc, Nc, ncab)
    Tao = cart_to_ao_matrix(basis)                       # (nbf, Nc)
    nbf = basis.nbf
    nck = cols.shape[2]
    # bra transforms (two GEMMs)
    M = Tao @ cols.reshape(cols.shape[0], -1)            # (nbf, Nc*nck)
    M = M.reshape(nbf, cols.shape[1], nck)
    M = np.tensordot(Tao, M, axes=(1, 1))                # (nbf_b, nbf_a, nck)
    M = M.transpose(1, 0, 2)
    # ket transform
    Tkl = np.kron(T[i], T[j])                            # (nfk*nfl, ncab)
    return (M.reshape(nbf * nbf, nck) @ Tkl.T,
            basis.offsets[i], basis.offsets[j],
            basis.shells[i].nfunc, basis.shells[j].nfunc)


def cholesky_factor_ao(basis, tol=1e-8, max_naux=None, span=1e-2,
                       verbose=False):
    """Integral-direct pivoted Cholesky of the AO ERI.

    Returns B (naux, nbf, nbf), float64, symmetric in (mu, nu), with
    max |(mu nu|mu nu) - sum_P B[P,mu,nu]^2| <= tol on the residual
    diagonal (which bounds every residual element by tol via Schwarz).

    `span`: in-batch pivots are accepted while their residual diagonal
    exceeds span * (global max at batch start) — larger values reuse each
    native integral batch harder at the cost of slightly larger naux.
    """
    from .native import ERIContext

    ctx = ERIContext(basis)
    nbf = basis.nbf
    func_shell, _ = _shell_maps(basis)
    pair_index = {sh: p for p, sh in enumerate(ctx.pair_shells)}

    d, schwarz = _diag_and_schwarz(ctx, basis)
    d = np.maximum(d, 0.0)
    if max_naux is None:
        max_naux = nbf * (nbf + 1) // 2
    # integral screening threshold: well under the target accuracy
    thresh = tol * 1e-3

    rows = np.empty((min(max_naux, 8 * nbf), nbf * nbf))
    k = 0
    nbatch = 0
    while True:
        dmax = d.max()
        if dmax <= tol or k >= max_naux:
            break
        mu, nu = np.unravel_index(int(d.argmax()), d.shape)
        si, sj = int(func_shell[mu]), int(func_shell[nu])
        p = pair_index.get((si, sj), pair_index.get((sj, si)))
        pi, pj = ctx.pair_shells[p]
        cols, oi, oj, nfi, nfj = _transform_cols(ctx, basis, p,
                                                 schwarz, thresh)
        nbatch += 1
        # global (mu nu) flat indices of this batch's candidate pivots
        qidx = (np.repeat(np.arange(oi, oi + nfi), nfj) * nbf
                + np.tile(np.arange(oj, oj + nfj), nfi))
        # subtract the known factors from the whole batch at once
        if k:
            cols -= rows[:k].T @ rows[:k, qidx]
        dq = d.reshape(-1)[qidx].copy()
        floor = max(tol, span * dmax)
        while k < max_naux:
            q = int(dq.argmax())
            if dq[q] <= floor:
                break
            piv = np.sqrt(dq[q])
            row = cols[:, q] / piv
            # exact value at the pivot position (kills roundoff drift)
            row[qidx[q]] = piv
            if k == rows.shape[0]:
                rows = np.concatenate(
                    [rows, np.empty((2 * nbf, nbf * nbf))])
            rows[k] = row
            k += 1
            d -= (row * row).reshape(nbf, nbf)
            np.maximum(d, 0.0, out=d)
            d.reshape(-1)[qidx[q]] = 0.0
            # update the remaining in-batch columns by the new row
            cols -= np.outer(row, row[qidx])
            dq = d.reshape(-1)[qidx]
        if verbose:
            log.debug("chol: batch %3d pair (%d,%d)  naux=%4d  dmax=%.3e"
                  % (nbatch, pi, pj, k, float(d.max())))
    if verbose:
        log.info("chol: naux=%d (%d batches, tol %.1e)" % (k, nbatch, tol))
    return rows[:k].reshape(k, nbf, nbf)


def factors_to_mo(B_ao, C):
    """MO-transform AO Cholesky factors: B_mo[P] = C.T @ B_ao[P] @ C.
    O(naux * nao^2 * nmo) — the only transform cost in the DF pipeline."""
    C = np.asarray(C)
    naux, nbf, _ = B_ao.shape
    tmp = B_ao.reshape(naux * nbf, nbf) @ C            # (naux*nbf, nmo)
    tmp = tmp.reshape(naux, nbf, C.shape[1])
    return np.matmul(C.T[None, :, :], tmp)             # (naux, nmo, nmo)


def fock_from_factors(B, Hcore, Cocc):
    """Closed-shell Fock matrix from AO Cholesky/DF factors:
    F = Hcore + 2 J - K with
    J = sum_P B[P] (B[P] . D),  K[p,q] = sum_P,i (B[P] C)[p,i] (B[P] C)[q,i],
    D = Cocc Cocc^T.  O(naux nao^2 nocc), no four-index object."""
    naux, nbf, _ = B.shape
    nocc = Cocc.shape[1]
    X = np.matmul(B, Cocc)                             # (naux, nbf, nocc)
    D = Cocc @ Cocc.T
    Jp = B.reshape(naux, -1) @ D.reshape(-1)           # (naux,)
    J = (Jp @ B.reshape(naux, -1)).reshape(nbf, nbf)
    Xf = X.transpose(1, 0, 2).reshape(nbf, naux * nocc)
    K = Xf @ Xf.T
    return Hcore + 2.0 * J - K
