"""Pivoted-Cholesky factorization of the two-electron integrals.

The counterpart of pycc_tpu/ops/cholesky.py, on a torch device.  The ERI
supermatrix in chemists' ordering, V[(pr),(qs)] = (pr|qs), is symmetric
positive semidefinite, so a pivoted Cholesky decomposition truncated at
`tol` yields three-index factors

    (pr|qs) ~= sum_P  B[P, p, r] * B[P, q, s],        naux = O(few * nact)

i.e. in the Dirac convention ERI[p,q,r,s] = (pr|qs) ~=
einsum('Ppr,Pqs->pqrs', B, B).

* `cholesky_factor_eri` factors a dense MO ERI (the route of
  ccwfn(storage='df', df_direct=False)).
* `recompress_factors` shrinks AO-derived factors (scf/df.py) to the rank
  the active MO space needs without forming the supermatrix: each factor
  row is one (naux x n^2) GEMV.

Both keep pycc_tpu's pivot rule (the largest residual diagonal, the first
index on ties), so the factors equal numpy's to rounding.  Each pivot is
one device GEMV, and the host reads one number a pivot: at (H2O)_6/aug-
cc-pVDZ the recompression walks a ~1.3 GB matrix ~2000 times, terabytes of
memory traffic, which is why it runs on `device` (default the card) and
not in host numpy.
"""

import torch

from ..utils.device import init_device


def cholesky_factor_eri(ERI, tol=1e-8, max_naux=None, device="cuda"):
    """Factor a Dirac-convention MO ERI (numpy array or tensor): returns B
    (naux, n, n) float64 on `device` with ERI[p,q,r,s] ~=
    einsum('Ppr,Pqs->pqrs', B, B) to accuracy `tol` (max abs error on the
    diagonal of the residual supermatrix).

    B rows are symmetric in (p, r) since (pr|qs) = (rp|qs) for real
    orbitals."""
    dev = init_device(device)
    ERI = torch.as_tensor(ERI, dtype=torch.float64, device=dev)
    n = ERI.shape[0]
    # chemist supermatrix rows/cols are the (p,r) / (q,s) pairs
    V = ERI.permute(0, 2, 1, 3).reshape(n * n, n * n)
    B = _pivoted_cholesky(V, tol=tol, max_rank=max_naux)
    return B.reshape(-1, n, n)


def _pivoted_cholesky(V, tol, max_rank=None):
    """Greedy pivoted Cholesky of a dense symmetric PSD matrix (tensor).

    Returns L (rank, n) with V ~= L.T @ L and
    max|diag(V - L.T L)| <= tol."""
    n = V.shape[0]
    if max_rank is None:
        max_rank = n
    return _pivot_rows(torch.diagonal(V).clone(), lambda p: V[:, p],
                       tol, max_rank, n)


def recompress_factors(B, tol=1e-8, max_naux=None, device="cuda"):
    """Second-stage pivoted Cholesky of V = M^T M with M = B.reshape(naux,
    n^2), WITHOUT forming the n^2 x n^2 supermatrix: each factor row is a
    single (naux x n^2) GEMV.  Shrinks AO-derived factors (naux ~ few*nao)
    to the rank the active MO space needs (naux ~ few*nact); the
    per-iteration cost of every DF-CC contraction is linear in naux.

    B is a numpy array or tensor; returns B2 (naux2, n, n) float64 on
    `device` with sum_P B2[P,pq] B2[P,rs] equal to sum_P B[P,pq] B[P,rs]
    to `tol` on the residual diagonal."""
    dev = init_device(device)
    B = torch.as_tensor(B, dtype=torch.float64, device=dev)
    naux, n, _ = B.shape
    M = B.reshape(naux, n * n).contiguous()
    d = torch.einsum("Pq,Pq->q", M, M)
    if max_naux is None:
        max_naux = naux
    rows = _pivot_rows(d, lambda q: M.T @ M[:, q], tol, max_naux, n * n,
                       cap=naux)
    return rows.reshape(-1, n, n)


def _pivot_rows(d, column, tol, max_rank, n, cap=256):
    """The pivoted-Cholesky loop over a residual diagonal d (consumed):
    column(q) is the supermatrix column q.  Each step takes the largest
    residual diagonal (first index on ties, as numpy's argmax), removes
    the known rows from its column, and zeroes the eliminated pivots.
    Room for `cap` rows is made first, and doubled when full."""
    cap = min(max_rank, n, cap)
    rows = torch.empty((cap, n), dtype=d.dtype, device=d.device)
    order = torch.empty((cap,), dtype=torch.long, device=d.device)
    k = 0
    while k < max_rank:
        q = torch.argmax(d)
        dq = float(d[q])          # the one host read of a pivot
        if dq <= tol:
            break
        if k == rows.shape[0]:    # grow by doubling
            cap = min(max_rank, n, 2 * k)
            rows = torch.cat([rows, rows.new_empty((cap - k, n))])
            order = torch.cat([order, order.new_empty((cap - k,))])
        col = column(q)
        if k:
            col = col - rows[:k].T @ rows[:k, q]
        piv = dq ** 0.5
        row = col / piv
        # exact zeros on already-eliminated pivots keep d non-negative
        row[order[:k]] = 0.0
        row[q] = piv
        rows[k] = row
        order[k] = q
        k += 1
        d -= row * row
        d[q] = 0.0
        torch.clamp_(d, min=0.0)
    return rows[:k]
