"""einsum with dtype promotion, and the plain ladder product."""

import functools

import torch


def ein(subscripts, *operands):
    """torch.einsum after promoting every operand to their common dtype
    (a complex amplitude against real integrals gives a complex result)."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in operands))
    return torch.einsum(subscripts, *(x.to(dt) for x in operands))


def promote(x, like):
    """x in the dtype that x and `like` promote to."""
    return x.to(torch.promote_types(x.dtype, like.dtype))


def matmul_nt(A, B):
    """A @ B.T for real or complex operands.  A complex A against a real B
    is two real products, so that a large real B is never copied to a
    complex dtype."""
    if A.is_complex() and not B.is_complex():
        return torch.complex(A.real @ B.T, A.imag @ B.T)
    if B.is_complex() and not A.is_complex():
        return torch.complex(A @ B.real.T, A @ B.imag.T)
    return A @ B.T


def ladder(tau, W):
    """'ijef,abef->ijab' as one (o^2, v^2) x (v^2, v^2)^T product; a W
    that is no tensor (a v^4 operand held in blocks, reference/rt_df.py)
    takes it by its own `ladder`."""
    if not isinstance(W, torch.Tensor):
        return W.ladder(tau)
    no1, no2, nv, _ = tau.shape
    out = matmul_nt(tau.reshape(no1 * no2, nv * nv),
                    W.reshape(W.shape[0] * W.shape[1], nv * nv))
    return out.reshape(no1, no2, W.shape[0], W.shape[1])


def ladder_left(l2, W):
    """'ijef,efab->ijab' as one product; a W that is no tensor by its own
    `ladder_left`."""
    if not isinstance(W, torch.Tensor):
        return W.ladder_left(l2)
    no1, no2, nv, _ = l2.shape
    A = l2.reshape(no1 * no2, nv * nv)
    B = W.reshape(nv * nv, W.shape[2] * W.shape[3])
    if A.is_complex() != B.is_complex():
        dt = torch.promote_types(A.dtype, B.dtype)
        A, B = A.to(dt), B.to(dt)
    return (A @ B).reshape(no1, no2, W.shape[2], W.shape[3])
