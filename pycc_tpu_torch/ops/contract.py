"""Tensor-contraction layer: einsum over torch tensors.

The counterpart of pycc_tpu/ops/contract.py.  torch.einsum lowers each
contraction to batched matrix products (pairwise, in the order opt_einsum
picks when it is installed, for three or more operands).  Operands of
mixed dtypes are promoted first, as jnp.einsum promotes them: (complex128,
float64) -> complex128 for the complex response perturbations against real
amplitudes, (float64, float32) -> float64.  Operands of one dtype are
passed through untouched: no cast, no copy.  There is no complex-split
branch, since torch has complex dtypes.
"""

import functools

import torch


def contract(subscripts, *operands):
    dt = operands[0].dtype
    if any(x.dtype != dt for x in operands[1:]):
        dt = functools.reduce(torch.promote_types, (x.dtype for x in operands))
        operands = [x.to(dt) for x in operands]
    return torch.einsum(subscripts, *operands)
