"""Tensor-contraction layer: einsum over torch tensors.

The counterpart of pycc_tpu/ops/contract.py.  Every contraction of the
ported residuals has two operands, so torch.einsum's own pairwise
lowering (to batched matrix products) is the whole path: no contraction-
order search, and no complex-split branch, since torch has complex dtypes.
"""

import torch


def contract(subscripts, *operands):
    return torch.einsum(subscripts, *operands)
