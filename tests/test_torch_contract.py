"""The port's `contract` against pycc_tpu's: mixed dtypes promote as
jnp.einsum promotes them, and operands of one dtype pass through
untouched."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from pycc_tpu.ops.contract import contract as jcontract
from pycc_tpu_torch.ops.contract import contract

_TORCH = {"c128": torch.complex128, "f64": torch.float64,
          "f32": torch.float32}
_NUMPY = {"c128": np.complex128, "f64": np.float64, "f32": np.float32}


def _operand(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if kind == "c128":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(_NUMPY[kind])


@pytest.mark.parametrize("kinds,want", [
    (("c128", "f64"), torch.complex128), (("f64", "c128"), torch.complex128),
    (("f64", "f32"), torch.float64), (("f32", "f64"), torch.float64)])
def test_mixed_dtypes_promote_as_pycc_tpu(kinds, want):
    a = _operand(kinds[0], (5, 7), 1)
    b = _operand(kinds[1], (7, 3), 2)
    ref = jcontract("ij,jk->ik", jnp.asarray(a), jnp.asarray(b))
    out = contract("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == want
    assert str(ref.dtype) == str(want).replace("torch.", "")
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-14


def test_three_mixed_operands_promote_as_pycc_tpu():
    """pertbar's 'ie,ma,me->ai' with a complex perturbation."""
    t1a = _operand("f64", (4, 6), 3)
    t1b = _operand("f64", (4, 6), 4)
    pert = _operand("c128", (4, 6), 5)
    ref = jcontract("ie,ma,me->ai", jnp.asarray(t1a), jnp.asarray(t1b),
                    jnp.asarray(pert))
    out = contract("ie,ma,me->ai", torch.from_numpy(t1a),
                   torch.from_numpy(t1b), torch.from_numpy(pert))
    assert out.dtype == torch.complex128
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-14


def test_one_dtype_passes_the_operands_through(monkeypatch):
    a = torch.from_numpy(_operand("f64", (3, 4), 6))
    b = torch.from_numpy(_operand("f64", (4, 2), 7))
    seen = []
    einsum = torch.einsum

    def spy(subscripts, *operands):
        seen.append(operands)
        return einsum(subscripts, *operands)

    monkeypatch.setattr(torch, "einsum", spy)
    out = contract("ij,jk->ik", a, b)
    assert seen[0][0] is a and seen[0][1] is b
    # what contract returned is the real einsum's own result, bit for bit
    # (a @ b may round the last bit differently on another BLAS path)
    assert torch.equal(out, einsum("ij,jk->ik", a, b))
