"""K1, the ladder product C = A @ B.T: the port's plain version against
pycc_tpu's Pallas kernel in interpret mode.  The CUDA kernel's own tests,
which import no JAX, are in test_torch_vvvv_kernel.py."""

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

from pycc_tpu.ops.kernels import vvvv_pallas
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference


def _operands(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)), rng.standard_normal((n, k))


def test_reference_matches_pallas_f32():
    A, B = (x.astype(np.float32) for x in _operands(128, 512, 512))
    ref = np.asarray(vvvv_pallas(jnp.asarray(A), jnp.asarray(B), tm=128,
                                 tn=256, tk=256, interpret=True))
    out = vvvv_nt_reference(torch.from_numpy(A), torch.from_numpy(B))
    assert out.dtype == torch.float32
    assert np.max(np.abs(out.numpy() - ref)) < 1e-4


def test_reference_matches_pallas_bf16():
    A, B = (x.astype(np.float32) for x in _operands(128, 512, 512))
    ref = np.asarray(vvvv_pallas(jnp.asarray(A), jnp.asarray(B), bf16=True,
                                 interpret=True))
    out = vvvv_nt_reference(torch.from_numpy(A), torch.from_numpy(B),
                            bf16=True)
    assert out.dtype == torch.float32
    assert np.max(np.abs(out.numpy() - ref)) / np.max(np.abs(ref)) < 2e-2
