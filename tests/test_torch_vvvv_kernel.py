"""The K1 wrapper `vvvv_nt`: the plain version on CPU tensors, and the
CUDA kernel against the plain version on the card.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest tests/test_torch_vvvv_kernel.py -q -m cuda
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt, vvvv_nt_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_ragged_f64():
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((37, 77)), rng.standard_normal((101, 77))
    launches = vvvv_nt.launches
    out = vvvv_nt(torch.from_numpy(A), torch.from_numpy(B))
    assert vvvv_nt.launches == launches
    assert out.dtype == torch.float64 and out.shape == (37, 101)
    assert np.max(np.abs(out.numpy() - A @ B.T)) < 1e-12


def test_tensors_off_cpu_and_cuda_raise():
    A = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        vvvv_nt(A, A)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bf16,tol", [
    (torch.float64, False, 1e-12), (torch.float32, False, 1e-5),
    (torch.float32, True, 2e-2)])
@pytest.mark.parametrize("mnk", [(16, 361, 361), (37, 101, 77),
                                 (130, 200, 515)])
def test_kernel_matches_plain_version_on_card(cuda_device, mnk, dtype, bf16,
                                              tol):
    m, n, k = mnk
    g = torch.Generator(device=cuda_device).manual_seed(0)
    A = torch.randn((m, k), generator=g, device=cuda_device, dtype=dtype)
    B = torch.randn((n, k), generator=g, device=cuda_device, dtype=dtype)
    launches = vvvv_nt.launches
    out = vvvv_nt(A, B, bf16=bf16)
    torch.cuda.synchronize()
    ref = vvvv_nt_reference(A, B, bf16=bf16)
    assert vvvv_nt.launches == launches + 1
    assert out.dtype == ref.dtype
    assert ((out - ref).abs().max() / ref.abs().max()).item() < tol


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands_on_card(cuda_device):
    A = torch.zeros((8, 16), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        vvvv_nt(A, torch.zeros_like(A).T.contiguous().T)   # not contiguous
    with pytest.raises(ValueError):
        vvvv_nt(A, A[:, :8].contiguous())     # K mismatch
    with pytest.raises(TypeError):
        vvvv_nt(A, A.float())                 # mixed dtypes
    with pytest.raises(TypeError):
        vvvv_nt(A, A, bf16=True)              # bf16 mode takes f32/bf16
    with pytest.raises(ValueError):
        vvvv_nt(A, A.cpu())                   # mixed devices
