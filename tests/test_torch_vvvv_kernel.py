"""The K1 wrapper `vvvv_nt`: the plain version on CPU tensors, and the
CUDA kernel against the plain version on the card.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest tests/test_torch_vvvv_kernel.py -q -m cuda
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu_torch.ops.kernels.vvvv import (copy_bytes, vvvv_nt,
                                             vvvv_nt_reference)


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


@pytest.mark.parametrize("dtype,k,want", [
    (torch.float64, 16, 16), (torch.float64, 77, 8),
    (torch.float32, 16, 16), (torch.float32, 34, 8), (torch.float32, 77, 4),
    (torch.bfloat16, 16, 16), (torch.bfloat16, 36, 8),
    (torch.bfloat16, 34, 4), (torch.bfloat16, 77, 2)])
def test_copy_width_follows_the_row_alignment(dtype, k, want):
    A = torch.zeros((3, k), dtype=dtype)
    B = torch.zeros((5, k), dtype=dtype)
    assert copy_bytes(A, B) == want
    # a view one element in is aligned to its element size only
    off = torch.zeros(3 * k + 1, dtype=dtype)[1:].view(3, k)
    low = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2}[dtype]
    assert copy_bytes(off, B) == low


# M and N off the block tiles (64 x 128, 128 x 128), every copy width:
# K = 64 (16-byte rows in every type), 36 (8-byte bf16 rows), 34 (8-byte
# f32, 4-byte bf16 rows) and 77 (odd: 8-byte f64, 4-byte f32, 2-byte bf16)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bf16,tol", [
    (torch.float64, False, 1e-12), (torch.float32, False, 1e-5),
    (torch.float32, True, 2e-2)])
@pytest.mark.parametrize("mnk", [(65, 129, 64), (70, 250, 36),
                                 (129, 131, 34), (200, 257, 77)])
def test_kernel_ragged_tiles_and_copy_widths_on_card(cuda_device, mnk, dtype,
                                                     bf16, tol):
    m, n, k = mnk
    g = torch.Generator(device=cuda_device).manual_seed(1)
    A = torch.randn((m, k), generator=g, device=cuda_device, dtype=dtype)
    B = torch.randn((n, k), generator=g, device=cuda_device, dtype=dtype)
    out = vvvv_nt(A, B, bf16=bf16)
    torch.cuda.synchronize()
    ref = vvvv_nt_reference(A, B, bf16=bf16)
    assert out.shape == (m, n) and out.dtype == ref.dtype
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


# the dressed DF ladder's shape, (o^2, blk*v, v^2), with v = 45 off every
# tile and a ragged last a-block
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bf16,tol", [
    (torch.float64, False, 1e-12), (torch.float32, False, 1e-5),
    (torch.float32, True, 2e-2)])
def test_kernel_at_a_df_ladder_shape_on_card(cuda_device, dtype, bf16, tol):
    m, n, k = 16, 6 * 45, 45 * 45
    g = torch.Generator(device=cuda_device).manual_seed(2)
    A = torch.randn((m, k), generator=g, device=cuda_device, dtype=dtype)
    B = torch.randn((n, k), generator=g, device=cuda_device, dtype=dtype)
    out = vvvv_nt(A, B, bf16=bf16)
    torch.cuda.synchronize()
    ref = vvvv_nt_reference(A, B, bf16=bf16)
    assert out.shape == (m, n) and out.dtype == ref.dtype
    assert ((out - ref).abs().max() / ref.abs().max()).item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks", [1, 4])
def test_ladder_df_on_card_matches_cpu(cuda_device, nblocks):
    from pycc_tpu_torch.models.dfccsd import df_blocks, ladder_df
    rng = np.random.default_rng(3)
    no, nv, naux = 4, 45, 60
    B = 0.1 * rng.standard_normal((naux, no + nv, no + nv))
    B = torch.from_numpy(0.5 * (B + B.transpose(0, 2, 1)))
    t1 = torch.from_numpy(0.05 * rng.standard_normal((no, nv)))
    t2 = torch.from_numpy(0.05 * rng.standard_normal((no, no, nv, nv)))
    ref = ladder_df(df_blocks(B, no), t1, t2, nblocks=nblocks)
    launches = vvvv_nt.launches
    out = ladder_df(df_blocks(B.to(cuda_device), no), t1.to(cuda_device),
                    t2.to(cuda_device), nblocks=nblocks)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + nblocks
    assert (out.cpu() - ref).abs().max().item() < 1e-12


# the general DF ladder of the post-convergence stack: a transposed left
# factor, BL != BR, a leading batch of vectors and ragged a-blocks (v = 45
# in blocks of 12), real and complex amplitudes
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["real", "complex-x2", "complex-BL"])
def test_ladder_apply_on_card_matches_cpu(cuda_device, kind):
    from pycc_tpu_torch.models.dfhbar import ladder_apply
    rng = np.random.default_rng(5)
    naux, nv, nb = 60, 45, 31
    BL = torch.from_numpy(rng.standard_normal((naux, nv, nv))).transpose(1, 2)
    BR = torch.from_numpy(rng.standard_normal((naux, nb, nv)))
    x2 = torch.from_numpy(rng.standard_normal((3, 4, 4, nv, nv)))
    if kind == "complex-x2":
        x2 = torch.complex(x2, torch.from_numpy(
            rng.standard_normal((3, 4, 4, nv, nv))))
    if kind == "complex-BL":
        BL = torch.complex(BL, torch.from_numpy(
            rng.standard_normal((naux, nv, nv))))
    ref = ladder_apply(BL, BR, x2, nblocks=4)
    launches = vvvv_nt.launches
    out = ladder_apply(BL.to(cuda_device), BR.to(cuda_device),
                       x2.to(cuda_device), nblocks=4)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 4 * (2 if kind == "complex-BL"
                                               else 1)
    assert ((out.cpu() - ref).abs().max() / ref.abs().max()).item() < 1e-13


# Lambda's left ladder 'ijef,efab' on the operand pre-laid once per HBAR
# (cchbar.HBar.Hvvvv_efab), v = 37 off every tile
@pytest.mark.cuda
def test_kernel_on_the_prelaid_efab_operand_on_card(cuda_device):
    from pycc_tpu_torch.models.ccsd import vvvv_contract_efab
    no, nv = 5, 37
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tau = torch.randn((no, no, nv, nv), generator=g, device=cuda_device,
                      dtype=torch.float64)
    W = torch.randn((nv, nv, nv, nv), generator=g, device=cuda_device,
                    dtype=torch.float64)
    Wt = W.permute(2, 3, 0, 1).contiguous()
    launches = vvvv_nt.launches
    out = vvvv_contract_efab(tau, Wt)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 1
    ref = vvvv_nt_reference(tau.reshape(no * no, nv * nv),
                            Wt.reshape(nv * nv, nv * nv))
    ref = ref.reshape(no, no, nv, nv)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-12
    assert (out - torch.einsum("ijef,efab->ijab", tau, W)).abs().max() < 1e-9


# the EOM sigma of a block of k vectors: one K1 launch at (k o^2, v^2, v^2)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernel_at_a_batched_eom_shape_on_card(cuda_device, dtype, tol):
    from pycc_tpu_torch.cchbar import build_hbar
    from pycc_tpu_torch.cceom import sigma_block
    from pycc_tpu_torch.utils.synth import mp2_guess, synthetic_hamiltonian
    no, nv, k = 4, 19, 3
    H = synthetic_hamiltonian(no, nv, seed=3, dtype=dtype, device=cuda_device)
    t1, t2, _ = mp2_guess(H)
    hb = build_hbar("CCSD", H.F, H.ERI, H.L, t1, t2, no)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    C = torch.randn((k, no * nv + (no * nv) ** 2), generator=g,
                    device=cuda_device, dtype=dtype)
    launches = vvvv_nt.launches
    S = sigma_block(hb, C, H.L, t2, no)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 1
    ref = sigma_block(hb, C, H.L, t2, no, ladder=vvvv_nt_reference)
    assert S.shape == ref.shape and S.dtype == dtype
    assert ((S - ref).abs().max() / ref.abs().max()).item() < tol


# the response ladders: a complex tau (M and P perturbations) against a
# real W is one K1 launch on the stacked (2 o^2, v^2) real and imaginary
# rows, v = 37 off every tile
@pytest.mark.cuda
@pytest.mark.parametrize("efab", [False, True])
def test_complex_ladder_is_one_launch_on_card(cuda_device, efab):
    from pycc_tpu_torch.models.ccsd import vvvv_contract, vvvv_contract_efab
    no, nv = 5, 37
    g = torch.Generator(device=cuda_device).manual_seed(5)
    tau = torch.complex(
        torch.randn((no, no, nv, nv), generator=g, device=cuda_device,
                    dtype=torch.float64),
        torch.randn((no, no, nv, nv), generator=g, device=cuda_device,
                    dtype=torch.float64))
    W = torch.randn((nv, nv, nv, nv), generator=g, device=cuda_device,
                    dtype=torch.float64)
    fn = vvvv_contract_efab if efab else vvvv_contract
    launches = vvvv_nt.launches
    out = fn(tau, W)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 1
    ref = fn(tau, W, vvvv_nt_reference)
    assert out.dtype == torch.complex128 and out.shape == ref.shape
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-12


# in_Y1's two Hvvvv terms, 'imfg,fgae' and 'imgf,fgea': one K1 launch on
# l2 and its virtual-swapped copy stacked, for a real and a complex X
@pytest.mark.cuda
@pytest.mark.parametrize("complex_x", [False, True])
def test_in_Y1_stacked_ladder_is_one_launch_on_card(cuda_device, complex_x):
    import types
    from pycc_tpu_torch.cchbar import build_hbar
    from pycc_tpu_torch.ccresponse import build_response_aux, in_Y1, pertbar
    from pycc_tpu_torch.utils.synth import mp2_guess, synthetic_hamiltonian
    no, nv = 4, 19
    H = synthetic_hamiltonian(no, nv, seed=3, device=cuda_device)
    t1, t2, _ = mp2_guess(H)
    hb = build_hbar("CCSD", H.F, H.ERI, H.L, t1, t2, no)
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def rand(*shape):
        return 0.02 * torch.randn(shape, generator=g, device=cuda_device,
                                  dtype=torch.float64)
    p0 = rand(no + nv, no + nv)
    pert = p0 + p0.T
    X1, X2 = rand(no, nv), rand(no, no, nv, nv)
    if complex_x:
        pert = 1j * (p0 - p0.T)
        X1, X2 = torch.complex(X1, rand(no, nv)), torch.complex(
            X2, rand(no, no, nv, nv))
    cc = types.SimpleNamespace(o=slice(0, no), v=slice(no, no + nv), t1=t1,
                               t2=t2)
    A = pertbar(pert, cc)
    Ad = {k: getattr(A, k) for k in ("Aov", "Aoo", "Avv", "Avo", "Aovoo",
                                     "Avvoo", "Avvvo")}
    l1, l2 = rand(no, nv), rand(no, no, nv, nv)
    aux = build_response_aux(hb)
    launches = vvvv_nt.launches
    out = in_Y1(hb, H.L, t2, l1, l2, Ad, X1, X2, no, aux)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 1
    ref = in_Y1(hb, H.L, t2, l1, l2, Ad, X1, X2, no, aux,
                ladder=vvvv_nt_reference)
    assert out.is_complex() == complex_x
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-5)])
@pytest.mark.parametrize("a_complex,stacked", [(True, False), (True, True),
                                               (False, True)])
def test_complex_W_route_matches_plain_version_on_card(cuda_device, dtype,
                                                       tol, a_complex,
                                                       stacked):
    """Real-time CC's Lambda ladder: a complex W (or its StackedComplex
    layout, made once per HBAR) against a complex or real A is ONE K1
    launch on the stacked operands (complex64 in K1's f32 mode), equal to
    the same route through the plain product; v = 37 is off every tile."""
    from pycc_tpu_torch.ops.kernels.vvvv import (complex_product,
                                                 stack_complex)
    m, n, k = 2 * 25, 37 * 37, 37 * 37
    g = torch.Generator(device=cuda_device).manual_seed(7)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    def rand(*shape, cx=True):
        x = torch.randn(shape, generator=g, device=cuda_device, dtype=real)
        if not cx:
            return x
        return torch.complex(x, torch.randn(shape, generator=g,
                                            device=cuda_device, dtype=real))
    A, W = rand(m, k, cx=a_complex), rand(n, k)
    B = stack_complex(W) if stacked else W
    launches = vvvv_nt.launches
    out = complex_product(vvvv_nt, A, B)
    torch.cuda.synchronize()
    assert vvvv_nt.launches == launches + 1
    ref = complex_product(vvvv_nt_reference, A, B)
    assert out.dtype == dtype and out.shape == (m, n)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < tol
    exact = A.to(dtype) @ W.T
    assert ((out - exact).abs().max() / exact.abs().max()).item() < tol


@pytest.mark.cuda
def test_sharded_ladder_is_one_launch_a_shard_on_card(cuda_device):
    """A ladder on W Sharded over a mesh (parallel/mesh.py) is one K1
    launch a shard, at a ragged split, equal to one launch on the whole W;
    a shard's operands on two devices raise."""
    from pycc_tpu_torch.models.ccsd import vvvv_contract
    from pycc_tpu_torch.parallel import Sharded, make_mesh
    n = torch.cuda.device_count()
    m = make_mesh(devices=["cuda:%d" % (i % n) for i in range(4)])
    g = torch.Generator(device=cuda_device).manual_seed(4)
    nv, no = 13, 5
    W = torch.randn((nv,) * 4, generator=g, device=cuda_device,
                    dtype=torch.float64)
    tau = torch.randn((no, no, nv, nv), generator=g, device=cuda_device,
                      dtype=torch.float64)
    before = vvvv_nt.launches
    out = vvvv_contract(tau, Sharded.put(W, m, ("va", "vb")))
    torch.cuda.synchronize()
    assert vvvv_nt.launches - before == 4 and out.device == tau.device
    assert torch.equal(out, vvvv_contract(tau, W))
    ref = vvvv_contract(tau, W, vvvv_nt_reference)
    assert float((out - ref).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="one CUDA device"):
        vvvv_nt(tau.reshape(no * no, -1), W.reshape(nv * nv, -1).cpu())
