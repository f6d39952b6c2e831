"""The K2 wrapper `t_energy_row`: the plain version on CPU tensors, and the
CUDA kernel against the plain version on the card.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest tests/test_torch_triples_kernel.py -q -m cuda
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu_torch import triples
from pycc_tpu_torch.ops.kernels import triples as k2
from pycc_tpu_torch.ops.kernels.triples import (t_energy_row,
                                                t_energy_row_reference,
                                                t_row_derived,
                                                t_row_finalize,
                                                t_vikings_rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(no, nv, device="cpu", dtype=torch.float64, seed=5):
    """(Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t1, t2): random,
    scaled by 0.02, with the orbital energies spread."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.tensor(0.02 * rng.standard_normal(sh),
                                  dtype=dtype, device=device)
    eps = np.concatenate([np.linspace(-2.0, -0.5, no),
                          np.linspace(0.3, 3.0, nv)])
    return (mk(no, nv, nv, nv), mk(no, no, no, nv), mk(nv, no, nv, nv),
            mk(no, no, no, nv), mk(no, no, nv, nv), mk(no, nv),
            torch.tensor(eps, dtype=dtype, device=device), mk(no, nv),
            mk(no, no, nv, nv))


def _row_args(ops):
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = ops
    return (Wv, Wo, Ev, Eo, L, Fov, eps, t2)


@pytest.mark.parametrize("stream_dtype", [None, torch.float32,
                                          torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(stream_dtype):
    no, nv = 3, 10
    ops = _operands(no, nv)
    launches = t_energy_row.launches
    out = t_energy_row(1, *_row_args(ops), no, stream_dtype=stream_dtype)
    ref = t_energy_row_reference(1, *_row_args(ops), no,
                                 stream_dtype=stream_dtype)
    assert t_energy_row.launches == launches
    want = ((no, nv), (no, nv)) + ((no, nv, nv),) * 4 + ((no, no, nv, nv),)
    assert tuple(tuple(x.shape) for x in out) == want
    acc = torch.float64 if stream_dtype is None else torch.float32
    for x, r in zip(out, ref):
        assert x.dtype == acc and torch.equal(x, r)


def test_rows_sum_to_the_plain_scan():
    no, nv = 4, 9
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _operands(no, nv)
    e = t_vikings_rows(Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2, no)
    ref = triples.t_vikings_scan_core(Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2, no)
    assert e.dim() == 0
    assert abs(float(e) - float(ref)) < 1e-12


def _t3_by_grouped_products(i, j, Wv, Ot, t2, eps, no):
    """t3[i, j] (k, a, b, c) as csrc/t_row.cu builds it: for each k, three
    products (pair rows) x (single columns) over the e and m ranges of
    four terms laid end to end, the m terms negated."""
    cat = torch.cat
    Wi, Wj, t2i, t2j = Wv[i], Wv[j], t2[i], t2[j]
    slabs = []
    for k in range(no):
        Wk, t2k = Wv[k], t2[k]
        # single axis c, pair rows (a, b)
        Pc = cat([Wi.permute(1, 0, 2), Wj, -t2i.permute(1, 2, 0),
                  -t2j.permute(2, 1, 0)], dim=-1)
        Sc = cat([t2[k, j].T, t2[k, i].T, Ot[j, k], Ot[i, k]])
        # single axis b, pair rows (a, c)
        Pb = cat([Wi.permute(1, 0, 2), Wk, -t2i.permute(1, 2, 0),
                  -t2k.permute(2, 1, 0)], dim=-1)
        Sb = cat([t2[j, k].T, t2[j, i].T, Ot[k, j], Ot[i, j]])
        # single axis a, pair rows (b, c)
        Pa = cat([Wk, Wj.permute(1, 0, 2), -t2k.permute(2, 1, 0),
                  -t2j.permute(1, 2, 0)], dim=-1)
        Sa = cat([t2[i, j].T, t2[i, k].T, Ot[j, i], Ot[k, i]])
        t3 = (torch.einsum("abx,xc->abc", Pc, Sc)
              + torch.einsum("acx,xb->abc", Pb, Sb)
              + torch.einsum("bcx,xa->abc", Pa, Sa))
        ev = eps[no:]
        denom = (eps[i] + eps[j] + eps[k] - ev[:, None, None]
                 - ev[None, :, None] - ev[None, None, :])
        slabs.append(t3 / denom)
    return torch.stack(slabs)


def test_grouped_products_build_the_t3_slab():
    no, nv = 7, 45
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _operands(no, nv)
    for i, j in ((0, 0), (2, 5), (6, 1)):
        got = _t3_by_grouped_products(i, j, Wv, Wo, t2, eps, no)
        want = triples._t3c_slab_ij(i, j, Wv, Wo, t2, eps[:no], eps[no:])
        assert ((got - want).abs().max() / want.abs().max()).item() < 1e-12


@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16])
def test_derived_operands(stream_dtype):
    no, nv = 3, 5
    Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2 = _operands(no, nv)
    t2m, Otm, G = t_row_derived(Wo, Ev, t2, stream_dtype)
    sd = torch.float64 if stream_dtype is None else stream_dtype
    assert all(x.dtype == sd and x.is_contiguous() for x in (t2m, Otm, G))
    Wo, Ev, t2 = (x.to(sd) for x in (Wo, Ev, t2))
    assert torch.equal(t2m, torch.einsum("nmpq->npqm", t2))
    assert torch.equal(Otm, -torch.einsum("xyms->xysm", Wo))
    assert torch.equal(G, 2.0 * Ev - torch.einsum("dkcb->dkbc", Ev))


def test_tensors_off_cpu_and_cuda_raise():
    ops = tuple(x.to("meta") for x in _row_args(_operands(2, 4)))
    with pytest.raises(ValueError):
        t_energy_row(0, *ops, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,stream_dtype,tol", [
    (torch.float64, None, 1e-12), (torch.float32, None, 1e-5),
    (torch.float32, torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("no,nv", [(4, 19), (7, 45), (5, 130)])
def test_kernel_matches_plain_version_on_card(cuda_device, no, nv, dtype,
                                              stream_dtype, tol):
    ops = _operands(no, nv, cuda_device, dtype)
    args = _row_args(ops)
    i = no // 2
    launches = t_energy_row.launches
    out = t_energy_row(i, *args, no, stream_dtype=stream_dtype)
    torch.cuda.synchronize()
    ref = t_energy_row_reference(i, *args, no, stream_dtype=stream_dtype)
    assert t_energy_row.launches == launches + 1
    for x, r in zip(out, ref):
        assert x.dtype == r.dtype and x.shape == r.shape
        assert ((x - r).abs().max() / r.abs().max()).item() < tol
    t2w = 4.0 * ops[8] - 2.0 * ops[8].swapaxes(2, 3)
    e, e_ref = (float(t_row_finalize(i, o, ops[7], t2w)) for o in (out, ref))
    assert abs(e - e_ref) < tol * abs(e_ref)


# nv off the 8-wide tiles, the 32-step build stages and the 32-d Z1
# stages, and no = 2 (a contraction axis of 2 nv + 4); even no and nv
# (4, 38) take the two-element copies
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,stream_dtype,tol", [
    (torch.float64, None, 1e-12), (torch.float32, None, 1e-5),
    (torch.float32, torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("no,nv", [(2, 13), (2, 37), (3, 50), (4, 38)])
def test_kernel_ragged_tiles_and_stages_on_card(cuda_device, no, nv, dtype,
                                                stream_dtype, tol):
    args = _row_args(_operands(no, nv, cuda_device, dtype, seed=7))
    for i in range(no):
        out = t_energy_row(i, *args, no, stream_dtype=stream_dtype)
        torch.cuda.synchronize()
        ref = t_energy_row_reference(i, *args, no, stream_dtype=stream_dtype)
        for x, r in zip(out, ref):
            assert x.dtype == r.dtype and x.shape == r.shape
            assert ((x - r).abs().max() / r.abs().max()).item() < tol


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands_on_card(cuda_device):
    no, nv = 3, 10
    args = list(_row_args(_operands(no, nv, cuda_device)))
    bad_dtype = args.copy()
    bad_dtype[0] = bad_dtype[0].float()
    with pytest.raises(TypeError):
        t_energy_row(0, *bad_dtype, no)                 # mixed dtypes
    with pytest.raises(TypeError):
        t_energy_row(0, *(x.half() for x in args), no)  # float16
    strided = args.copy()
    strided[4] = strided[4].transpose(2, 3)
    with pytest.raises(ValueError):
        t_energy_row(0, *strided, no)                   # not contiguous
    short = args.copy()
    short[2] = short[2][:, :, :, :nv - 1].contiguous()
    with pytest.raises(ValueError):
        t_energy_row(0, *short, no)                     # Evovv shape
    with pytest.raises(ValueError):
        t_energy_row(0, *args, no - 1)                  # no mismatch
    with pytest.raises(ValueError):
        t_energy_row(no, *args, no)                     # row out of range
    mixed = args.copy()
    mixed[5] = mixed[5].cpu()
    with pytest.raises(ValueError):
        t_energy_row(0, *mixed, no)                     # mixed devices
    derived = t_row_derived(args[1], args[2], args[7], torch.bfloat16)
    with pytest.raises(ValueError):                     # derived in bf16
        t_energy_row(0, *args, no, derived=derived)


@pytest.mark.cuda
@pytest.mark.parametrize("stream_dtype", [None, torch.bfloat16])
def test_kernel_with_derived_operands_on_card(cuda_device, stream_dtype):
    no, nv = 4, 19
    args = _row_args(_operands(no, nv, cuda_device))
    derived = t_row_derived(args[1], args[2], args[7], stream_dtype)
    # the same launch either way, up to the order of the atomic sums
    tol = 1e-12 if stream_dtype is None else 1e-5
    for i in range(no):
        out = t_energy_row(i, *args, no, stream_dtype=stream_dtype,
                           derived=derived)
        ref = t_energy_row(i, *args, no, stream_dtype=stream_dtype)
        torch.cuda.synchronize()
        for x, r in zip(out, ref):
            assert ((x - r).abs().max() / r.abs().max()).item() < tol


def test_layout_fits_every_shape_up_to_200_occupied_and_900_virtual():
    """The occupied index l is staged in chunks (csrc/t_row.cu): every
    (no, nv) with no <= 200 and nv <= 900 fits a block's shared memory,
    in float64 and float32 tiles, with at least one l a chunk."""
    for acc in (8, 4):
        for no in range(1, 201):
            for nv in range(1, 901):
                assert k2.t_row_chunk(no, nv, acc) >= 1
                assert (k2.t_row_smem_bytes(no, nv, acc)
                        <= k2._SMEM_BUDGET < k2._SMEM_MAX)


def test_layout_stages_every_occupied_index_where_it_fits():
    """One chunk (the unchunked layout) wherever the whole occupied range
    fits: (24, 114) and (24, 216) keep their 112448 and 125504 bytes;
    past the old ceiling (104, 20) takes two chunks, as large as fit."""
    assert k2.t_row_chunk(24, 114, 8) == 24
    assert k2.t_row_smem_bytes(24, 114, 8) == 112448
    assert k2.t_row_chunk(24, 216, 8) == 24
    assert k2.t_row_smem_bytes(24, 216, 8) == 125504
    lc = k2.t_row_chunk(104, 20, 8)
    assert 52 <= lc < 104
    assert k2.t_row_layout_bytes(lc, 20, 8) <= k2._SMEM_BUDGET
    assert k2.t_row_layout_bytes(lc + 1, 20, 8) > k2._SMEM_BUDGET
    # an nv with no room for even one l is refused, not mis-sized
    assert k2.t_row_chunk(4, 1400, 8) == 0
    assert k2.t_row_smem_bytes(4, 1400, 8) > k2._SMEM_BUDGET


@pytest.mark.cuda
def test_layout_mirror_matches_the_library_on_card(cuda_device):
    lib = k2._library()
    for no, nv in ((4, 19), (24, 114), (24, 216), (104, 20), (200, 900),
                   (4, 1400)):
        for acc in (8, 4):
            assert lib.t_row_chunk(no, nv, acc) == k2.t_row_chunk(no, nv, acc)
            assert (lib.t_row_smem_bytes(no, nv, acc)
                    == k2.t_row_smem_bytes(no, nv, acc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,stream_dtype,tol", [
    (torch.float64, None, 1e-13), (torch.float32, None, 1e-5),
    (torch.float32, torch.bfloat16, 2e-2)])
def test_kernel_past_one_chunk_on_card(cuda_device, dtype, stream_dtype,
                                       tol):
    """(no, nv) = (104, 20), past what one chunk holds (a ragged
    second chunk, a ragged 8-wide tile), rows 0 and 103."""
    no, nv = 104, 20
    args = _row_args(_operands(no, nv, cuda_device, dtype, seed=9))
    for i in (0, no - 1):
        out = t_energy_row(i, *args, no, stream_dtype=stream_dtype)
        torch.cuda.synchronize()
        ref = t_energy_row_reference(i, *args, no, stream_dtype=stream_dtype)
        for x, r in zip(out, ref):
            assert ((x - r).abs().max() / r.abs().max()).item() < tol
