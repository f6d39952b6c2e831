"""The (T) scan's bf16 slabs and j-chunk (`t_vikings_scan(cc,
slab_dtype=, jc=)`, `t_vikings_scan_core(slab_dtype=)`) in the port
against pycc_tpu's, on H2O/cc-pVDZ (frozen core, (no, nv) = (4, 19)) on
the CPU.

test_004's two conditions hold for the port's bf16 (T): within
5e-3 |E(T)| of the float64 value and not equal to it.  On CPU tensors
`t_vikings_scan(slab_dtype=torch.bfloat16)` runs K2's plain rows in its
bf16 stream (operands rounded to bf16, float32 arithmetic), so it is held
to pycc_tpu's bf16 slab scan (bf16 arithmetic) at 1e-3 |E(T)|, the sum
of the two bf16 errors with room; the plain symmetric scan in bf16
(`t_vikings_scan_core`) is pycc_tpu's arithmetic and is held to it at
1e-9.  Over DF factors past the no nv^3 threshold (2^27, passed in
small here) slab_dtype is ignored, as pycc_tpu's k-chunked path ignores
it.
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
from pycc_tpu import triples as jtr

import pycc_tpu_torch
from pycc_tpu_torch import triples as ttr
from pycc_tpu_torch.ops.kernels.triples import t_energy_row

from .common import scf


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _wfn():
    return scf("H2O", "cc-pvdz")


@functools.lru_cache(maxsize=None)
def _port(storage="full"):
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu", storage=storage)
    _quiet(cc.solve_cc, 1e-10, 1e-10)
    return cc


@functools.lru_cache(maxsize=None)
def _pycc_tpu():
    """pycc_tpu's E(T) and bf16 E(T) as test_004 computes them."""
    cc = _quiet(pycc_tpu.ccwfn, _wfn())
    _quiet(cc.solve_cc, 1e-10, 1e-10)
    return (float(jtr.t_vikings_scan(cc)),
            float(jtr.t_vikings_scan(cc, slab_dtype=jnp.bfloat16)))


def test_bf16_scan_meets_test_004_and_pycc_tpu():
    et_ref, bf16_ref = _pycc_tpu()
    cc = _port()
    et = float(ttr.t_vikings_scan(cc))
    launches = t_energy_row.launches
    e16 = ttr.t_vikings_scan(cc, slab_dtype=torch.bfloat16)
    assert t_energy_row.launches == launches    # CPU tensors: plain rows
    assert e16.dtype == torch.float32 and e16.dim() == 0
    e16 = float(e16)
    assert abs(et - et_ref) < 1e-12
    assert abs(e16 - et) < 5e-3 * abs(et), (e16, et)
    assert abs(e16 - et) > 0.0
    assert abs(e16 - bf16_ref) < 1e-3 * abs(et), (e16, bf16_ref)


def test_bf16_scan_core_is_pycc_tpus_arithmetic():
    _, bf16_ref = _pycc_tpu()
    cc = _port()
    sl = ttr.scan_slices(cc)
    e16 = ttr.t_vikings_scan_core(*sl, cc.t1, cc.t2, cc.no,
                                  slab_dtype=torch.bfloat16)
    assert e16.dtype == torch.float32
    assert abs(float(e16) - bf16_ref) < 1e-9


@pytest.mark.parametrize("jc", [1, 4])
def test_jc_equals_the_default(jc):
    cc = _port()
    et = float(ttr.t_vikings_scan(cc))
    assert abs(float(ttr.t_vikings_scan(cc, jc=jc)) - et) < 1e-13
    sl = ttr.scan_slices(cc)
    core = float(ttr.t_vikings_scan_core(*sl, cc.t1, cc.t2, cc.no))
    assert abs(float(ttr.t_vikings_scan_core(*sl, cc.t1, cc.t2, cc.no,
                                             jc=jc)) - core) < 1e-13
    assert abs(core - et) < 1e-12


def test_df_past_the_threshold_ignores_slab_dtype():
    cc = _port("df")
    no, nv = cc.no, cc.nv
    et = ttr.t_vikings_scan(cc)
    below = ttr.t_vikings_scan(cc, slab_dtype=torch.bfloat16)
    past = ttr.t_vikings_scan(cc, slab_dtype=torch.bfloat16,
                              df_slab_max=no * nv ** 3 - 1)
    assert below.dtype == torch.float32 and 0 < abs(float(below - et)) \
        < 5e-3 * abs(float(et))
    assert past.dtype == torch.float64 and float(past) == float(et)
    # pycc_tpu's k-chunked path (the one its scan takes past 2^27) gives
    # the float64 value too
    from pycc_tpu.models.dfccsd import DFERI
    dfb = DFERI(*(jnp.asarray(x.numpy()) for x in cc.dfb))
    ref = jtr.t_vikings_scan_df_chunked(
        dfb, jnp.asarray(cc.H.F.numpy()), jnp.asarray(cc.t1.numpy()),
        jnp.asarray(cc.t2.numpy()), no)
    assert abs(float(ref) - float(past)) < 1e-12
