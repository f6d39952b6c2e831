"""The port's HBAR against pycc_tpu's on the same synthetic Hamiltonian and
amplitudes (f64; only the summation order differs, hence 1e-12), and the
cchbar wrapper on a converged CPU ccwfn.

`synthetic_inputs` and `hbars` here are shared by the other
post-convergence test files."""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from pycc_tpu.cchbar import build_hbar as jbuild_hbar
from pycc_tpu.utils import mp2_guess as jmp2, synthetic_hamiltonian as jsynth
from pycc_tpu_torch.cchbar import BLOCKS, build_hbar as tbuild_hbar
from pycc_tpu_torch.utils.synth import synthetic_hamiltonian as tsynth

NO, NV, SEED = 4, 12, 3
MODELS = ["CCD", "CC2", "CCSD"]


@functools.lru_cache(maxsize=None)
def synthetic_inputs():
    """(jH, tH, t1, t2, l1, l2): the synthetic Hamiltonian of both
    packages, the MP2 t2, and seeded t1, l1, l2 (numpy)."""
    jH = jsynth(NO, NV, seed=SEED)
    tH = tsynth(NO, NV, seed=SEED, device="cpu")
    _, t2, _ = jmp2(jH)
    rng = np.random.default_rng(11)
    t1 = 0.01 * rng.standard_normal((NO, NV))
    l1 = 0.02 * rng.standard_normal((NO, NV))
    l2 = 0.02 * rng.standard_normal((NO, NO, NV, NV))
    l2 = l2 + l2.transpose(1, 0, 3, 2)
    return jH, tH, t1, np.array(t2), l1, l2


@functools.lru_cache(maxsize=None)
def hbars(model):
    """(pycc_tpu's HBar, the port's HBar) for the synthetic inputs."""
    jH, tH, t1, t2, _, _ = synthetic_inputs()
    jhb = jbuild_hbar(model, jH.F, jH.ERI, jH.L, jnp.asarray(t1),
                      jnp.asarray(t2), NO)
    thb = tbuild_hbar(model, tH.F, tH.ERI, tH.L, torch.from_numpy(t1),
                      torch.from_numpy(t2), NO)
    return jhb, thb


def gap(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.cpu().numpy())))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("model", MODELS)
def test_hbar_blocks_match_pycc_tpu(model, block):
    jhb, thb = hbars(model)
    assert gap(getattr(jhb, block), getattr(thb, block)) < 1e-12


@pytest.mark.parametrize("model", MODELS)
def test_hvvvv_is_contiguous_and_the_efab_operand_is_made_once(model):
    _, thb = hbars(model)
    assert thb.Hvvvv.is_contiguous()
    W = thb.Hvvvv_efab
    assert W.is_contiguous() and W is thb.Hvvvv_efab
    assert torch.equal(W, thb.Hvvvv.permute(2, 3, 0, 1))


def test_cchbar_wrapper_exposes_the_blocks_of_a_converged_ccwfn():
    import pycc_tpu_torch
    from pycc_tpu_torch.scf import run_rhf

    from .common import H2O
    cc = pycc_tpu_torch.ccwfn(run_rhf(H2O, "sto-3g"), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
        hb = pycc_tpu_torch.cchbar(cc)
    ref = tbuild_hbar("CCSD", cc.H.F, cc.H.ERI, cc.H.L, cc.t1, cc.t2, cc.no)
    for name in BLOCKS:
        assert torch.equal(getattr(hb, name), getattr(ref, name)), name
    assert cc.timers.count["hbar.build"] == 1
    assert hb.Hvvvv_efab is hb.hbar.Hvvvv_efab
