"""The port's native local solver over a CPU mesh against pycc_tpu's
over its 8-device CPU mesh (tests/conftest.py), on test_010's
H2O/cc-pVDZ (all electrons, PNO 1e-5): pycc_tpu lays the same stacks
over a 2 x 4 GSPMD mesh and jits the residuals; the port cuts them over
a 2 x 2 mesh of the CPU and contracts piece by piece.  The energies
agree at 1e-11."""

import contextlib
import io

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.parallel as jpar
import pycc_tpu_torch
from pycc_tpu_torch.parallel import Sharded, make_mesh

from .common import scf

KW = dict(local="PNO", local_cutoff=1e-5, it2_opt=False)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@pytest.mark.parametrize("model,pair_cutoff", [("CCSD", None),
                                               ("CCSD", 1e-3)])
def test_sharded_solver_equals_pycc_tpus_sharded(model, pair_cutoff):
    wfn = scf("H2O", "cc-pvdz", freeze_core=False)
    ref = _quiet(pycc_tpu.ccwfn, wfn, model=model, pair_cutoff=pair_cutoff,
                 mesh=jpar.make_mesh(), **KW)
    e_ref = _quiet(ref.lccwfn.solve_lcc, 1e-12, 1e-12, maxiter=100)
    cc = _quiet(pycc_tpu_torch.ccwfn, wfn, model=model, device="cpu",
                pair_cutoff=pair_cutoff,
                mesh=make_mesh(devices=["cpu"] * 4), **KW)
    assert any(isinstance(x, Sharded) for x in cc.lccwfn._pre.values())
    e = _quiet(cc.lccwfn.solve_lcc, 1e-12, 1e-12, maxiter=100)
    assert abs(e - e_ref) < 1e-11
