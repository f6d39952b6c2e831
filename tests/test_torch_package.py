"""pycc_tpu_torch as a package: no JAX, explicit devices, and every
option outside the ported slice refused by name."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu_torch.scf import run_rhf

from .common import H2O

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wfn():
    return run_rhf(H2O, "sto-3g", freeze_core=True)


def test_import_loads_no_jax_or_triton():
    code = ("import sys, pycc_tpu_torch, pycc_tpu_torch.ops.kernels, "
            "pycc_tpu_torch.ops.kernels.triples, pycc_tpu_torch.triples, "
            "pycc_tpu_torch.utils.synth; "
            "print(sorted(m for m in ('jax', 'triton') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_pycc_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pycc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "pycc_tpu")]
    assert bad == []


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pycc_tpu_torch.ccwfn(_wfn(), device="cuda")


def test_entry_points_default_to_the_card():
    from pycc_tpu_torch.hamiltonian import Hamiltonian, build_hamiltonian
    from pycc_tpu_torch.utils.synth import synthetic_hamiltonian
    for fn in (pycc_tpu_torch.ccwfn.__init__, build_hamiltonian,
               Hamiltonian.from_numpy, synthetic_hamiltonian):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pycc_tpu_torch.ccwfn(_wfn())


@pytest.mark.parametrize("kwargs", [
    {"make_t3_density": True}, {"model": "CC3"}, {"real_time": True},
    {"storage": "blocked"}, {"local": "PNO"}, {"mesh": object()},
])
def test_options_outside_the_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pycc_tpu_torch.ccwfn(_wfn(), **kwargs)


def test_t3_scan_names_the_cc3_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        pycc_tpu_torch.ccwfn(_wfn(), t3_scan=True)


@pytest.mark.parametrize("kwargs", [
    {"bf16_until": 1e-3}, {"chk": "amps.npz"}, {"resume": True},
])
def test_solver_options_outside_the_slice_raise(kwargs):
    cc = pycc_tpu_torch.ccwfn(_wfn(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cc.solve_cc(**kwargs)


def test_bad_values_raise():
    with pytest.raises(ValueError):
        pycc_tpu_torch.ccwfn(_wfn(), model="CCSDT-1")
    with pytest.raises(ValueError):
        pycc_tpu_torch.ccwfn(_wfn(), precision="HP")
    with pytest.raises(TypeError):
        pycc_tpu_torch.ccwfn(_wfn(), no_such_option=1)
