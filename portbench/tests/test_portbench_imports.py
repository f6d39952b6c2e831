"""Nothing the command or the reference loads is JAX or pycc_tpu, compared
by whole top-level module names; the reference loads nothing of the port."""

import os
import subprocess
import sys

from portbench.harness.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pycc_tpu"}


def _top_level_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_harness_loads_no_jax_and_no_pycc_tpu():
    names = _top_level_after(
        "import portbench.run as r\n"
        "import portbench.harness.cell, portbench.harness.jobs\n"
        "import portbench.harness.trace, portbench.harness.check\n"
        "from portbench.harness.spec import Spec\n"
        "s = Spec()\n"
        "[s.reader(m['name']) for m in s.bench['end_to_end'] + "
        "s.bench['per_layer']]\n"
        "[s.kind(s.traffic(w['traffic'])['kind']) for w in "
        "s.bench['workloads']]")
    assert "pycc_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level_after(
        "import portbench.reference.ccsd, portbench.reference.lam\n"
        "import portbench.reference.triples, portbench.reference.rt\n"
        "import portbench.reference.hamiltonian")
    assert not names & (FORBIDDEN | {"pycc_tpu_torch"})


def test_forbidden_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "pycc_tpu_torch_x", sys)
    assert "pycc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_command_refuses_without_a_card(tmp_path):
    """No CUDA device here: exit 2 and no result line."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "h2o6_vdz.rt",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
