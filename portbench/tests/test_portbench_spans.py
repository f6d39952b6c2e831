"""The readers of the program-span metrics (harness/spans.py and
metrics/{residual_ms, w_assembly_ms, diis_ms, h2d_gbps, rhs_ms, rhs_t_ms,
rhs_hbar_ms, rhs_lambda_ms}.py): None untraced, None for a port without
spans or without device times, and each value from a table of spans."""

import contextlib
import io
import warnings

import pytest
import torch

import pycc_tpu_torch
from pycc_tpu_torch.utils import timing
from portbench.harness.cell import Run
from portbench.harness.spec import Spec


def _row(count, device_s, parent, nbytes=0):
    return dict(count=count, host_s=device_s, device_s=device_s,
                bytes=nbytes, parent=parent)


# one DF job of 23 iterations and 9 a-blocks, two full inits, two rk4
# steps
TABLE = {
    "ccwfn.iteration": _row(23, 9.6, None),
    "ccwfn.residual": _row(23, 9.2, "ccwfn.iteration"),
    "ccwfn.diis": _row(23, 0.046, "ccwfn.iteration"),
    "ladder.assemble": _row(207, 5.52, "ccwfn.residual"),
    "hamiltonian.h2d": _row(2, 1.0, "ccwfn.hamiltonian",
                            nbytes=2 * 3439853568),
    "rtcc.f": _row(8, 1.84, None),
    "rtcc.t_side": _row(8, 0.4, "rtcc.f"),
    "rtcc.lambda_side": _row(8, 1.4, "rtcc.f"),
    "hbar.rebuild": _row(8, 1.04, "rtcc.lambda_side"),
}

EXPECTED = {
    "residual_ms.ccsd": 400.0,
    "residual_ms.full": 400.0,
    "w_assembly_ms.ccsd": 240.0,
    "diis_ms.ccsd": 2.0,
    "diis_ms.full": 2.0,
    "h2d_gbps.full": 6.879707136,
    "h2d_gbps.ccsd_t": 6.879707136,
    "rhs_ms.rt": 230.0,
    "rhs_t_ms.rt": 50.0,
    "rhs_hbar_ms.rt": 130.0,
    "rhs_lambda_ms.rt": 45.0,
}


def _run(traced):
    return Run("cc", {}, {}, [{}], 1.0, 1.0, 0,
               object() if traced else None)


def test_every_span_metric_has_an_entry_and_a_reader():
    spec = Spec()
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    for name in EXPECTED:
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert len(entries[name]["workloads"]) == 1
        assert callable(spec.reader(name))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_value_from_a_table(monkeypatch, name):
    monkeypatch.setattr(timing, "spans", lambda: TABLE)
    read = Spec().reader(name)
    assert read(_run(True)) == pytest.approx(EXPECTED[name], rel=1e-12)
    # untraced: no table is read
    assert read(_run(False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_spans(monkeypatch, name):
    """A port without `spans` (an older commit) and an empty table give
    None, not an error."""
    read = Spec().reader(name)
    monkeypatch.setattr(timing, "spans", lambda: {})
    assert read(_run(True)) is None
    monkeypatch.delattr(timing, "spans")
    assert read(_run(True)) is None


def test_assembly_elsewhere_is_not_read(monkeypatch):
    """W assemblies under another parent (a real-time right-hand side's
    two sides) are no CCSD residual's."""
    table = dict(TABLE)
    table["ladder.assemble"] = _row(16, 0.2, "rtcc.lambda_side|rtcc.t_side")
    monkeypatch.setattr(timing, "spans", lambda: table)
    assert Spec().reader("w_assembly_ms.ccsd")(_run(True)) is None
    assert Spec().reader("residual_ms.ccsd")(_run(True)) == pytest.approx(
        400.0)


def test_a_traced_cpu_solve_has_counts_but_no_device_time():
    """A real table from a tiny solve under the profiler on the CPU: the
    spans are there, with their counts and bytes, and every reader
    returns None, since no device time exists."""
    from portbench.harness.inputs import make_inputs
    from portbench.tests.common import TINY
    cfg = dict(Spec().config("h2o6_vdz"), **TINY["h2o6_vdz"])
    cfg["generator"] = dict(cfg["generator"], rank=80, scale=0.5)
    inputs = make_inputs(cfg, 5, torch.device("cpu"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cc = pycc_tpu_torch.ccwfn(inputs, device="cpu")
        cc.solve_cc(1e-8, 1e-8, maxiter=3)
    rows = timing.spans()
    assert rows["ccwfn.residual"]["count"] == cc.niter == 3
    assert rows["ccwfn.residual"]["device_s"] is None
    assert rows["hamiltonian.h2d"]["bytes"] == inputs.ERI_ao.nbytes
    spec = Spec()
    for name in EXPECTED:
        assert spec.reader(name)(_run(True)) is None, name
