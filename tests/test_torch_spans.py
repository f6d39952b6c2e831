"""The port's program spans (utils/timing.py) on the CPU.

With no profiler a solve records nothing and never enters
record_function, makes no CUDA event and never synchronises.  Under a
torch.profiler session the solver's spans carry its counts and parents:
the CCSD iteration, its residual and DIIS, the init's host-to-device copy
with its bytes, each DF ladder block's W assembly, and the three parts of
real-time CC's right-hand side.  Results are bitwise the same with
tracing on and off, each session starts from an empty table, and
`trace(logdir)` writes the table beside the Chrome trace.
"""

import contextlib
import functools
import io
import json

import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu_torch.rt import integrators
from pycc_tpu_torch.rt.lasers import gaussian_laser
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils import timing
from torch.profiler import ProfilerActivity, profile

from .common import H2O

CONV = 1e-10


@functools.lru_cache(maxsize=None)
def _wfn():
    return run_rhf(H2O, "sto-3g", freeze_core=True)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _ccwfn(storage, nblocks=None):
    kw = dict(df_tol=1e-12, df_nblocks=nblocks) if storage == "df" else {}
    return pycc_tpu_torch.ccwfn(_wfn(), storage=storage, device="cpu", **kw)


def _solve(storage, nblocks=None, **kw):
    cc = _ccwfn(storage, nblocks)
    e = _quiet(cc.solve_cc, CONV, CONV, **kw)
    return cc, e


@contextlib.contextmanager
def _traced():
    with profile(activities=[ProfilerActivity.CPU]):
        yield


@pytest.fixture
def empty():
    """An empty span table, whatever an earlier test in this process
    recorded."""
    timing._REGISTRY.rows.clear()
    timing._REGISTRY.live = False
    yield


def _refuse(*args, **kw):
    raise AssertionError("called with tracing off")


@pytest.mark.parametrize("storage", ["full", "df"])
def test_off_records_nothing_and_calls_nothing(empty, monkeypatch,
                                               storage):
    monkeypatch.setattr(timing, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    cc, _ = _solve(storage, nblocks=2)
    assert cc.converged
    assert timing.spans() == {}
    # the host timers keep counting with tracing off
    assert cc.timers.count["ccwfn.residual"] == cc.niter


@pytest.mark.parametrize("max_diis", [8, 0])
def test_full_solve_records_the_solver_spans(empty, max_diis):
    with _traced():
        cc, _ = _solve("full", max_diis=max_diis)
    s = timing.spans()
    n = cc.niter
    assert s["ccwfn.iteration"]["count"] == n
    assert s["ccwfn.iteration"]["parent"] is None
    assert s["ccwfn.residual"]["count"] == n
    assert s["ccwfn.residual"]["parent"] == "ccwfn.iteration"
    if max_diis:
        assert s["ccwfn.diis"]["count"] == n
        assert s["ccwfn.diis"]["parent"] == "ccwfn.iteration"
    else:
        assert "ccwfn.diis" not in s
    h2d = s["hamiltonian.h2d"]
    assert h2d["count"] == 1 and h2d["bytes"] == _wfn().ERI_ao.nbytes
    assert h2d["parent"] == "ccwfn.hamiltonian"
    # the CPU has host times and no device time
    assert all(r["device_s"] is None for r in s.values())
    assert s["ccwfn.residual"]["host_s"] < s["ccwfn.iteration"]["host_s"]
    for name, r in s.items():
        if name in cc.timers.count:
            assert cc.timers.count[name] == r["count"], name


@pytest.mark.parametrize("nblocks", [1, 3])
def test_df_solve_records_each_ladder_block(empty, nblocks):
    with _traced():
        cc, _ = _solve("df", nblocks=nblocks)
    s = timing.spans()
    # ladder_apply's a-blocks: nv split into blocks of ceil(nv / nblocks)
    blocks = len(range(0, cc.nv, -(-cc.nv // nblocks)))
    assert blocks == min(nblocks, cc.nv)
    assert s["ccwfn.residual"]["count"] == cc.niter
    assert s["ladder.assemble"]["count"] == blocks * cc.niter
    assert s["ladder.assemble"]["parent"] == "ccwfn.residual"
    assert s["ladder.assemble"]["bytes"] == 0


@functools.lru_cache(maxsize=None)
def _rt(storage):
    cc, _ = _solve(storage)
    lam = pycc_tpu_torch.cclambda(cc, _quiet(pycc_tpu_torch.cchbar, cc))
    _quiet(lam.solve_lambda, CONV, CONV)
    V = gaussian_laser(0.01, 0.0, 0.01, center=0.05)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, V)
    return rt, rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)


def _two_steps(storage):
    rt, y = _rt(storage)
    ode = integrators.rk4(0.01)
    t = 0.0
    for _ in range(2):
        y = ode(rt.f, t, y)
        t += ode.h
    return y


@pytest.mark.parametrize("storage", ["full", "df"])
def test_rt_steps_record_the_three_parts(empty, storage):
    _rt(storage)
    with _traced():
        _two_steps(storage)
    s = timing.spans()
    for name in ("rtcc.f", "rtcc.t_side", "rtcc.lambda_side",
                 "hbar.rebuild"):
        assert s[name]["count"] == 8, name
    assert s["rtcc.f"]["parent"] is None
    assert s["rtcc.t_side"]["parent"] == "rtcc.f"
    assert s["rtcc.lambda_side"]["parent"] == "rtcc.f"
    assert s["hbar.rebuild"]["parent"] == "rtcc.lambda_side"
    if storage == "df":
        # both sides assemble their ladder's W
        assert s["ladder.assemble"]["parent"] == (
            "rtcc.lambda_side|rtcc.t_side")


@pytest.mark.parametrize("storage", ["full", "df"])
def test_results_are_bitwise_equal_traced_or_not(empty, storage):
    cc_off, e_off = _solve(storage, nblocks=2)
    with _traced():
        cc_on, e_on = _solve(storage, nblocks=2)
    assert e_on == e_off and cc_on.niter == cc_off.niter
    assert torch.equal(cc_on.t1, cc_off.t1)
    assert torch.equal(cc_on.t2, cc_off.t2)
    y_off = _two_steps(storage)
    with _traced():
        y_on = _two_steps(storage)
    assert torch.equal(y_on, y_off)


@pytest.mark.parametrize("between", ["read", "untraced"])
def test_a_second_session_starts_empty(empty, between):
    df, full = _ccwfn("df", 2), _ccwfn("full")
    with _traced():
        _quiet(df.solve_cc, CONV, CONV)
    if between == "read":
        assert timing.spans()["ladder.assemble"]["count"] == 2 * df.niter
    else:
        _quiet(_ccwfn("full").solve_cc, CONV, CONV)
    with _traced():
        _quiet(full.solve_cc, CONV, CONV)
    s = timing.spans()
    assert "ladder.assemble" not in s
    assert s["ccwfn.iteration"]["count"] == full.niter


@pytest.mark.parametrize("storage", ["full", "df"])
def test_trace_writes_the_spans_beside_the_trace(empty, tmp_path, storage):
    cc = _ccwfn(storage, 2)
    with timing.trace(str(tmp_path)):
        _quiet(cc.solve_cc, CONV, CONV)
    with open(tmp_path / "spans.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(timing.spans()))
    assert written["ccwfn.iteration"]["count"] == cc.niter
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"pycc.ccwfn.iteration", "pycc.ccwfn.residual"} <= names
