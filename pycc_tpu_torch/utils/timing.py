"""Named wall-clock timers with call counts, program spans, and a
profiler trace.

Each solver owns its own `Timers`; `report()` logs an aggregate table.
A timer around device work measures what the host waited for: the solver
loop synchronises once per iteration when it reads the energy.

A span (`span(name, nbytes=0)`, and every `Timers.time(name)`) records
only while a torch.profiler session records in this thread: the
benchmark's traced window, or `trace(logdir)`.  Off, it costs one check of
the profiler's state.  On, it opens a record_function range
"pycc.<name>", so its host range sits in the profiler's trace on the
device's clock; on a CUDA device it records a timed event pair on the
current stream; it notes the enclosing span as its parent and adds
`nbytes`.  `spans()` is the table of the latest session by name, its
device times resolved behind one synchronisation.  Spans change no result
and no order of operations.

`trace(logdir)` profiles a block with torch.profiler, the counterpart of
pycc_tpu's jax.profiler trace, and writes the session's spans beside it.
"""

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

from .log import logger as log

SPAN_PREFIX = "pycc."


class _Row:
    __slots__ = ("count", "host_s", "device_s", "nbytes", "parents",
                 "events")

    def __init__(self):
        self.count, self.host_s, self.nbytes = 0, 0.0, 0
        # None until a record on a CUDA device is resolved
        self.device_s = None
        self.parents = set()
        # the (start, end) CUDA event pairs not yet resolved
        self.events = []


class _Registry(threading.local):
    """The spans of the latest profiling session.  It mirrors the
    profiler's own state, which is per thread, so it is one per thread
    rather than an object passed down the solvers.  `live` is False once a
    span or `spans()` has found tracing off, or `trace()` starts a session:
    the next span that records empties the table first."""

    def __init__(self):
        self.rows = {}
        self.stack = []
        self.live = False


_REGISTRY = _Registry()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "nbytes", "rf", "start", "t0")

    def __init__(self, name, nbytes):
        self.name, self.nbytes = name, nbytes

    def __enter__(self):
        reg = _REGISTRY
        if not reg.live:
            reg.rows.clear()
            reg.live = True
        reg.stack.append(self.name)
        # record_function's C++ form: the same host range in the trace at
        # a tenth of its cost (1.3 against 11 us on the CPU)
        self.rf = _RecordFunctionFast(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self.rf.__exit__(*exc)
        reg = _REGISTRY
        reg.stack.pop()
        row = reg.rows.get(self.name)
        if row is None:
            row = reg.rows[self.name] = _Row()
        row.count += 1
        row.host_s += host_s
        row.nbytes += self.nbytes
        row.parents.add(reg.stack[-1] if reg.stack else None)
        if end is not None:
            row.events.append((self.start, end))
        return False


def span(name, nbytes=0):
    """A program span named `name` around the enclosed block, recording
    only under a profiler session (the module's text); `nbytes` adds to
    the span's byte count."""
    if not _profiler_enabled():
        _REGISTRY.live = False
        return _OFF
    return _Span(name, nbytes)


def spans():
    """{name: {count, host_s, device_s, bytes, parent}} of the latest
    profiling session.  device_s is the device's time between each
    record's two events, busy or idle, summed (None for a name recorded
    on the CPU only); parent is the enclosing span's name (None at the
    top), or the names joined by '|' where records had several.  Read with
    tracing off, the session is over: the next span that records starts a
    new table."""
    if not _profiler_enabled():
        _REGISTRY.live = False
    rows = _REGISTRY.rows
    if any(r.events for r in rows.values()):
        torch.cuda.synchronize()
    out = {}
    for name, r in rows.items():
        if r.events:
            r.device_s = (r.device_s or 0.0) + 1e-3 * sum(
                a.elapsed_time(b) for a, b in r.events)
            r.events = []
        parents = sorted(r.parents, key=lambda p: p or "")
        out[name] = dict(
            count=r.count, host_s=r.host_s, device_s=r.device_s,
            bytes=r.nbytes,
            parent=parents[0] if len(parents) == 1 else "|".join(
                p or "-" for p in parents))
    return out


class Timers:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name):
        """Host seconds and calls of `name`, always; the span of the same
        name under a profiler session."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self):
        lines = ["%-30s %10s %8s" % ("timer", "total(s)", "calls")]
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append("%-30s %10.3f %8d"
                         % (name, self.total[name], self.count[name]))
        out = "\n".join(lines)
        log.info(out)
        return out


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block with torch.profiler: host activity and,
    when a card is present, its kernels, with the program's spans.  Yields
    the profiler (its `key_averages()` sums the time by operation); on
    exit the Chrome trace is written to <logdir>/trace.json (logdir None: a
    new temporary directory), which chrome://tracing or Perfetto reads,
    and the session's `spans()` to <logdir>/spans.json."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="pycc_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _REGISTRY.live = False
    with profile(activities=acts, acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(spans(), f, indent=1, sort_keys=True)
