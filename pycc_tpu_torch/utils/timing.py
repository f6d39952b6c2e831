"""Named wall-clock timers with call counts, and a profiler trace.

Each solver owns its own `Timers`; `report()` logs an aggregate table.
A timer around device work measures what the host waited for: the solver
loop synchronises once per iteration when it reads the energy.
`trace(logdir)` profiles a block with torch.profiler, the counterpart of
pycc_tpu's jax.profiler trace.
"""

import contextlib
import os
import tempfile
import time
from collections import defaultdict

from .log import logger as log


class Timers:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name):
        t0 = time.perf_counter()
        try:
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
    when a card is present, its kernels.  Yields the profiler (its
    `key_averages()` sums the time by operation); on exit the Chrome trace
    is written to <logdir>/trace.json (logdir None: a new temporary
    directory), which chrome://tracing or Perfetto reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="pycc_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
