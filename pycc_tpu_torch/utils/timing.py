"""Named wall-clock timers with call counts.

Each solver owns its own `Timers`; `report()` logs an aggregate table.
A timer around device work measures what the host waited for: the solver
loop synchronises once per iteration when it reads the energy.
"""

import contextlib
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
