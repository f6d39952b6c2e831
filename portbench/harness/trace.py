"""The device trace of a window, from torch.profiler, reduced.

`record(fn)` runs fn() under torch.profiler (host and CUDA activity) inside
a `portbench.window` span and returns a `Trace`: the window's bounds, every
device interval (kernels, copies, sets) with its name, and the host spans
and operations.  From it: the device's busy seconds (the union of the
device intervals inside the window), the kernel seconds of given names,
the device operations that took most time, and the idle gaps summed by
what the host was doing.  A trace with no device event is refused: the
profiler did not see the card.
"""

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
# the harness's own spans (record_function), the outer label of a gap
SPAN_PREFIX = "portbench."
# gaps shorter than this are launch latency: summed, not labelled
LABEL_MIN_NS = 20_000
# a breakdown's names are cut to this many characters
NAME_CHARS = 120


class NoDeviceEvents(RuntimeError):
    pass


def record(fn):
    """The Trace of fn()'s run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
        torch.cuda.synchronize()
    return Trace.from_kineto(prof.profiler.kineto_results.events())


def _is_device(ev):
    """A kernel, copy or set on the device; not a host event, nor a
    record_function range that the profiler mirrors on the device."""
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    return (str(ev.device_type()).split(".")[-1] != "CPU"
            and not annotation and not ev.name().startswith(SPAN_PREFIX))


class Trace:
    def __init__(self, window, device, host):
        self.t0, self.t1 = window
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        if not self.device:
            raise NoDeviceEvents("the profiler saw no CUDA kernel or copy in "
                                 "the window")
        self._merged = self._merge()

    @classmethod
    def from_kineto(cls, events):
        device, host, window = [], [], None
        for ev in events:
            start = ev.start_ns()
            rec = (ev.name(), start, start + ev.duration_ns())
            if _is_device(ev):
                device.append(rec)
            elif str(ev.device_type()).split(".")[-1] != "CPU":
                continue
            elif rec[0] == WINDOW:
                window = rec[1:]
            else:
                host.append(rec)
        if window is None:
            raise RuntimeError("no %s span in the trace" % WINDOW)
        return cls(window, device, host)

    def _merge(self):
        out = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self._merged) * 1e-9

    def kernel_seconds(self, patterns):
        """Device seconds of the events whose name holds any of
        `patterns`."""
        return sum(e - s for name, s, e in self.device
                   if any(p in name for p in patterns)) * 1e-9

    def device_ops(self, n=10):
        tot = defaultdict(int)
        for name, s, e in self.device:
            tot[name] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns * 1e-9] for name, ns in top]

    def _host_label(self, t, starts, spans):
        span = "-"
        for name, s, e in spans:
            if s <= t <= e:
                span = name[len(SPAN_PREFIX):]
        op = "-"
        k = bisect.bisect_right(starts, t)
        for name, s, e in reversed(self.host[max(0, k - 200):k]):
            if e >= t and not name.startswith(SPAN_PREFIX):
                op = name
                break
        return "%s / %s" % (span, op)

    def idle_gaps(self, n=10):
        """The device's idle time inside the window, summed by what the
        host was doing at each gap's middle: '<harness span> / <innermost
        host operation>'."""
        spans = [h for h in self.host if h[0].startswith(SPAN_PREFIX)]
        starts = [h[1] for h in self.host]
        tot = defaultdict(int)
        edges = [self.t0] + [x for iv in self._merged for x in iv] + [self.t1]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            if e - s < LABEL_MIN_NS:
                tot["(gaps under 20 us)"] += e - s
            else:
                tot[self._host_label((s + e) // 2, starts, spans)] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns * 1e-9] for name, ns in top]
