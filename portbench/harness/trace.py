"""The device trace of a window, from torch.profiler, reduced.

`record(fn, cards)` runs fn() under torch.profiler (host and CUDA activity)
inside a `portbench.window` span and returns a `Trace`: the window's
bounds, every device interval (kernels, copies, sets) with its name and
its card, and the host spans and operations.  From it: each card's busy
seconds (the union of that card's device intervals inside the window; a
card of the cell with no event is idle all the window) and their mean
over the cell's cards, the kernel seconds of given names and the device
operations that took most time (summed over the cards), and the idle
gaps of every card summed by what the host was doing.  A trace with no
device event is refused: the profiler did not see the card.
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


def record(fn, cards=(0,)):
    """The Trace of fn()'s run on the cell's `cards` (CUDA indices)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
        for c in cards:
            torch.cuda.synchronize(c)
    return Trace.from_kineto(prof.profiler.kineto_results.events(), cards)


def _is_device(ev):
    """A kernel, copy or set on the device; not a host event, nor a
    record_function range that the profiler mirrors on the device."""
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    return (str(ev.device_type()).split(".")[-1] != "CPU"
            and not annotation and not ev.name().startswith(SPAN_PREFIX))


class Trace:
    """window: (start, end) ns; device: (name, start, end[, card])
    intervals, card 0 where none is given; host: (name, start, end);
    cards: the cell's cards, each idle where it has no interval (an
    interval on a card outside them is in no card's busy time)."""

    def __init__(self, window, device, host, cards=(0,)):
        self.t0, self.t1 = window
        self.device = sorted(((r + (0,))[:4] for r in device),
                             key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self.cards = list(cards)
        if not self.device:
            raise NoDeviceEvents("the profiler saw no CUDA kernel or copy in "
                                 "the window")
        self._merged = {c: self._merge(c) for c in self.cards}

    @classmethod
    def from_kineto(cls, events, cards=(0,)):
        device, host, window = [], [], None
        for ev in events:
            start = ev.start_ns()
            rec = (ev.name(), start, start + ev.duration_ns())
            if _is_device(ev):
                device.append(rec + (ev.device_index(),))
            elif str(ev.device_type()).split(".")[-1] != "CPU":
                continue
            elif rec[0] == WINDOW:
                window = rec[1:]
            else:
                host.append(rec)
        if window is None:
            raise RuntimeError("no %s span in the trace" % WINDOW)
        return cls(window, device, host, cards)

    def _merge(self, card):
        """The union of `card`'s intervals inside the window."""
        out = []
        for _, s, e, c in self.device:
            if c != card:
                continue
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
    def busy_s_by_card(self):
        """[each card's busy seconds], in the order of `cards`."""
        return [sum(e - s for s, e in self._merged[c]) * 1e-9
                for c in self.cards]

    @property
    def busy_s(self):
        """The busy seconds of the cell's cards, their mean."""
        by_card = self.busy_s_by_card
        return sum(by_card) / len(by_card)

    def kernel_seconds(self, patterns):
        """Device seconds of the events whose name holds any of
        `patterns`, summed over the cards."""
        return sum(e - s for name, s, e, _ in self.device
                   if any(p in name for p in patterns)) * 1e-9

    def device_ops(self, n=10):
        tot = defaultdict(int)
        for name, s, e, _ in self.device:
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
        """The idle time of every card inside the window, summed over the
        cards by what the host was doing at each gap's middle:
        '<harness span> / <innermost host operation>'."""
        spans = [h for h in self.host if h[0].startswith(SPAN_PREFIX)]
        starts = [h[1] for h in self.host]
        tot = defaultdict(int)
        for merged in self._merged.values():
            edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e <= s:
                    continue
                if e - s < LABEL_MIN_NS:
                    tot["(gaps under 20 us)"] += e - s
                else:
                    tot[self._host_label((s + e) // 2, starts,
                                         spans)] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns * 1e-9] for name, ns in top]
