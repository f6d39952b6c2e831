"""One run of one cell: inputs, set-up, window, metrics, the judge.

`run_cell` is the whole of a run after the command's check for a card,
so that the CPU tests can drive it at a tiny size.  It takes the cell's
cards (`devices`, the home card first; one device alone for a one-card
cell): the inputs, the set-up and the judge live on the home card, a
kind that takes `devices` (`kinds/cc.py`: a mesh of them) spreads over
them all, and the peak, the trace's busy time and `device` are read on
each.
"""

import gc
import time

import torch

from . import trace as tracing
from .check import verdict
from .inputs import make_inputs


class Run:
    """What the metric readers read (metrics/<name>.py: read(run)).

    kind: the traffic's kind (kinds/<kind>.py); cfg, traffic: the two
    files; units: the Runner's record of each job or step (kinds/cc.py,
    kinds/rt.py); window_s: the window by the
    host clock; setup_s: process start to the window;
    peak_bytes: the allocation peak over the window of the fullest card
    of the cell; peak_bytes_by_card: each card's (by default the one
    card's); trace: a trace.Trace of the window (traced runs), else
    None."""

    def __init__(self, kind, cfg, traffic, units, window_s, setup_s,
                 peak_bytes, trace, peak_bytes_by_card=None):
        self.kind, self.cfg, self.traffic = kind, cfg, traffic
        self.units, self.window_s, self.setup_s = units, window_s, setup_s
        self.peak_bytes, self.trace = peak_bytes, trace
        self.peak_bytes_by_card = ([peak_bytes] if peak_bytes_by_card is None
                                   else list(peak_bytes_by_card))

    @property
    def no(self):
        return self.cfg["ndocc"] - self.cfg["nfzc"]

    @property
    def nv(self):
        return self.cfg["nbf"] - self.cfg["ndocc"]

    def seconds_per_unit(self):
        return self.window_s / len(self.units)


def card_peaks(devices):
    """(the fullest card's allocation peak since its reset, [each card's
    peak]); 0 for a device that is not a CUDA card."""
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
             for d in devices]
    return max(peaks), peaks


def _device_info(devices, peaks):
    fullest = max(peaks)
    if devices[0].type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=fullest,
                    memory_peak_bytes_by_card=peaks)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(devices[0]),
                count=len(devices), memory_peak_bytes=fullest,
                memory_peak_bytes_by_card=peaks)


def run_cell(spec, workload, seed, seconds, trace, devices, t_start,
             precision=None):
    """(the result dict, the judge's rows, the per-unit records, the
    judge's seconds).  `devices`: the cell's cards, the home card first,
    or one device."""
    if isinstance(devices, torch.device):
        devices = [devices]
    devices = list(devices)
    device = devices[0]
    cell = workload["name"]
    cfg = spec.config(workload["config"])
    traffic = spec.traffic(workload["traffic"])
    limits = spec.limits(cell)
    kind = spec.kind(traffic["kind"])
    cuda = device.type == "cuda"

    inputs = make_inputs(cfg, seed, device)
    # a kind that runs on one card takes no `devices`, so a cell of more
    # chips stops here rather than leave its other cards idle
    extra = dict(devices=devices) if len(devices) > 1 else {}
    runner = kind.Runner(cfg, traffic, inputs, device, precision, **extra)
    runner.setup()
    cards = [d for d in devices if d.type == "cuda"]
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        tr = tracing.record(lambda: runner.window(seconds),
                            cards=[d.index for d in cards])
    else:
        runner.window(seconds)
    peak, peaks = card_peaks(devices)

    run = Run(traffic["kind"], cfg, traffic, runner.units, runner.window_s,
              setup_s, peak, tr, peaks)
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = runner.failed
    attempted = len(runner.units)

    out = runner.outputs()
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = kind.judge(cfg, traffic, inputs, out, device)
    del out
    t_judge = time.perf_counter() - t_judge
    correct, rows = verdict(numbers, limits, failed)

    dev = _device_info(devices, peaks)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        dev["busy_s_by_card"] = tr.busy_s_by_card
        result["breakdown"] = dict(device_ops=tr.device_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result, rows, run.units, t_judge
