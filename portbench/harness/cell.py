"""One run of one cell: inputs, set-up, window, metrics, the judge.

`run_cell` is the whole of a run after the command's check for a card,
so that the CPU tests can drive it at a tiny size.
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
    peak_bytes: the device's allocation peak over the window; trace: a
    trace.Trace of the window (traced runs), else None."""

    def __init__(self, kind, cfg, traffic, units, window_s, setup_s,
                 peak_bytes, trace):
        self.kind, self.cfg, self.traffic = kind, cfg, traffic
        self.units, self.window_s, self.setup_s = units, window_s, setup_s
        self.peak_bytes, self.trace = peak_bytes, trace

    @property
    def no(self):
        return self.cfg["ndocc"] - self.cfg["nfzc"]

    @property
    def nv(self):
        return self.cfg["nbf"] - self.cfg["ndocc"]

    def seconds_per_unit(self):
        return self.window_s / len(self.units)


def _device_info(device, peak):
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1, memory_peak_bytes=peak)


def run_cell(spec, workload, seed, seconds, trace, device, t_start,
             precision=None):
    """(the result dict, the judge's rows, the per-unit records, the
    judge's seconds)."""
    cell = workload["name"]
    cfg = spec.config(workload["config"])
    traffic = spec.traffic(workload["traffic"])
    limits = spec.limits(cell)
    kind = spec.kind(traffic["kind"])
    cuda = device.type == "cuda"

    inputs = make_inputs(cfg, seed, device)
    runner = kind.Runner(cfg, traffic, inputs, device, precision)
    runner.setup()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        tr = tracing.record(lambda: runner.window(seconds))
    else:
        runner.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    run = Run(traffic["kind"], cfg, traffic, runner.units, runner.window_s,
              setup_s, peak, tr)
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

    dev = _device_info(device, peak)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = dict(device_ops=tr.device_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result, rows, run.units, t_judge
