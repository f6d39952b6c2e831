"""What every kind of traffic (kinds/<kind>.py) shares: the device
synchronisation that closes a timing, and the harness's spans.

A kind is a module with a `Runner` class and a `judge` function.  The
Runner is made as Runner(cfg, traffic, inputs, device, precision), with
`devices=` (the cell's cards, `device` first) for a cell on more than one
card, so that a kind that runs on one card needs no such argument; it has
`setup()` (warm every shape the window uses, once), `window(seconds)`
(the measured loop, which sets `window_s` after a device
synchronisation), `units` (one record per job or step), `failed` (the
units that failed) and `outputs()` (what the window produced, for the
judge, with the rest of the program's state dropped).
judge(cfg, traffic, inputs, outputs, device) returns {name: number}, each
number a gap to the plain reference that limits/<cell>.json bounds.
"""

from torch.profiler import record_function


def sync(*devices):
    """Wait for every CUDA device among `devices`."""
    for device in devices:
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)


def span(name):
    """A harness span in the trace: 'portbench.<name>'."""
    return record_function("portbench." + name)
