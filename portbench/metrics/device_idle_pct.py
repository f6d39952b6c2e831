"""device_idle_pct.<cell suffix>: the share of the traced window in which no
kernel, copy or set ran on a card (the union of the card's CUDA intervals
of the profiler trace against the window's length), the mean over the
cell's cards."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
