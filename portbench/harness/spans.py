"""The port's program spans of a traced window, for the metric readers.

`pycc_tpu_torch.utils.timing.spans()` holds the latest profiling session
by span name: count, host seconds, device seconds (between a CUDA event
pair on the current stream at each record's entry and exit), bytes and
parent.  The traced window is that session.  A port without spans gives
no table, and its readers return None: the metric is left out of the
line.
"""


def table(run):
    """The spans of the run's traced window, or None (an untraced run, or
    a port without spans)."""
    if run.trace is None:
        return None
    try:
        from pycc_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    return spans()


def device_s(rows, name, parent=None):
    """Device seconds of span `name` (only where its parent is `parent`,
    if given), or None where it has none."""
    row = rows.get(name) if rows else None
    if row is None or row["device_s"] is None:
        return None
    if parent is not None and row["parent"] != parent:
        return None
    return row["device_s"]


def ms_per(rows, name, per, parent=None):
    """Device milliseconds of span `name` over the count of span `per`."""
    t = device_s(rows, name, parent)
    if t is None or per not in rows or not rows[per]["count"]:
        return None
    return 1e3 * t / rows[per]["count"]
