"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window (reset
at its start, after the inputs and the set-up state are made) / 1e9, on
the fullest card of the cell."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
