"""The share of the traced window in which no kernel, copy or set ran on
the card (the profiler's CUDA timeline)."""


def read(run):
    tv = run.trace
    if tv is None or tv.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tv.busy_s / tv.window_s)
