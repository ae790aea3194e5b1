"""Samples (camera paths) completed in the window's frames, in millions,
over the window: from the first frame's start to the last frame's end
(host clock)."""
from harness import stats


def read(run):
    return stats.rate(run.frames) / 1e6
