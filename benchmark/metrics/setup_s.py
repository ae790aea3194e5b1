"""Process start to the first timed frame: imports, CUDA start-up, the
scene build, the kernels loaded (compiled on a first run in a checkout)
and one warm frame of the cell's own shape (host clock)."""


def read(run):
    return run.setup_s
