"""The ray queries' share of their roofline: the frozen work of the
window's samples (``rooflines/<cell>.json``: K3's and K2's operations and
bytes a sample) at the card's peaks, over K3's and K2's device time in the
trace.  Nothing when the trace shows neither kernel or the cell has no
roofline file."""
from harness import peaks, port


def read(run):
    tv, rl = run.trace, run.roofline
    if tv is None or rl is None or rl.get('kernel') != 'K3+K2':
        return None
    t = tv.kernel_seconds(port.TRACE_KERNELS)
    if t <= 0.0:
        return None
    samples = sum(f['samples'] for f in run.frames)
    return 100.0 * peaks.bound_seconds(rl, samples) / t
