"""K1's share of its roofline: the frozen work of the window's samples
(``rooflines/<cell>.json``: operations and bytes a sample) at the card's
peaks, over K1's device time in the trace.  Nothing when the trace shows
no K1 launch or the cell has no roofline file."""
from harness import peaks, port


def read(run):
    tv, rl = run.trace, run.roofline
    if tv is None or rl is None or rl.get('kernel') != 'K1':
        return None
    k1 = tv.kernel_seconds(port.K1_KERNELS)
    if k1 <= 0.0:
        return None
    samples = sum(f['samples'] for f in run.frames)
    return 100.0 * peaks.bound_seconds(rl, samples) / k1
