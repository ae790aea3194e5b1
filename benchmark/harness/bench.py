"""One run of one cell: set-up, the measured window, the traced metrics and
the check that decides ``correct``.

A cell is a closed loop of frames: the next frame is asked for when the
last one is on the host.  The window holds every frame started before
``--seconds`` ran out; rates are taken over all of them, tails over all of
them.  With ``--trace 1`` the window runs under ``torch.profiler`` and the
cell's per-layer metrics are read from that trace; otherwise its
end-to-end metrics are reported.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from . import port, spec, stats
from .trace import FRAME_SPAN, TraceView

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hydracore3_tpu')


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one the run may not load."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in modules}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read: the window's frames, the set-up time,
    the trace (None without ``--trace 1``), the frame's pixels and the
    cell's traffic and roofline files."""

    def __init__(self, cell, frames, setup_s, trace, pixels):
        self.frames = frames
        self.setup_s = setup_s
        self.trace = trace
        self.pixels = pixels
        self.roofline = cell.roofline
        self.traffic = cell.traffic


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def window(scene, meta, traffic, seconds, rng, device, trace=False):
    """The measured closed loop.  Returns (frames, kept images, trace):
    per frame its host start and end, samples and the persistent-lane
    iterations it ran; the images of one frame drawn from ``rng``
    (reservoir) and of the last frame."""
    import torch
    frames, kept = [], {}
    span = port.RegenSpan()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        t_stop = time.perf_counter() + seconds
        while True:
            it0 = span.iters
            t0 = time.perf_counter()
            if t0 >= t_stop:
                break
            with torch.profiler.record_function(FRAME_SPAN):
                img, samples = port.frame(scene, meta, traffic)
            t1 = time.perf_counter()
            frames.append(dict(start=t0, end=t1, samples=samples,
                               iters=span.iters - it0,
                               spp=int(traffic['spp'])))
            if rng.random() * len(frames) < 1.0:
                kept['drawn'] = (len(frames) - 1, img)
            kept['last'] = (len(frames) - 1, img)
    finally:
        if prof is not None:
            _sync(device)
            prof.__exit__(None, None, None)
        span.close()
    if traffic.get('regen'):
        span.verify(frames, torch.device(device).type == 'cuda')
    return frames, kept, (TraceView.from_profiler(prof) if trace else None)


def pixel_ids(cell, desc, seed):
    """The pixels the check compares, drawn from the seed."""
    W, H = desc['width'], desc['height']
    rng = np.random.default_rng([seed, 2])
    return np.sort(rng.choice(W * H, size=min(cell.check['pixels'], W * H),
                              replace=False))


def px_err(got, want) -> float:
    """The mean over pixels of each pixel's largest RGB gap, relative to
    the reference pixel's mean RGB (at least 0.01), each capped at 1 (a
    non-finite gap counts 1).  ``got``, ``want``: [K, >=3]."""
    got = np.asarray(got, np.float64)[:, :3]
    want = np.asarray(want.to('cpu').double() if hasattr(want, 'to')
                      else want, np.float64)[:, :3]
    gap = np.abs(got - want).max(1) / np.maximum(want.mean(1), 0.01)
    gap = np.where(np.isfinite(gap), np.minimum(gap, 1.0), 1.0)
    return float(gap.mean())


def check(cell, desc, frames, kept, device, seed):
    """The comparison that decides ``correct``: every number with its limit.

    ``px_err_mean``: ``px_err`` of the frame against the plain reference
    over pixels drawn from the seed; the larger of the drawn and the last
    frame's.  ``spp_short``: how far the frame's samples a pixel fall short
    of the traffic's spp.  ``frames_unlike``: window frames whose samples
    or iterations differ from the first frame's (every frame renders the
    same inputs)."""
    import torch
    ref = cell.reference()
    lim = cell.check['limits']
    W, H = desc['width'], desc['height']
    ids = pixel_ids(cell, desc, seed)
    f0 = frames[0]
    unlike = sum((f['samples'], f['iters']) != (f0['samples'], f0['iters'])
                 for f in frames)
    spp = int(cell.traffic['spp'])
    short = max(max(0.0, spp - f['samples'] / (W * H)) for f in frames)
    pid = torch.as_tensor(ids, device=device)
    errs, wants = [], {}
    for which in ('drawn', 'last'):
        k, img = kept[which]
        work = (frames[k]['samples'], frames[k]['iters'])
        if work not in wants:       # frames of the same work: one reference
            wants[work] = ref.expected(desc, pid, frames[k], device)
        errs.append(px_err(img.reshape(-1, img.shape[-1])[ids], wants[work]))
    nums = dict(px_err_mean=max(errs), spp_short=short, frames_unlike=unlike)
    return {k: dict(value=v, limit=lim[k]) for k, v in nums.items()}


def run_cell(cell, seed, seconds, trace, device, t_start, overrides=None):
    """Set-up, window, metrics and check of one run; returns the result
    object (without printing it)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dict(cell.config, **(overrides or {}))
    desc = cell.scene().describe(config, seed)
    t_build = time.perf_counter()
    scene, meta = port.build(desc, device, config.get('accel', 'auto'))
    route = port.route(scene, meta, cell.traffic)
    if route != cell.traffic['route']:
        raise RuntimeError(f'{cell.name}: the port routes this frame to '
                           f'{route}, the traffic expects '
                           f"{cell.traffic['route']}")
    t_warm = time.perf_counter()
    port.frame(scene, meta, cell.traffic)       # compiles on a first run
    _sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    _log(f'set-up {setup_s:.3f} s: start to build {t_build - t_start:.3f}, '
         f'build {t_warm - t_build:.3f}, warm frame {t_end - t_warm:.3f}')
    frames, kept, tv = window(scene, meta, cell.traffic, seconds,
                              np.random.default_rng([seed, 1]), device, trace)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == 'cuda' else 0)
    n_pix = desc['width'] * desc['height']
    run = Run(cell, frames, setup_s, tv, n_pix)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m['name']).read(run)
        if v is not None:
            metrics[m['name']] = dict(value=float(v), unit=m['unit'])
    ms = sorted(stats.frame_ms(frames))
    half = len(frames) // 2
    _log(f'window: {len(frames)} frames, '
         f'{stats.window_seconds(frames):.3f} s; frame ms min '
         f'{ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}'
         + (f'; samples/s first half {stats.rate(frames[:half]):.6g}, '
            f'second {stats.rate(frames[half:]):.6g}' if half else ''))
    del scene, meta
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(cell, desc, frames, kept, device, seed)
    _log(f'reference {time.perf_counter() - t_ref:.3f} s')
    correct = all(c['value'] <= c['limit'] for c in checks.values())
    dev = dict(platform='gpu' if torch.device(device).type == 'cuda'
               else 'cpu',
               kind=(torch.cuda.get_device_name(device)
                     if torch.device(device).type == 'cuda' else 'cpu'),
               count=1, memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=len(frames),
               failed=checks['frames_unlike']['value'], metrics=metrics,
               device=dev)
    if tv is not None:
        dev.update(busy_s=tv.busy_s, window_s=tv.window_s)
        out['breakdown'] = dict(device_ops=tv.device_ops(),
                                idle_gaps=tv.idle_gaps())
    out['checks'] = checks
    return out


def main(argv, t_start):
    args = _parse(argv)
    bench = spec.load_json(spec.spec_path())
    cell = spec.Cell(args.workload, bench)
    import torch
    need = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f'{cell.name} needs {need} CUDA device(s); found {have}')
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda:0',
                   t_start)
    bad = forbidden_modules()
    if bad:
        _log(f'the run loaded {", ".join(bad)}: no result')
        return 3
    for k, c in out['checks'].items():
        _log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out))
    return 0
