"""The readers of the port's spans (``harness/spans.py`` and the metrics
that read ``hc3.*`` spans) on hand-built traces whose spans, kernels and
gaps are known, and on a trace without the spans (a program that does not
make them), where each returns nothing."""
from __future__ import annotations

import os
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH]

from harness import spans, spec  # noqa: E402
from harness.trace import FRAME_SPAN, TraceView  # noqa: E402


def _run(host, dev):
    return types.SimpleNamespace(trace=TraceView(host, dev))


def _batched():
    """A 10 s window of one frame of two passes.  Host events: (name,
    start, end, device seconds of the kernels the event launched)."""
    host = [
        (FRAME_SPAN, 0.0, 10.0, 0.0),
        ('hc3.render', 0.5, 9.5, 0.0),
        ('hc3.pass', 1.0, 4.0, 0.0),
        ('hc3.pass', 5.0, 8.0, 0.0),
        ('hc3.gather.light', 1.5, 2.0, 0.0),
        ('aten::index', 1.6, 1.65, 0.2),
        ('cudaLaunchKernel', 1.61, 1.62, 0.0),
        ('hc3.gather.texel', 2.5, 2.95, 0.0),
        ('aten::index', 2.6, 2.65, 0.3),
        ('cudaLaunchKernel', 2.61, 2.62, 0.0),
        ('aten::mul', 3.0, 3.05, 0.7),          # in the pass, no gather
        ('cudaLaunchKernel', 3.01, 3.02, 0.0),
        ('hc3.sync.grid_key', 3.6, 3.9, 0.0),
        ('aten::copy_', 4.5, 4.55, 0.0),        # between the passes
        ('cudaLaunchKernel', 4.51, 4.52, 0.0),
        ('hc3.gather.light', 5.5, 6.0, 0.0),
        ('aten::index', 5.6, 5.65, 0.1),
        ('cuLaunchKernel', 5.61, 5.62, 0.0),
        ('hc3.sync.readback', 8.5, 9.0, 0.0),
    ]
    dev = [('k', 1.6, 1.8), ('k', 2.6, 2.9), ('k', 3.0, 3.7),
           ('k', 5.6, 5.7), ('memcpy', 8.6, 8.8)]
    return host, dev


def _bare():
    """The same window with the port's spans taken out."""
    host, dev = _batched()
    return [h for h in host if not h[0].startswith('hc3.')], dev


def _read(metric, run):
    return spec.reader(metric).read(run)


def test_light_rows_ms_per_pass():
    # the two light spans launch 0.2 + 0.1 s of kernels over two passes
    assert _read('light_rows_ms_per_pass', _run(*_batched())) == \
        pytest.approx(150.0)
    assert _read('light_rows_ms_per_pass', _run(*_bare())) is None


def test_texel_taps_ms_per_pass():
    assert _read('texel_taps_ms_per_pass', _run(*_batched())) == \
        pytest.approx(150.0)
    assert _read('texel_taps_ms_per_pass', _run(*_bare())) is None


def test_launches_per_pass():
    # four launches inside the passes, the one between them left out
    assert _read('launches_per_pass', _run(*_batched())) == \
        pytest.approx(2.0)
    assert _read('launches_per_pass', _run(*_bare())) is None


def test_sync_idle_pct_charges_each_gap_from_the_read_to_the_next_op():
    # the gap after the grid key, 3.7 to the light rows' kernel at 5.6; the
    # readback's from its start at 8.5 to its copy at 8.6, and from 8.8 to
    # the window's end: 3.2 s of the 10 s window
    run = _run(*_batched())
    assert _read('sync_idle_pct', run) == pytest.approx(32.0)
    assert _read('sync_idle_pct.batched', run) == pytest.approx(32.0)
    assert _read('sync_idle_pct', _run(*_bare())) is None


def test_idle_inside_the_spans_stops_at_their_ends():
    # span_split's idle inside a span: 3.7-3.9 in the grid key, 8.5-8.6
    # and 8.8-9.0 in the readback
    tv = _run(*_batched()).trace
    assert spans.idle_seconds_inside(tv, ('hc3.sync.*',)) == \
        pytest.approx(0.5)
    assert spans.idle_seconds_inside(tv, ('hc3.sync.grid_key',)) == \
        pytest.approx(0.2)
    assert spans.idle_seconds_from(tv, ('hc3.sync.grid_key',)) == \
        pytest.approx(1.9)


def test_sync_idle_pct_reaches_spans_far_back():
    # a sync span opened before thousands of short host operations still
    # takes the gap at its end, to the next kernel
    host = [(FRAME_SPAN, 0.0, 2.0, 0.0), ('hc3.sync.stop_rule', 0.0, 1.5,
                                          0.0)]
    host += [('aten::add', 1e-4 * k, 1e-4 * k + 5e-5, 0.0)
             for k in range(1, 5000)]
    dev = [('k', 0.0, 1.0), ('k', 1.6, 2.0)]
    assert _read('sync_idle_pct', _run(host, dev)) == pytest.approx(30.0)


def test_sync_idle_pct_leaves_out_the_idle_before_the_read():
    # the device is idle from 1.0; the read opens at 1.5 and takes the gap
    # from there to the next kernel at 2.0
    host = [(FRAME_SPAN, 0.0, 4.0, 0.0),
            ('hc3.sync.samples', 1.5, 1.7, 0.0)]
    dev = [('k', 0.0, 1.0), ('k', 2.0, 4.0)]
    assert _read('sync_idle_pct', _run(host, dev)) == pytest.approx(12.5)


def test_pack_ms_per_frame():
    host = [(FRAME_SPAN, 0.0, 2.0, 0.0), ('hc3.render', 0.0, 1.0, 0.0),
            ('hc3.mk.pack', 0.1, 0.3, 0.0), ('hc3.render', 1.0, 2.0, 0.0),
            ('hc3.mk.pack', 1.1, 1.2, 0.0)]
    dev = [('mega_regen_kernel', 0.4, 0.9), ('mega_regen_kernel', 1.3, 1.9)]
    assert _read('pack_ms_per_frame', _run(host, dev)) == \
        pytest.approx(150.0)
    # the batched frame has no pack
    assert _read('pack_ms_per_frame', _run(*_batched())) is None
    assert _read('pack_ms_per_frame', _run(*_bare())) is None


@pytest.mark.parametrize('metric', [
    'light_rows_ms_per_pass', 'texel_taps_ms_per_pass', 'launches_per_pass',
    'sync_idle_pct', 'pack_ms_per_frame'])
def test_no_trace_reads_nothing(metric):
    assert _read(metric, types.SimpleNamespace(trace=None)) is None
