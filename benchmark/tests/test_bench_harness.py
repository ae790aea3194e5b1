"""The harness on the CPU at tiny sizes: files found by name, the contract's
names, the module rules, the window's arithmetic, and whole runs of every
cell through the port's plain CPU path against the reference."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, REPO]

from harness import bench, spec, stats  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
# 64 x 32 pixels fill one block of K1's 2,048 lanes: no padded lane
TINY = {'box': dict(width=64, height=32),
        'city': dict(width=32, height=24, n_blocks=2, subdiv=1,
                     ground_subdiv=2, accel='stream', texture_size=16,
                     facade_textures=3)}


def _spec():
    return spec.load_json(spec.spec_path())


def test_every_file_is_found_by_name():
    s = _spec()
    for w in s['workloads']:
        cell = spec.Cell(w['name'], s)
        assert cell.traffic['name'] == w['traffic']
        assert cell.config['name'] == w['config']
        assert hasattr(cell.scene(), 'describe')
        assert hasattr(cell.reference(), 'expected')
        assert set(cell.check['limits']) >= {'px_err_mean'}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m['name']).read)
        if any(m['name'].endswith('_roofline_pct') for m in cell.per_layer):
            assert cell.roofline is not None, w['name']
            assert cell.roofline['ops_per_sample'] > 0


def test_names_and_units_use_the_allowed_characters():
    s = _spec()
    assert set(s) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    names = []
    for c in s['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        names.append(c['name'])
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith(tuple(p + '/' for p in s['paths']))
    for w in s['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
        cfg = spec.load_json(os.path.join(REPO, next(
            c['file'] for c in s['configs'] if c['name'] == w['config'])))
        traffic = spec.load_json(os.path.join(
            BENCH, 'workloads', w['traffic'] + '.json'))
        assert traffic['spp'] == cfg['spp'], w['name']
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        names.append(w['name'])
    for m in s['end_to_end'] + s['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        names.append(m['name'])
    for m in s['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in s['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in {e['name'] for e in s['end_to_end']}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m['name'] == 'setup_s' for m in s['end_to_end'])


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, '-c', f'import sys; sys.path[:0] = {[BENCH, REPO]!r}\n'
         + code + '\nprint(" ".join(sorted({m.split(".")[0] for m in '
         'sys.modules})))'], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _loaded_after(
        'from harness import spec\n'
        'for c in spec.load_json(spec.spec_path())["configs"]:\n'
        '    cfg = spec.load_json(spec.REPO_DIR + "/" + c["file"])\n'
        '    spec.load_module("reference", cfg["reference"])\n'
        '    spec.load_module("scenes", cfg["scene"])')
    assert not loaded & {'jax', 'jaxlib', 'flax', 'hydracore3_tpu',
                         'hydracore3_torch'}


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        'import torch; torch.set_num_threads(2)\n'
        'from harness import bench, spec\n'
        'cell = spec.Cell("box-final", spec.load_json(spec.spec_path()))\n'
        'cell.traffic = dict(cell.traffic, spp=2)\n'
        'out = bench.run_cell(cell, 5, 0.2, False, "cpu", 0.0, '
        'overrides=dict(width=64, height=32))\n'
        'assert out["correct"], out')
    assert 'hydracore3_torch' in loaded
    assert not loaded & set(bench.FORBIDDEN)


def test_forbidden_modules_compare_whole_top_level_names():
    assert bench.forbidden_modules(['jax.numpy', 'hydracore3_torch.render',
                                    'jaxtyping', 'numpy']) == ['jax']
    assert bench.forbidden_modules(['hydracore3_tpu.render']) == [
        'hydracore3_tpu']


def test_a_variant_of_a_metric_is_read_by_its_measurement(tmp_path):
    assert spec.reader('device_idle_pct.batched').__file__.endswith(
        'metrics/device_idle_pct.py')
    assert spec.reader('k1_roofline_pct').__file__.endswith(
        'metrics/k1_roofline_pct.py')
    with pytest.raises(FileNotFoundError):
        spec.reader('no_such_metric.batched')


def test_a_run_refuses_when_it_cannot_read_the_regen_iterations(
        monkeypatch):
    """Where the port launches K1 under another name than the one the
    harness wraps, the run stops with the reason, not with a frame the
    reference follows for no iterations."""
    from hydracore3_torch.models import megakernel as MK
    inner, render = MK.regen_pass, MK.render

    def bypass(*args, **kw):
        seen = MK.regen_pass
        MK.regen_pass = inner
        try:
            return render(*args, **kw)
        finally:
            MK.regen_pass = seen

    monkeypatch.setattr(MK, 'render', bypass)
    cell = _cell('box-final', 2)
    with pytest.raises(RuntimeError, match='regen iterations'):
        bench.run_cell(cell, 5, 0.2, False, 'cpu', time.perf_counter(),
                       overrides=TINY['box'])


def test_window_arithmetic_on_synthetic_frames():
    # 3 frames of 100, 200 and 100 samples; 0.5 s of window in all
    frames = [dict(start=0.0, end=0.1, samples=100),
              dict(start=0.1, end=0.4, samples=200),
              dict(start=0.4, end=0.5, samples=100)]
    assert stats.window_seconds(frames) == pytest.approx(0.5)
    assert stats.rate(frames) == pytest.approx(800.0)
    ms = stats.frame_ms(frames)
    assert ms == pytest.approx([100.0, 300.0, 100.0])
    # nearest rank: the 95th of 20 values is the 19th, over all of them
    assert stats.percentile(range(1, 21), 95) == 19
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _cell(name, spp):
    cell = spec.Cell(name, _spec())
    cell.traffic = dict(cell.traffic, spp=spp)
    return cell


@pytest.mark.parametrize('name,spp,trace', [('box-final', 8, False),
                                            ('box-final', 4, True),
                                            ('city-progressive', 2, False),
                                            ('city-progressive', 1, True)])
def test_a_tiny_run_of_each_cell_is_correct(name, spp, trace):
    cell = _cell(name, spp)
    out = bench.run_cell(cell, 2 ** 40 + 7, 0.5, trace, 'cpu',
                         time.perf_counter(),
                         overrides=TINY[cell.config['scene']])
    assert out['correct'], out['checks']
    assert out['attempted'] >= 1
    assert list(out)[-1] == 'checks'
    want = cell.per_layer if trace else cell.end_to_end
    if not trace:
        assert set(out['metrics']) == {m['name'] for m in want}
    else:
        # on the CPU no kernel of the port shows in the trace: no roofline
        assert set(out['metrics']) <= {m['name'] for m in want}
        assert any(m.startswith('device_idle_pct') for m in out['metrics'])
        assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    rc = bench.main(['--workload', 'box-final', '--seed', '1',
                     '--seconds', '1', '--trace', '0'], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ''


def test_run_py_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    cannot run: the command exits non-zero and prints no result."""
    shutil.copy(spec.spec_path(), tmp_path / 'BENCHMARK.json')
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'box-final',
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_new_files_are_found_without_editing_any(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file plus its entry in BENCHMARK.json, are found by name."""
    root = tmp_path
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    s = _spec()
    cfg = spec.load_json(os.path.join(REPO, s['configs'][0]['file']))
    cfg.update(name='small-box', width=64, height=32, spp=2)
    (root / 'benchmark/configs/small-box.json').write_text(json.dumps(cfg))
    (root / 'benchmark/workloads/preview-2spp.json').write_text(json.dumps(
        dict(name='preview-2spp', why='test', integrator='mispt', spp=2,
             regen=True, route='megakernel')))
    (root / 'benchmark/checks/small-preview.json').write_text(json.dumps(
        dict(pixels=64, limits=dict(px_err_mean=1e-3, spp_short=0.0,
                                    frames_unlike=0))))
    (root / 'benchmark/metrics/frames_in_window.py').write_text(
        'def read(run):\n    return len(run.frames)\n')
    s['configs'].append(dict(s['configs'][0], name='small-box',
                             file='benchmark/configs/small-box.json'))
    s['workloads'].append(dict(name='small-preview', config='small-box',
                               traffic='preview-2spp', chips=1, why='test'))
    s['end_to_end'].append(dict(name='frames_in_window', unit='frames',
                                better='higher', bound=0.25,
                                source='host_clock',
                                workloads=['small-preview']))
    (root / 'BENCHMARK.json').write_text(json.dumps(s))
    code = (
        'import sys, json, torch; torch.set_num_threads(2)\n'
        f'sys.path[:0] = ["{root}/benchmark", "{REPO}"]\n'
        'from harness import bench, spec\n'
        f'cell = spec.Cell("small-preview", spec.load_json("{root}/BENCHMARK.json"), root="{root}")\n'
        'out = bench.run_cell(cell, 3, 0.3, False, "cpu", 0.0)\n'
        'print(json.dumps(out))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'], res['checks']
    assert res['metrics']['frames_in_window']['value'] >= 1
    assert 'setup_s' in res['metrics']


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'box-final',
         '--seed', '77', '--seconds', '2', '--trace', '0'], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'] and res['device']['platform'] == 'gpu'
