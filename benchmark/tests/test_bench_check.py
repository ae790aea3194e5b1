"""The check that decides ``correct``, on the CPU at tiny sizes: the control
(the reference in bfloat16) and the timed path with a fault planted under
it must both come out not correct."""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, REPO]

from harness import bench, spec  # noqa: E402

# 64 x 32 pixels fill one block of K1's 2,048 lanes: no padded lane
TINY = {'box': dict(width=64, height=32),
        'city': dict(width=32, height=24, n_blocks=2, subdiv=1,
                     ground_subdiv=2, accel='stream', texture_size=16,
                     facade_textures=3)}
# a box frame of 12 spp or more needs a second launch of K1 at this size
CELLS = [('box-final', 16), ('box-final', 12), ('city-progressive', 2)]


def _cell(name, spp):
    cell = spec.Cell(name, spec.load_json(spec.spec_path()))
    cell.traffic = dict(cell.traffic, spp=spp)
    return cell


@pytest.mark.parametrize('name,spp', CELLS)
@pytest.mark.parametrize('seed', [3, 2 ** 33 + 1])
def test_the_control_fails_the_limit(name, spp, seed):
    """The reference computed in bfloat16 in the program's place reads far
    above the limit; the reference against itself reads 0."""
    import torch
    from tools import control
    cell = _cell(name, spp)
    tiny = TINY[cell.config['scene']]
    r = control.readings(cell, seed, 'cpu', overrides=tiny)
    limit = cell.check['limits']['px_err_mean']
    assert r['program'] <= limit
    assert r['control'] > 10 * limit
    desc = cell.scene().describe(dict(cell.config, **tiny), seed)
    ids = torch.arange(8)
    ref = cell.reference()
    a = ref.expected(desc, ids, dict(iters=r['iters'], spp=spp), 'cpu')
    assert bench.px_err(a.numpy(), a) == 0.0


def _stuck(inner):
    """Every launch after the first returns the state it was given."""
    def regen_pass(pk, xy, sf, su, k, depth, first=False, **kw):
        if first:
            return inner(pk, xy, sf, su, k, depth, first=first, **kw)
        return sf, su
    return regen_pass


def _half(inner):
    """Every other lane is left out after the first launch: it keeps its
    state."""
    def regen_pass(pk, xy, sf, su, k, depth, first=False, **kw):
        sf2, su2 = inner(pk, xy, sf, su, k, depth, first=first, **kw)
        if first:
            return sf2, su2
        sf2[:, 1::2], su2[:, 1::2] = sf[:, 1::2], su[:, 1::2]
        return sf2, su2
    return regen_pass


def _altered(inner):
    """The frame's values come out 1% off where they are produced."""
    def regen_finalize(pk, sf, su, integrator=2):
        img, nd = inner(pk, sf, su, integrator)
        return img * 1.01, nd
    return regen_finalize


def _unchanged_bounce(inner):
    """The bounce returns the state it was given."""
    def kernel_next_bounce(scene, meta, state, *args, **kw):
        return state
    return kernel_next_bounce


def _half_pass(inner):
    """Every other lane of a pass is left out: its sample adds nothing."""
    def _one_sample(*args, **kw):
        contrib, rng, px = inner(*args, **kw)
        contrib = contrib.clone()
        contrib[1::2] = 0.0
        return contrib, rng, px
    return _one_sample


def _altered_pass(inner):
    """A pass's contributions come out 1% off where they are produced."""
    def _one_sample(*args, **kw):
        contrib, rng, px = inner(*args, **kw)
        return contrib * 1.01, rng, px
    return _one_sample


# the faults each route can have, planted where the timed path computes
K1_FAULTS = [(_stuck, 'megakernel', 'regen_pass'),
             (_half, 'megakernel', 'regen_pass'),
             (_altered, 'megakernel', 'regen_finalize')]
BATCHED_FAULTS = [(_unchanged_bounce, 'integrator_pt', 'kernel_next_bounce'),
                  (_half_pass, 'render', '_one_sample'),
                  (_altered_pass, 'render', '_one_sample')]


@pytest.mark.parametrize('name,spp,fault,module,target', [
    (n, s, *f) for n, s in CELLS
    for f in (BATCHED_FAULTS if n.startswith('city') else K1_FAULTS)])
def test_a_fault_in_the_timed_path_is_not_correct(name, spp, fault, module,
                                                  target, monkeypatch):
    import importlib
    mod = importlib.import_module(
        'hydracore3_torch.' + ('render' if module == 'render'
                               else 'models.' + module))
    monkeypatch.setattr(mod, target, fault(getattr(mod, target)))
    cell = _cell(name, spp)
    out = bench.run_cell(cell, 11, 0.3, False, 'cpu', time.perf_counter(),
                         overrides=TINY[cell.config['scene']])
    assert not out['correct'], out['checks']


def test_the_sound_run_is_correct_on_several_seeds():
    cell = _cell('box-final', 4)
    errs = []
    for seed in (1, 2, 2 ** 35 + 3):
        out = bench.run_cell(cell, seed, 0.2, False, 'cpu',
                             time.perf_counter(), overrides=TINY['box'])
        assert out['correct'], out['checks']
        errs.append(out['checks']['px_err_mean']['value'])
    assert np.max(errs) < 1e-5
