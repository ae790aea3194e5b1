"""The port's RNG streams are bit-identical to the JAX package's.

4096 pixels x 16 draws of every draw function, with a random live mask so
masked (dead-ray) updates are covered too.  Equal-RNG image parity rests
on this.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore3_tpu.ops import rng as JR
from hydracore3_torch.ops import rng as TR

N_PIX = 4096
N_DRAWS = 16


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_gen_init_bit_exact():
    ids = np.arange(N_PIX, dtype=np.int32) * 37 + 11
    j = np.asarray(JR.gen_init(jnp.asarray(ids)))
    t = TR.gen_init(torch.from_numpy(ids))
    assert t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) <= 0xFFFFFFFF
    np.testing.assert_array_equal(_u32(t), j)


@pytest.mark.parametrize('name', ['rnd_float4', 'rnd_float1', 'rnd_lgts'])
@pytest.mark.parametrize('masked', [False, True])
def test_draws_bit_exact(name, masked):
    rng = np.random.default_rng(7)
    ids = np.arange(N_PIX, dtype=np.int32)
    js = JR.gen_init(jnp.asarray(ids))
    ts = TR.gen_init(torch.from_numpy(ids))
    jf, tf = getattr(JR, name), getattr(TR, name)
    for _ in range(N_DRAWS):
        mask = rng.random(N_PIX) < 0.7 if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.from_numpy(mask)
        js, jv = jf(js, jm)
        ts, tv = tf(ts, tm)
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        # floats: bit-exact too (same u32 -> f32 rounding)
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))
