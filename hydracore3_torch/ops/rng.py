"""The reference's per-thread PRNG (crandom.h:11-75), batched in torch.

Each ray carries a ``[2]`` uint32 state threaded through the whole render.
torch has no wrapping uint32 arithmetic, so states and draws are int64
tensors holding values in ``[0, 2^32)``: every product and shift is masked
back to 32 bits (int64 products wrap modulo 2^64, which keeps the low 32
bits exact).  The streams are bit-identical to ``hydracore3_tpu.ops.rng``.

All state updates are mask-aware: dead rays do not consume random numbers.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_SCALE = 1.0 / 4294967296.0


def _poly(x, a, b, c):
    """x * (x * x * a + b) + c, all mod 2^32."""
    x2 = (x * x) & M32
    return (x * ((x2 * a + b) & M32) + c) & M32


def gen_init(thread_ids: torch.Tensor) -> torch.Tensor:
    """RandomGenInit (crandom.h:25-36): int tensor [N] -> int64 state [N, 2]."""
    a = thread_ids.to(torch.int64) & M32
    x = _poly(a, 15731, 74323, 871483)
    y = _poly(a, 13734, 37828, 234234)
    state = torch.stack([x, y], dim=-1)
    # warm-up: seed % 7 NextState calls (int32 modulo of the seed)
    n_warm = torch.remainder(thread_ids.to(torch.int32), 7)
    for i in range(6):
        state, _ = _next_state_masked(state, n_warm > i)
    return state


def _next_state(state):
    """crandom.h NextState: returns (new_state, x)."""
    sx, sy = state[..., 0], state[..., 1]
    x = (sx * 17 + sy * 13123) & M32
    nx = ((x << 13) & M32) ^ x
    ny = sy ^ ((x << 7) & M32)
    return torch.stack([nx, ny], dim=-1), x


def _next_state_masked(state, mask):
    ns, x = _next_state(state)
    return torch.where(mask[..., None], ns, state), x


def _hash4(x):
    return torch.stack([_poly(x, 15731, 74323, 871483),
                        _poly(x, 13734, 37828, 234234),
                        _poly(x, 11687, 26461, 137589),
                        _poly(x, 15707, 789221, 1376312589)], dim=-1)


def u32_to_f32(u):
    """(float)(uint32) * 2^-32, rounded like the C++ cast: can reach 1.0f."""
    return u.to(torch.float32) * _SCALE


def _advance(state, mask):
    if mask is None:
        return _next_state(state)
    return _next_state_masked(state, mask)


def rnd_float4(state, mask=None):
    """rndFloat4_Pseudo: one NextState draw -> 4 floats in [0, 1]."""
    ns, x = _advance(state, mask)
    return ns, u32_to_f32(_hash4(x))


def rnd_float1(state, mask=None):
    """rndFloat1_Pseudo: one NextState draw -> 1 float."""
    ns, x = _advance(state, mask)
    return ns, u32_to_f32(_poly(x, 15731, 74323, 871483))


def rnd_lgts(state, mask=None):
    """GetRandomNumbersLgts (integrator_pt.cpp:30-35): two draws.

    Returns (state, float4(rands.xyz, rndId))."""
    state, rnd_id = rnd_float1(state, mask)
    state, rands = rnd_float4(state, mask)
    return state, torch.cat([rands[..., :3], rnd_id[..., None]], dim=-1)


# the reference's per-use streams (integrator_pt.cpp:26-37)
rnd_lens = rnd_float4
rnd_mats = rnd_float4
