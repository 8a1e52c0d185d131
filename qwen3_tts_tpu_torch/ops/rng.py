"""Seeded RNG matching the reference's PCG-XSH-RR 64/32 stream.

The generation loop consumes exactly one uniform per sampled semantic token,
in order. The stream is produced on the host with numpy uint64 arithmetic and
handed to the frame loop as a precomputed ``[max_draws]`` float32 tensor
indexed by the frame counter, exactly as ``qwen3_tts_tpu/ops/rng.py`` does,
so both packages draw the same uniforms for the same seed.
"""

from __future__ import annotations

import time

import numpy as np

_PCG_MULT = np.uint64(6364136223846793005)
_PCG_INC = np.uint64(1442695040888963407)
_SEED_MIX_MULT = np.uint64(2685821657736338717)


def pcg_init_state(seed: int) -> np.uint64:
    """state = seed * 2685821657736338717 + 1442695040888963407 (mod 2^64)."""
    with np.errstate(over="ignore"):
        return np.uint64(seed) * _SEED_MIX_MULT + _PCG_INC


def pcg_next(state: np.uint64) -> tuple[np.uint64, np.uint32]:
    """One PCG-XSH-RR 64/32 step: returns (new_state, 32-bit output)."""
    old = np.uint64(state)
    with np.errstate(over="ignore"):
        new = old * _PCG_MULT + _PCG_INC
    xorshifted = np.uint32(((old >> np.uint64(18)) ^ old) >> np.uint64(27))
    rot = int(old >> np.uint64(59)) & 31
    word = int(xorshifted)
    out = np.uint32(((word >> rot) | (word << (32 - rot))) & 0xFFFFFFFF)
    return new, out


def pcg_uniform_sequence(seed: int, n: int) -> np.ndarray:
    """First ``n`` uniforms in [0, 1) of the seeded stream, float32.

    Matches rand_f32: ``(output as f32) / (u32::MAX as f32)``. Note that
    u32::MAX rounds to 2^32 in float32, so the divisor is 4294967296.0f.
    """
    out = np.empty(n, dtype=np.float32)
    state = pcg_init_state(seed)
    for i in range(n):
        state, word = pcg_next(state)
        out[i] = np.float32(word) / np.float32(np.uint32(0xFFFFFFFF))
    return out


def unseeded_uniform_sequence(n: int) -> np.ndarray:
    """Non-deterministic uniforms for unseeded sessions (a time-seeded PCG
    stream; determinism is not promised without a seed)."""
    return pcg_uniform_sequence(time.time_ns() & 0xFFFFFFFFFFFFFFFF, n)
