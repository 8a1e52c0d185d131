"""Sample-rate conversion: windowed-sinc polyphase resampler (numpy).

A copy of ``qwen3_tts_tpu/audio/resample.py`` (held equal by
``tests/test_torch_copies.py``): sinc length 128, cutoff 0.95 of the lower
Nyquist, Blackman-Harris window, as a vectorized polyphase filter (exact
phase for rational ratios: 16k/22.05k/44.1k/48k -> 24k). Brings reference
audio to the model's native 24 kHz before x-vector extraction and ICL
encoding. Host code: it runs the native C++ kernel when built, else numpy.
"""

from __future__ import annotations

import math

import numpy as np

from .io import AudioBuffer


def _blackman_harris(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * i / (n - 1)
    return (
        0.35875
        - 0.48829 * np.cos(x)
        + 0.14128 * np.cos(2 * x)
        - 0.01168 * np.cos(3 * x)
    )


def resample(audio: AudioBuffer, target_rate: int, sinc_len: int = 128) -> AudioBuffer:
    """Resample to ``target_rate`` with a windowed-sinc polyphase filter."""
    if audio.sample_rate == target_rate:
        return AudioBuffer(audio.samples.copy(), target_rate)
    out = resample_array(audio.samples, audio.sample_rate, target_rate, sinc_len)
    return AudioBuffer(out, target_rate)


def resample_to_24k(audio: AudioBuffer) -> AudioBuffer:
    return resample(audio, 24000)


def resample_array(
    samples: np.ndarray, src_rate: int, dst_rate: int, sinc_len: int = 128
) -> np.ndarray:
    """Core resampler: float32 in, float32 out, length round(n * dst/src).

    Uses the native C++ kernel when built (``native.py``); this numpy
    implementation is the semantically-identical fallback.
    """
    from .. import native

    fast = native.resample_sinc(samples, src_rate, dst_rate, sinc_len)
    if fast is not None:
        return fast

    samples = np.asarray(samples, dtype=np.float64).reshape(-1)
    n_in = len(samples)
    n_out = int(round(n_in * dst_rate / src_rate))
    if n_in == 0 or n_out == 0:
        return np.zeros(0, np.float32)

    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g

    # Anti-aliasing cutoff at 0.95 of the lower Nyquist (rubato f_cutoff).
    cutoff = 0.95 * min(1.0, up / down)

    half = sinc_len // 2
    # Polyphase kernel: for each of `up` phases, taps over the input grid.
    # Output sample m sits at input position m * down / up = q + phase/up.
    t = np.arange(-half, half + 1, dtype=np.float64)  # input-grid tap offsets
    phases = np.arange(up, dtype=np.float64) / up
    # taps[p, j] = sinc(cutoff * (t[j] - phase_p)) * window
    x = t[None, :] - phases[:, None]
    kernel = cutoff * np.sinc(cutoff * x)
    window = _blackman_harris(2 * half + 1)
    kernel = kernel * window[None, :]

    padded = np.concatenate([np.zeros(half), samples, np.zeros(half + 1)])
    m = np.arange(n_out)
    pos_num = m * down  # position numerator over `up`
    q = pos_num // up  # integer input index
    p = pos_num - q * up  # phase index

    # Gather windows: out[m] = sum_j padded[q[m] + j] * kernel[p[m], j]
    idx = q[:, None] + np.arange(2 * half + 1)[None, :]
    idx = np.clip(idx, 0, len(padded) - 1)
    out = np.einsum("mj,mj->m", padded[idx], kernel[p])
    return out.astype(np.float32)
