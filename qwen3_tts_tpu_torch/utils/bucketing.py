"""Static-shape bucketing helpers (a copy of ``qwen3_tts_tpu/utils/bucketing.py``).

Bucketing dynamic lengths to a small set of sizes keeps the set of tensor
shapes small (and, later, CUDA-graph captures few) while padding stays exact
thanks to causal masking / causal convs.
"""

from __future__ import annotations


def next_bucket(n: int, multiple: int = 32, buckets: tuple[int, ...] | None = None) -> int:
    """Smallest bucket >= n: from an explicit bucket list, or the next
    multiple of ``multiple``."""
    if buckets is not None:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]
    return max(((n + multiple - 1) // multiple) * multiple, multiple)
