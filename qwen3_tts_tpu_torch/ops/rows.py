"""Sums and prefix sums over the last axis whose order the axis alone fixes.

On the card PyTorch sizes a reduction's lanes along a row, and a prefix
sum's block width, from the number of rows as well as from their length,
and it scans a lone row with another algorithm: one stream's RMSNorm took
other bits among 10 rows than among 80, and its sampling's prefix sums
alone than among 8 (``chip_smoke.py`` phase ``tp`` (d), an H100). A batched
stream then drew other codes than it draws alone. ``row_sum``,
``row_mean`` and ``row_cumsum`` fix the order by the row's length alone,
so a row's result depends on the row alone. On the CPU they are ``sum``,
``mean`` and ``cumsum``, as the JAX package's parity tests expect.

``row_cumsum`` is a Sklansky prefix network of elementwise adds, an order
no kernel heuristic chooses. ``row_sum`` cuts a row into chunks short
enough that PyTorch's reduction (``Reduce.cuh``) gives every row the same
lanes at any row count: a sum over the contiguous last axis takes
min(last_pow2(width), 32) lanes a row whatever the rows once its width
(elements, or float4 loads from 128 elements up) is below 64, so rows under
64 values, and from 128 to 255, sum in a fixed order (a norm's rows would
take log2(width) launches as a network).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SUM_CHUNK = 128  # values a chunk where the row divides into them (float4 loads: 32 lanes)
SUM_SHORT = 32  # otherwise


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1, keepdim=True)``; on the card in an order that the row's
    length fixes: rows of 64 to 127 or 256 and more values are summed as
    chunks (``SUM_CHUNK`` values where the row divides into them, else
    ``SUM_SHORT`` with zeros after the end), then the chunks' sums the same
    way."""
    return x.sum(dim=-1, keepdim=True) if x.device.type != "cuda" else _sum(x)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1, keepdim=True)``; on the card ``row_sum`` over the length."""
    return x.mean(dim=-1, keepdim=True) if x.device.type != "cuda" else _sum(x) / x.shape[-1]


def _sum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n < 64 or 128 <= n < 256:
        return x.sum(dim=-1, keepdim=True)
    chunk = SUM_CHUNK if n % SUM_CHUNK == 0 else SUM_SHORT
    x = F.pad(x, (0, -n % chunk))
    return _sum(x.reshape(*x.shape[:-1], -1, chunk).sum(dim=-1))


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, -1)``; on the card a Sklansky network over the row
    padded with zeros to a power of two: at step s = 1, 2, 4, ..., the upper
    half of every 2s-block adds the last value of its lower half."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=-1)
    n = x.shape[-1]
    return _scan(x.reshape(-1, n)).reshape(x.shape)


def _scan(x: torch.Tensor) -> torch.Tensor:
    r, n = x.shape
    width = 1 << (n - 1).bit_length()
    y = F.pad(x, (0, width - n))
    s = 1
    while s < width:
        blocks = y.reshape(r, width // (2 * s), 2 * s)
        y = torch.cat([blocks[..., :s], blocks[..., s:] + blocks[..., s - 1:s]], dim=-1).reshape(r, width)
        s *= 2
    return y[:, :n]
