"""Sampling pipeline: penalties -> temperature -> top-k∘top-p -> multinomial.

PyTorch port of ``qwen3_tts_tpu/ops/sampling.py``. The uniform draw comes
from the PCG stream (``ops/rng.py``), so given the same logits and the same
uniform both packages select the same token:

* top-k keeps every logit >= the k-th largest (ties inclusive),
* top-p removes tokens whose *exclusive* cumulative probability already
  reached p; tokens equal to the smallest kept logit survive,
* multinomial takes the first index whose inclusive cumsum of probabilities
  reaches the uniform draw.

Penalty order: repetition penalty, then control-token suppression, then
min-new-tokens EOS blocking. Everything stays on the logits' device.

Every form works row by row on ``[batch, vocab]``: a batch of streams
passes its penalty masks as ``[B, vocab]`` and one uniform a stream
(``[B]``), and each row's token is the one its stream alone would draw.
On the card PyTorch's sums and prefix sums over a row take other bits at
other row counts, so the batched frame loops sample with ``sample_rows``,
whose sums run in an order the row alone fixes there (``ops/rows.py``): a
stream draws the same codes at every batch size. ``sample`` keeps PyTorch's
(fewer launches: the batch-1 loop's frame is one stream at every call).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models import tokens as T
from .rows import row_cumsum, row_sum

NEG_INF = float("-inf")


@dataclass(frozen=True)
class SamplingConfig:
    """Sampling hyperparameters."""

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.05
    eos_token_id: int = T.CODEC_EOS
    min_new_tokens: int = 2

    @property
    def greedy(self) -> bool:
        return self.temperature < 0.01


class _Sums(NamedTuple):
    """A row's sum (kept as a last axis of 1) and its inclusive prefix sums."""

    total: Callable[[torch.Tensor], torch.Tensor]
    prefix: Callable[[torch.Tensor], torch.Tensor]


_PLAIN = _Sums(lambda x: x.sum(dim=-1, keepdim=True), lambda x: torch.cumsum(x, dim=-1))
_ROWS = _Sums(row_sum, row_cumsum)


def _exclusive_cumsum(probs: torch.Tensor, sums: _Sums = _PLAIN) -> torch.Tensor:
    cumulative = sums.prefix(probs)
    return torch.cat([torch.zeros_like(cumulative[..., :1]), cumulative[..., :-1]], dim=-1)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep logits >= the k-th largest value per row; rest -> -inf."""
    k = min(k, logits.shape[-1])
    threshold = torch.topk(logits, k, dim=-1).values[..., k - 1 : k]
    return torch.where(logits >= threshold, logits, NEG_INF)


def top_p_filter(logits: torch.Tensor, p: float, sums: _Sums = _PLAIN) -> torch.Tensor:
    """Nucleus filtering via descending sort + exclusive-cumsum threshold."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.exp(sorted_desc - sorted_desc.amax(dim=-1, keepdim=True))
    probs = probs / sums.total(probs)
    kept = torch.where(_exclusive_cumsum(probs, sums) >= p, float("inf"), sorted_desc)
    min_kept = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits >= min_kept, logits, NEG_INF)


def multinomial(probs: torch.Tensor, uniform: torch.Tensor, sums: _Sums = _PLAIN) -> torch.Tensor:
    """First index whose inclusive cumulative probability >= uniform.

    ``probs``: [batch, vocab]; ``uniform``: scalar or [batch]. Returns [batch]
    int64 token indices (index 0 when no prefix reaches the draw, as the
    JAX package's argmin does).
    """
    vocab = probs.shape[-1]
    cumulative = sums.prefix(probs)
    u = torch.as_tensor(uniform, dtype=probs.dtype, device=probs.device)
    hit = cumulative >= u.reshape(-1, 1)
    positions = torch.arange(1, vocab + 1, dtype=probs.dtype, device=probs.device)
    masked = torch.where(hit, positions, float(vocab + 1))
    return torch.argmin(masked, dim=-1)


def _fused_top_k_top_p(logits: torch.Tensor, k: int, p: float, sums: _Sums = _PLAIN) -> torch.Tensor:
    """top-k then top-p using only the top-k values (no full-vocab sort).

    Equivalent to top_k_filter followed by top_p_filter: after the top-k mask
    only k finite logits remain, so the nucleus statistics are determined by
    the k largest values.
    """
    k = min(k, logits.shape[-1])
    top_vals = torch.topk(logits, k, dim=-1).values  # [batch, k], descending
    thr_k = top_vals[..., k - 1 : k]
    probs = torch.exp(top_vals - top_vals[..., :1])
    probs = probs / sums.total(probs)
    kept = torch.where(_exclusive_cumsum(probs, sums) >= p, float("inf"), top_vals)
    min_kept = kept.amin(dim=-1, keepdim=True)
    threshold = torch.maximum(min_kept, thr_k)
    return torch.where(logits >= threshold, logits, NEG_INF)


def sample(logits: torch.Tensor, cfg: SamplingConfig, uniform: torch.Tensor) -> torch.Tensor:
    """Full sampling pipeline on float32 logits [batch, vocab] -> [batch] ids."""
    return _sample(logits, cfg, uniform, _PLAIN)


def sample_rows(logits: torch.Tensor, cfg: SamplingConfig, uniform: torch.Tensor) -> torch.Tensor:
    """``sample`` with every sum and prefix sum over a row in an order the
    row alone fixes on the card: a row's token is the same at any batch size
    (on the CPU, ``sample``)."""
    return _sample(logits, cfg, uniform, _ROWS)


def _sample(logits: torch.Tensor, cfg: SamplingConfig, uniform: torch.Tensor, sums: _Sums) -> torch.Tensor:
    logits = logits.float()
    if cfg.temperature != 1.0 and cfg.temperature > 0.0:
        # A device tensor, not a Python scalar: CUDA turns division by a host
        # scalar into multiplication by its reciprocal, one bit off JAX.
        logits = logits / torch.full((), cfg.temperature, device=logits.device)
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    if cfg.top_k > 0 and 0.0 < cfg.top_p < 1.0:
        logits = _fused_top_k_top_p(logits, cfg.top_k, cfg.top_p, sums)
    elif cfg.top_k > 0:
        logits = top_k_filter(logits, cfg.top_k)
    elif 0.0 < cfg.top_p < 1.0:
        logits = top_p_filter(logits, cfg.top_p, sums)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / sums.total(probs)
    return multinomial(probs, uniform, sums)


def build_suppression_mask(
    vocab_size: int = T.CODEC_VOCAB_SIZE,
    eos_token_id: int = T.CODEC_EOS,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Boolean [vocab] mask: True on the control range [vocab-1024, vocab)
    except EOS."""
    ids = torch.arange(vocab_size, device=device)
    return (ids >= vocab_size - 1024) & (ids != eos_token_id)


def apply_repetition_penalty(
    logits: torch.Tensor, penalty_mask: torch.Tensor, penalty: float
) -> torch.Tensor:
    """Divide positive / multiply negative logits of previously-seen tokens.

    ``penalty_mask``: float [vocab], 1.0 where the token was sampled before.
    """
    if abs(penalty - 1.0) < 1e-9:
        return logits
    dev = logits.device
    factor = torch.where(
        logits > 0.0, torch.full((), 1.0 / penalty, device=dev), torch.full((), penalty, device=dev)
    )
    factor = torch.where(penalty_mask > 0.0, factor, torch.ones((), device=dev))
    return logits * factor


def apply_generation_penalties(
    logits: torch.Tensor,
    penalty_mask: torch.Tensor,
    suppression_mask: torch.Tensor,
    cfg: SamplingConfig,
    token_count: int,
) -> torch.Tensor:
    """Repetition penalty -> suppression -> min-new-tokens EOS block."""
    logits = apply_repetition_penalty(logits.float(), penalty_mask, cfg.repetition_penalty)
    logits = logits.masked_fill(suppression_mask, NEG_INF)
    if token_count < cfg.min_new_tokens:
        logits[..., cfg.eos_token_id] = NEG_INF  # masked_fill made a new tensor
    return logits
