"""Shared transformer ops for the talker and code-predictor stacks.

PyTorch port of ``qwen3_tts_tpu/ops/nn.py``, in the JAX package's layout:

* Layer weights are stacked along a leading layer axis (``[L, in, out]``,
  so a projection is ``x @ w``, or ``quant.mm`` for int8 weights);
  ``run_layer_stack`` loops over the layers.
* KV caches are fixed-shape ``[num_layers, batch, max_seq, kv_heads,
  head_dim]`` tensors. Where JAX updates them functionally, the port writes
  the new rows **in place** (no second copy of the cache per step).
* Attention masks are causal on absolute positions, so right-padded prompts
  and unwritten cache rows never change results.
* Norm and softmax accumulate in float32 and cast back; activations round to
  the compute dtype at the same points as the JAX package (a bf16 matmul
  returns bf16, elementwise ops round per op).

``run_layer_stack_tp`` is what GSPMD makes of ``run_layer_stack`` on a
tensor-parallel tree: each rank's slice on its device, an all-reduce after
each row-parallel product (``parallel/collectives``).

Left out: ``decode_attention_flash`` (nothing in the JAX package calls it,
and it measured slower than dense attention there).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce, broadcast, device_scope
from . import quant
from .quant import mm
from .rows import row_mean, row_sum


@dataclass(frozen=True)
class LayerStackConfig:
    """Shape config for a stack of identical decoder layers."""

    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    # When set, ``run_layer_stack(..., positions_thw=)`` takes [3, S]
    # position streams through interleaved MRoPE (``mrope_cos_sin``); plain
    # positions always use standard RoPE (the two coincide for TTS).
    mrope_section: tuple[int, int, int] | None = None
    # Tiered decode attention (``tiered_decode_attention``) on the batch-1
    # layer path; off by default, as in the JAX package, which measured it
    # slower on its TPU. The whole-step kernels and the batched loops never
    # take it.
    decode_tiering: bool = False


class KVCache(NamedTuple):
    """Pre-allocated per-stack KV cache.

    k, v: [num_layers, batch, max_seq, num_kv_heads, head_dim]
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


class TPCache(NamedTuple):
    """A KV cache split over tp ranks by KV heads
    (``parallel.sharding.serving_cache_spec``, ``batch_cache_spec``):
    ``parts[t]`` is rank t's ``KVCache`` [L, B, S, KV/tp, D] on its device."""

    parts: tuple

    @property
    def max_seq(self) -> int:
        return self.parts[0].max_seq


def init_kv_cache(
    cfg: LayerStackConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> KVCache:
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = row_mean(xf * xf)  # on the card in an order the row alone fixes (``rows``)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies: theta^(-2i/D), float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # torch.full, not torch.tensor: no host-to-device copy (a CUDA graph can
    # capture it), the same f32 value.
    return 1.0 / (torch.full((), theta, dtype=torch.float32, device=device) ** exponents)


def rope_cos_sin(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] for float32 positions."""
    freqs = positions[..., None].float() * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def mrope_cos_sin(
    positions_thw: torch.Tensor, inv_freq: torch.Tensor, mrope_section: tuple[int, int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved multimodal RoPE tables [S, head_dim/2] for temporal /
    height / width position streams ``positions_thw`` [3, S].

    The HF Qwen3-Omni interleaved layout: the temporal stream everywhere,
    then the height stream at indices ``1::3`` below ``3*section[1]`` and the
    width stream at ``2::3`` below ``3*section[2]``. Equal streams give
    ``rope_cos_sin``'s tables bit for bit.
    """
    freqs = positions_thw[:, :, None].float() * inv_freq  # [3, S, D/2]
    idx = torch.arange(inv_freq.shape[0], device=inv_freq.device)
    h_mask = (idx % 3 == 1) & (idx < 3 * mrope_section[1])
    w_mask = (idx % 3 == 2) & (idx < 3 * mrope_section[2])
    out = torch.where(h_mask, freqs[1], freqs[0])
    out = torch.where(w_mask, freqs[2], out)
    return torch.cos(out), torch.sin(out)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotary embedding on [..., seq, heads, head_dim].

    cos/sin: [seq, head_dim/2] (broadcast over batch and heads), or
    [batch, seq, head_dim/2] (per-stream positions).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., :, None, :].to(x.dtype)
    sin = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, down_w: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; weights pre-transposed to [in, out]."""
    return (F.silu(x @ gate_w) * (x @ up_w)) @ down_w


def swiglu_layer(layer_params: dict, x: torch.Tensor, matmul=mm) -> torch.Tensor:
    """SwiGLU using either fused [gate|up] or separate projections, plain
    or int8 (``matmul``: ``quant.mm``, or ``quant.mm_plain``)."""
    return matmul(_swiglu_hidden(layer_params, x, matmul), layer_params["down_proj"])


def _swiglu_hidden(layer_params: dict, x: torch.Tensor, matmul) -> torch.Tensor:
    """SiLU(gate) * up, the input of the down projection."""
    if "gateup_proj" in layer_params:
        gu = matmul(x, layer_params["gateup_proj"])
        inter = gu.shape[-1] // 2
        return F.silu(gu[..., :inter]) * gu[..., inter:]
    return F.silu(matmul(x, layer_params["gate_proj"])) * matmul(x, layer_params["up_proj"])


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    scale: float,
) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]; H = KV * G.
    mask: broadcastable to [B, 1, 1, Sq, Sk] boolean, True = attend.
    Returns [B, Sq, H, D]. Scores and softmax in float32; the weights round
    to v's dtype before the value product, as in the JAX package.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    if q.device.type == "cuda" and sq == 1:
        return _step_attention(q, k, v, mask, scale)
    qg = q.reshape(b, sq, kv, g, d)
    # scores: [B, KV, G, Sq, Sk]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v)
    return out.reshape(b, sq, h, d)


def _step_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None,
                    scale: float) -> torch.Tensor:
    """``gqa_attention`` of one query row a stream on the card, each of its
    two products an elementwise product and a ``row_sum`` over the row it
    reduces (the head dim, then the cache rows), laid out last: the same
    function (a bf16 x bf16 product is exact in f32), summed in an order the
    row alone fixes. cuBLAS's batched products pick their kernel by the
    batch count, so a stream's scores among 4 streams took other bits than
    among 8 (``chip_smoke.py`` phase ``tp`` (d), an H100)."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    qf = q.reshape(b, kv, g, 1, d).float()
    kf = k.permute(0, 2, 1, 3).to(**f32)[:, :, None]  # [B, KV, 1, Sk, D]
    scores = row_sum(qf * kf).reshape(b, kv, g, 1, -1) * scale  # [B, KV, G, 1, Sk]
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    vf = v.permute(0, 2, 3, 1).to(**f32)[:, :, None]  # [B, KV, 1, D, Sk]
    out = row_sum(weights.float() * vf).to(v.dtype)  # [B, KV, G, D, 1]
    return out.reshape(b, 1, h, d)


def decode_attention_tiers(max_seq: int, base: int = 256) -> tuple[int, ...]:
    """Static cache-window tiers (256, 512, 1024, ..., max_seq)."""
    tiers: list[int] = []
    w = base
    while w < max_seq:
        tiers.append(w)
        w *= 2
    tiers.append(max_seq)
    return tuple(tiers)


def tiered_decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    mask: torch.Tensor,
    scale: float,
    pos: int,
) -> torch.Tensor:
    """Decode attention over the smallest ``decode_attention_tiers`` window
    that covers row ``pos`` (the row just written, the highest live one).

    q: [B, 1, H, D]; cache_k/v: [B, max_seq, KV, D]; mask broadcastable to
    [B, KV, G, 1, max_seq]. ``pos`` is a host integer, so the window is
    picked on the host (the JAX package's ``lax.switch`` picks it on the
    device). Exact: every window covers all unmasked rows.
    """
    w = next(t for t in decode_attention_tiers(cache_k.shape[1]) if pos + 1 <= t)
    return gqa_attention(q, cache_k[:, :w], cache_v[:, :w], mask[..., :w], scale)


def _qkv(layer_params: dict, x: torch.Tensor, cfg: LayerStackConfig, cos, sin, matmul) -> tuple:
    """q, k, v [B, S, heads, D] of normed x [B, S, hidden]: the projection
    (fused ``qkv_proj`` or separate), per-head QK-norm, RoPE on q and k."""
    b, s, _ = x.shape
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    if "qkv_proj" in layer_params:
        qkv = matmul(x, layer_params["qkv_proj"])
        q, k, v = qkv[..., :q_dim], qkv[..., q_dim : q_dim + kv_dim], qkv[..., q_dim + kv_dim :]
    else:
        q = matmul(x, layer_params["q_proj"])
        k = matmul(x, layer_params["k_proj"])
        v = matmul(x, layer_params["v_proj"])
    q = rms_norm(q.reshape(b, s, cfg.num_heads, cfg.head_dim), layer_params["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), layer_params["k_norm"], cfg.rms_norm_eps)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attention_block(
    layer_params: dict,
    x: torch.Tensor,
    cfg: LayerStackConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    write_pos: int,
    mask: torch.Tensor | None,
    self_only: bool = False,
    matmul=mm,
) -> torch.Tensor:
    """QKV projection + QK-norm + RoPE + in-place cache write + GQA attention.

    x: [B, S, hidden]. cache_k/v: [B, max_seq, KV, D] views of one layer of
    the cache; the S new K/V rows are written at ``write_pos``, or, for a
    ``write_pos`` LongTensor [B] (S = 1), stream b's row at ``write_pos[b]``.
    ``self_only=True`` (fresh-cache prefill): attention reads only the S new
    rows (S x S), and ``mask`` must be [..., Sq, S].
    A decode step (S = 1) with ``cfg.decode_tiering`` on a cache of more than
    512 rows takes ``tiered_decode_attention`` (the JAX package's condition);
    it needs ``write_pos`` as a host integer, so a LongTensor raises there
    (the batched loops switch tiering off).
    """
    attn = _attention(layer_params, x, cfg, cos, sin, cache_k, cache_v, write_pos, mask, self_only, matmul)
    return matmul(attn, layer_params["o_proj"])


def _attention(layer_params: dict, x: torch.Tensor, cfg: LayerStackConfig, cos, sin, cache_k, cache_v, write_pos,
               mask, self_only: bool, matmul) -> torch.Tensor:
    """``_attention_block`` up to the o projection: the heads' outputs
    [B, S, heads * D]."""
    b, s, _ = x.shape
    q, k, v = _qkv(layer_params, x, cfg, cos, sin, matmul)

    k = k.to(cache_k.dtype)
    v = v.to(cache_v.dtype)
    if isinstance(write_pos, torch.Tensor):  # one row a stream, each at its own position
        rows = torch.arange(b, device=x.device)
        cache_k[rows, write_pos] = k[:, 0]
        cache_v[rows, write_pos] = v[:, 0]
    else:
        cache_k[:, write_pos : write_pos + s] = k
        cache_v[:, write_pos : write_pos + s] = v

    scale = 1.0 / (cfg.head_dim**0.5)
    if self_only:
        attn = gqa_attention(q, k, v, mask, scale)
    elif s == 1 and cfg.decode_tiering and cache_k.shape[1] > 512 and mask is not None:
        if isinstance(write_pos, torch.Tensor):
            raise ValueError("tiered decode attention needs write_pos as a host integer (batch 1); "
                             "the batched loops run with decode_tiering=False")
        attn = tiered_decode_attention(q, cache_k, cache_v, mask, scale, write_pos)
    else:
        attn = gqa_attention(q, cache_k, cache_v, mask, scale)
    return attn.reshape(b, s, cfg.num_heads * cfg.head_dim)


def decoder_layer(
    layer_params: dict,
    x: torch.Tensor,
    cfg: LayerStackConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    write_pos: int,
    mask: torch.Tensor | None,
    self_only: bool = False,
    matmul=mm,
) -> torch.Tensor:
    """Pre-norm decoder layer: RMSNorm -> attn -> +res -> RMSNorm -> MLP -> +res.

    Writes this layer's new K/V rows into ``cache_k``/``cache_v`` in place.
    ``matmul`` multiplies by every projection (``quant.mm`` by default).
    """
    attn_out = _attention_block(
        layer_params,
        rms_norm(x, layer_params["input_ln"], cfg.rms_norm_eps),
        cfg,
        cos,
        sin,
        cache_k,
        cache_v,
        write_pos,
        mask,
        self_only=self_only,
        matmul=matmul,
    )
    h = x + attn_out
    mlp_out = swiglu_layer(layer_params, rms_norm(h, layer_params["post_ln"], cfg.rms_norm_eps), matmul)
    return h + mlp_out


def layer_params_at(stacked_params: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked ``[L, ...]`` tree
    (a quantized linear's ``q8`` and ``scale`` alike)."""
    return {
        name: {k: t[i] for k, t in w.items()} if isinstance(w, dict) else w[i]
        for name, w in stacked_params.items()
    }


def run_layer_stack_nocache(stacked_params: dict, x: torch.Tensor, cfg: LayerStackConfig) -> torch.Tensor:
    """Causal self-attention over a short full sequence with no KV cache
    (the code predictor's Jacobi iteration recomputes its whole 16-row frame).

    x: [B, S, hidden] at positions 0..S-1, a ``tril`` mask; every projection
    through ``quant.mm`` (on an int8 tree on the card, kernel 4 at B·S rows),
    attention the plain ``gqa_attention`` over the S rows. It keeps its own
    loop, as the JAX function does, rather than ``run_layer_stack(...,
    self_attn_prefill=True)``, which computes the same attention but writes
    every pass's K/V rows into a cache that a Jacobi pass has no use for.
    """
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    cos, sin = rope_cos_sin(positions.float(), rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=x.device))
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None, None]
    scale = 1.0 / (cfg.head_dim**0.5)
    h = x
    for i in range(cfg.num_layers):
        layer = layer_params_at(stacked_params, i)
        q, k, v = _qkv(layer, rms_norm(h, layer["input_ln"], cfg.rms_norm_eps), cfg, cos, sin, mm)
        attn = gqa_attention(q, k, v, mask, scale)
        h = h + mm(attn.reshape(h.shape[0], s, cfg.num_heads * cfg.head_dim), layer["o_proj"])
        h = h + swiglu_layer(layer, rms_norm(h, layer["post_ln"], cfg.rms_norm_eps))
    return h


def rope_and_mask(cfg: LayerStackConfig, max_seq: int, dev: torch.device, positions, positions_thw,
                  self_attn_prefill: bool) -> tuple:
    """The RoPE tables and the causal mask ``run_layer_stack`` takes from
    its positions (see there), on ``dev``: (cos, sin, mask)."""
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=dev)
    if positions_thw is not None:
        if positions is not None:
            raise ValueError("run_layer_stack: give positions or positions_thw, not both")
        if cfg.mrope_section is None:
            raise ValueError("run_layer_stack: [3, S] position streams need cfg.mrope_section")
        positions_thw = positions_thw.to(dev)
        cos, sin = mrope_cos_sin(positions_thw, inv_freq, cfg.mrope_section)
        positions = positions_thw[0]
    else:
        positions = positions.to(dev)
        cos, sin = rope_cos_sin(positions.float(), inv_freq)
    if positions.ndim == 2:  # per-stream positions [B, 1]
        key_pos = torch.arange(max_seq, device=dev)
        mask = (key_pos <= positions[..., None])[:, None, None]  # [B, KV=1, G=1, 1, Sk]
    elif self_attn_prefill:
        mask = (positions[None, :] <= positions[:, None])[None, None, None]
    else:
        key_pos = torch.arange(max_seq, device=dev)
        mask = (key_pos[None, :] <= positions[:, None])[None, None, None]  # [B=1, KV=1, G=1, Sq, Sk]
    return cos, sin, mask


def run_layer_stack(
    stacked_params: dict,
    x: torch.Tensor,
    cfg: LayerStackConfig,
    cache: KVCache,
    positions: torch.Tensor | None,
    write_pos: int | torch.Tensor,
    self_attn_prefill: bool = False,
    matmul=mm,
    positions_thw: torch.Tensor | None = None,
    tables: tuple | None = None,
) -> torch.Tensor:
    """Run all layers against the full pre-allocated cache (updated in place).

    x: [B, S, hidden] new token embeddings at absolute ``positions`` [S]
    (int64); their K/V rows are written starting at cache row ``write_pos``.
    Prompts are right-padded, so the pure causal mask ``key_row <=
    query_position`` is exact (see the JAX package's docstring).

    A decode step of B streams each at its own position (what ``jax.vmap``
    makes of the JAX package's step): ``positions`` [B, 1] and
    ``write_pos`` the same positions as a LongTensor [B]; RoPE at each
    stream's position, its row written at ``(b, write_pos[b])``, its mask
    [B, 1, 1, 1, Sk] its own.

    ``positions_thw`` [3, S] (with ``positions`` None): temporal / height /
    width streams through interleaved MRoPE (``mrope_cos_sin``, needs
    ``cfg.mrope_section``); the temporal stream orders the causal mask.
    The JAX package takes these as a 2-D ``positions``, which here means
    per-stream positions.

    ``self_attn_prefill=True``: fresh-cache prefill (write_pos == 0, no
    earlier live rows); attention runs over the S new rows only.
    ``matmul``: as ``decoder_layer``'s. ``tables``: the (cos, sin, mask)
    that ``rope_and_mask`` made for these positions ahead of the call (a
    CUDA graph's capture makes them once, outside the graph); the positions
    are then not read.
    """
    cos, sin, mask = tables or rope_and_mask(cfg, cache.max_seq, x.device, positions, positions_thw,
                                             self_attn_prefill)
    h = x
    for i in range(cfg.num_layers):
        h = decoder_layer(
            layer_params_at(stacked_params, i),
            h,
            cfg,
            cos,
            sin,
            cache.k[i],
            cache.v[i],
            write_pos,
            mask,
            self_only=self_attn_prefill,
            matmul=matmul,
        )
    return h


# ---------------------------------------------------------------------------
# The tensor-parallel layer path
# ---------------------------------------------------------------------------


def tp_local_config(cfg: LayerStackConfig, tp: int) -> LayerStackConfig:
    """A tp rank's layer-stack config: heads, KV heads and intermediate over
    tp (each must divide)."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} does not divide {cfg.num_heads} heads, {cfg.num_kv_heads} KV heads and "
                         f"intermediate {cfg.intermediate_size}")
    return replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp)


def add_per_rank(hs: list, parts: list) -> list:
    """``hs[t] + parts[t]`` for every rank, each distinct pair added once
    (ranks that share a device share both tensors)."""
    made: dict = {}
    out = []
    for h, p in zip(hs, parts):
        key = (id(h), id(p))
        if key not in made:
            made[key] = h + p
        out.append(made[key])
    return out


def row_parallel(xs: list, ws: list, devices: list, matmul=mm) -> list:
    """The row-parallel product: sum over the ranks of ``xs[t] @ ws[t]`` (x's
    K split over the ranks, ws[t] the matching rows), on every rank.

    Each rank's product rounds to x's dtype and the parts are all-reduced in
    it, as the JAX package's psum. An int8 weight under ``quant.w8a8_scope``
    is the JAX package's w8a8 under GSPMD: every rank quantizes its rows by
    the maximum of the ranks' row amax (a max all-reduce), the int32
    products are all-reduced, and then the scales applied once: bit for bit
    the one-device product."""
    if matmul is mm and quant._w8a8_allowed() and quant.is_quantized(ws[0]):
        lead, dtype = xs[0].shape[:-1], xs[0].dtype
        x2 = [x.reshape(-1, x.shape[-1]) for x in xs]
        amax = all_reduce([quant.w8a8_row_amax(x) for x in x2], "max")
        q = [quant.w8a8_quantize(x, a) for x, a in zip(x2, amax)]
        accs = []
        for (xq, _), w, dev in zip(q, ws, devices):
            with device_scope(dev):
                accs.append(quant.w8a8_int_mm(xq, w["q8"]))
        accs = all_reduce(accs)
        out = [(acc.float() * x_scale * w["scale"].float()).to(dtype) for acc, (_, x_scale), w in zip(accs, q, ws)]
        return [o.reshape(*lead, o.shape[-1]) for o in out]
    parts = []
    for x, w, dev in zip(xs, ws, devices):
        with device_scope(dev):
            parts.append(matmul(x, w))
    return all_reduce(parts)


def run_layer_stack_tp(
    rank_layers: list[dict],
    devices: list[torch.device],
    x: torch.Tensor,
    cfg: LayerStackConfig,
    caches: list[KVCache],
    positions: torch.Tensor | None,
    write_pos: int | torch.Tensor,
    self_attn_prefill: bool = False,
    matmul=mm,
    positions_thw: torch.Tensor | None = None,
) -> torch.Tensor:
    """``run_layer_stack`` over tp ranks: what GSPMD makes of it under
    ``parallel.sharding.layer_stack_specs``.

    ``rank_layers[t]``: rank t's slice of the stacked tree (its heads' q /
    k / v columns, its o rows, its intermediate's gate / up columns and down
    rows) on ``devices[t]``; ``caches[t]``: its KV heads' cache [L, B, S,
    KV/tp, D]. x [B, S, hidden] lies on the first device and the result
    comes back there. Every form of ``run_layer_stack`` (prefill, a step,
    per-stream positions, MRoPE streams, tiered decode attention) runs per
    rank on a rank-local config (``tp_local_config``); after each sub-layer
    the row-parallel product (``row_parallel``) all-reduces the partial
    sums, then the residual is added. Each rank's work is launched on its
    device (``collectives.device_scope``).
    """
    tp = len(rank_layers)
    local = tp_local_config(cfg, tp)
    eps = cfg.rms_norm_eps
    tables: dict = {}
    for dev in devices:
        if dev not in tables:
            tables[dev] = rope_and_mask(cfg, caches[0].max_seq, dev, positions, positions_thw, self_attn_prefill)
    wps = [write_pos.to(dev) if isinstance(write_pos, torch.Tensor) else write_pos for dev in devices]
    hs = broadcast(x, devices)
    for i in range(cfg.num_layers):
        layers = [layer_params_at(rl, i) for rl in rank_layers]
        attn = []
        for t, dev in enumerate(devices):
            with device_scope(dev):
                lyr, (cos, sin, mask) = layers[t], tables[dev]
                attn.append(_attention(lyr, rms_norm(hs[t], lyr["input_ln"], eps), local, cos, sin, caches[t].k[i],
                                       caches[t].v[i], wps[t], mask, self_attn_prefill, matmul))
        hs = add_per_rank(hs, row_parallel(attn, [lyr["o_proj"] for lyr in layers], devices, matmul))
        act = []
        for t, dev in enumerate(devices):
            with device_scope(dev):
                act.append(_swiglu_hidden(layers[t], rms_norm(hs[t], layers[t]["post_ln"], eps), matmul))
        hs = add_per_rank(hs, row_parallel(act, [lyr["down_proj"] for lyr in layers], devices, matmul))
    return hs[0]
