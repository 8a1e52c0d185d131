"""Decoder12Hz vocoder: 16-codebook codec frames -> 24 kHz waveform.

PyTorch port of ``qwen3_tts_tpu/models/codec/vocoder.py``, the batch
decode and the sample-exact streaming decode (``decode_stream_chunk``):
  1. RVQ de-embed: semantic codebook (codes mod 2048) and 15 summed acoustic
     codebooks, each projected 256 -> 512, then summed.
  2. Causal pre-conv k3 512 -> 1024, input_proj -> 512.
  3. 8-layer causal pre-transformer (16 heads x 64, layer-scale, RoPE theta
     1e4, rms eps 1e-5), final norm, output_proj -> 1024.
  4. 2 upsample stages (TransConv x2 + ConvNeXt) -> init conv k7 -> 1536.
  5. 4 BigVGAN decoder blocks (rates 8, 5, 4, 3, channels halving); their
     f32 residual units with C <= 512 run the fused kernel on the card.
  6. Final SnakeBeta + conv k7 -> 1 channel, clamp to [-1, 1].

2*2*8*5*4*3 = 1920 samples per 80 ms frame. Everything is causal, so
right-padding the frame axis to a bucket and trimming is exact, and a
stream that carries each conv's left-context rows and the
pre-transformer's KV cache across chunks gives the batch decode's samples
(up to matmul-tiling ulps). f32 throughout, at full matmul and conv
precision (TF32 is off, see the package's ``__init__``). ``load_vocoder_params``
maps a speech tokenizer's HF ``decoder.*`` tensors to the tree (the JAX
package's layout: conv kernels ``[K, Cin, Cout]``, linear ``[in, out]``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import profiling
from ...ops import nn as tnn
from . import blocks


@dataclass(frozen=True)
class VocoderConfig:
    codebook_dim: int = 512
    latent_dim: int = 1024
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 16
    head_dim: int = 64
    intermediate_size: int = 1024
    num_quantizers: int = 16
    codebook_size: int = 2048
    codebook_embed_dim: int = 256
    upsampling_ratios: tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e4
    final_kernel: int = 7

    @property
    def total_upsample(self) -> int:
        total = 1
        for r in self.upsampling_ratios + self.upsample_rates:
            total *= r
        return total


def _pre_transformer(params: dict, cfg: VocoderConfig, x: torch.Tensor) -> torch.Tensor:
    """8 causal attention layers with layer-scale; x: [B, T, hidden]."""
    b, t, _ = x.shape
    nh, d = cfg.num_heads, cfg.head_dim
    inv_freq = tnn.rope_inv_freq(d, cfg.rope_theta, device=x.device)
    cos, sin = tnn.rope_cos_sin(torch.arange(t, dtype=torch.float32, device=x.device), inv_freq)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))[None, None, None]

    h = x
    for i in range(cfg.num_layers):
        p = tnn.layer_params_at(params["layers"], i)
        normed = tnn.rms_norm(h, p["input_ln"], cfg.rms_norm_eps)
        q = tnn.apply_rope((normed @ p["q_proj"]).reshape(b, t, nh, d), cos, sin)
        k = tnn.apply_rope((normed @ p["k_proj"]).reshape(b, t, nh, d), cos, sin)
        v = (normed @ p["v_proj"]).reshape(b, t, nh, d)
        attn = tnn.gqa_attention(q, k, v, causal, 1.0 / d**0.5)
        h = h + (attn.reshape(b, t, nh * d) @ p["o_proj"]) * p["attn_scale"]
        normed = tnn.rms_norm(h, p["post_ln"], cfg.rms_norm_eps)
        mlp = (F.silu(normed @ p["gate_proj"]) * (normed @ p["up_proj"])) @ p["down_proj"]
        h = h + mlp * p["mlp_scale"]
    return h


def rvq_deembed(params: dict, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """Codes [B, 16, T] int -> quantized latent [B, T, codebook_dim]."""
    codes = codes.long()
    first = params["first_codebook"][codes[:, 0, :] % cfg.codebook_size]  # [B, T, 256]
    first = first @ params["first_output_proj"]  # [B, T, 512]
    rest = params["rest_codebooks"]  # [15, codebook_size, 256]
    groups = torch.arange(rest.shape[0], device=codes.device)[None, :, None]
    emb = rest[groups, codes[:, 1:, :]]  # [B, 15, T, 256]
    return first + emb.sum(dim=1) @ params["rest_output_proj"]


def decode(params: dict, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """Decode codec tokens [B, 16, T] -> waveform [B, T * 1920] float32."""
    with profiling.annotate("q3.vocoder"):
        h = rvq_deembed(params, cfg, codes).float()
        h = blocks.causal_conv1d(h, params["pre_conv_w"], params["pre_conv_b"])  # -> latent_dim
        h = h @ params["input_proj_w"] + params["input_proj_b"]  # -> hidden
        h = _pre_transformer(params, cfg, h)
        h = tnn.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        h = h @ params["output_proj_w"] + params["output_proj_b"]  # -> latent_dim

        for stage, ratio in zip(params["upsample"], cfg.upsampling_ratios):
            h = blocks.upsample_stage(h, stage, ratio)
        h = blocks.causal_conv1d(h, params["init_conv_w"], params["init_conv_b"])
        for block, rate in zip(params["decoder_blocks"], cfg.upsample_rates):
            h = blocks.decoder_block(h, block, rate)

        h = blocks.snake_beta(h, params["final_snake_alpha"], params["final_snake_beta"])
        h = blocks.causal_conv1d(h, params["final_conv_w"], params["final_conv_b"])
        return torch.clamp(h[..., 0], -1.0, 1.0)


def decode_bucketed(params: dict, cfg: VocoderConfig, codes: np.ndarray, bucket: int = 64) -> np.ndarray:
    """Right-pad the frame axis to a bucket multiple (exact for this
    all-causal stack), decode on the parameters' device, trim to the true
    sample count. codes: [B, 16, T] int; returns [B, T * 1920] float32."""
    t = codes.shape[-1]
    if t == 0:
        return np.zeros((codes.shape[0], 0), np.float32)
    with profiling.annotate("q3.vocoder"):
        padded_t = ((t + bucket - 1) // bucket) * bucket
        padded = np.zeros((codes.shape[0], codes.shape[1], padded_t), np.int64)
        padded[..., :t] = codes
        dev = params["first_codebook"].device
        with torch.no_grad():
            wav = decode(params, cfg, torch.from_numpy(padded).to(dev))
        with profiling.annotate("q3.wait"):
            return wav[:, : t * cfg.total_upsample].cpu().numpy()


# ---------------------------------------------------------------------------
# Sample-exact streaming decode
# ---------------------------------------------------------------------------
#
# Each conv carries the last ``ctx`` input rows it has seen (exactly its
# causal pad width: zeros at the start, as the batch path's left padding),
# and the pre-transformer a KV cache of every frame so far, so the chunks'
# samples put together are the batch decode's, at the cost of a
# chunk-local decode.


def _conv_ctx_rows(k: int, dilation: int = 1) -> int:
    return dilation * (k - 1)


def _tconv_ctx_rows(k: int, stride: int) -> int:
    # Polyphase taps m = 0..ceil(k/s)-1: output u consumes inputs u-m.
    return -(-k // stride) - 1


class VocoderStreamState(NamedTuple):
    """Carried vocoder state of a chunked decode.

    kv_k, kv_v: [L, B, maxT, H, D] pre-transformer KV cache (written in place).
    conv:       nested dict of per-conv left-context rows (the last ``ctx``
                input rows each conv has seen, at its own time resolution).
    pos:        frames decoded so far.
    """

    kv_k: torch.Tensor
    kv_v: torch.Tensor
    conv: dict
    pos: int


def init_stream_state(
    cfg: VocoderConfig, max_frames: int, batch: int = 1, *, device: torch.device | str
) -> VocoderStreamState:
    """A zeroed stream state on ``device`` for up to ``max_frames`` frames."""
    kv_shape = (cfg.num_layers, batch, max_frames, cfg.num_heads, cfg.head_dim)

    def rows(n, ch):
        return torch.zeros((batch, n, ch), dtype=torch.float32, device=device)

    conv: dict = {
        "pre_conv": rows(_conv_ctx_rows(3), cfg.codebook_dim),
        "upsample": [
            {"up": rows(_tconv_ctx_rows(2 * r, r), cfg.latent_dim), "dw": rows(_conv_ctx_rows(7), cfg.latent_dim)}
            for r in cfg.upsampling_ratios
        ],
        "init_conv": rows(_conv_ctx_rows(7), cfg.latent_dim),
        "blocks": [],
    }
    ch = cfg.decoder_dim
    for rate in cfg.upsample_rates:
        out_ch = ch // 2
        conv["blocks"].append({
            "up": rows(_tconv_ctx_rows(2 * rate, rate), ch),
            "res1": rows(_conv_ctx_rows(7, 1), out_ch),
            "res2": rows(_conv_ctx_rows(7, 3), out_ch),
            "res3": rows(_conv_ctx_rows(7, 9), out_ch),
        })
        ch = out_ch
    conv["final"] = rows(_conv_ctx_rows(cfg.final_kernel), ch)
    return VocoderStreamState(
        kv_k=torch.zeros(kv_shape, dtype=torch.float32, device=device),
        kv_v=torch.zeros(kv_shape, dtype=torch.float32, device=device),
        conv=conv,
        pos=0,
    )


def _conv_stream(x, state, kernel, bias, dilation: int = 1, groups: int = 1):
    """Streaming causal conv: the carried ``ctx = d*(k-1)`` input rows in
    front, convolve, drop their outputs; returns (this chunk's outputs, the
    new carry)."""
    ctx = state.shape[1]
    if ctx == 0:
        return blocks.causal_conv1d(x, kernel, bias, dilation, groups), state
    x_ext = torch.cat([state, x], dim=1)
    out = blocks.causal_conv1d(x_ext, kernel, bias, dilation, groups)[:, ctx:]
    return out, x_ext[:, -ctx:]


def _tconv_stream(x, state, kernel, bias, stride: int):
    """Streaming causal transposed conv (polyphase): output row u*stride+r
    consumes inputs u-m, m < ceil(k/s), so carrying those rows keeps the
    chunk's outputs the batch computation's."""
    ctx = state.shape[1]
    if ctx == 0:
        return blocks.causal_trans_conv1d(x, kernel, bias, stride), state
    x_ext = torch.cat([state, x], dim=1)
    out = blocks.causal_trans_conv1d(x_ext, kernel, bias, stride)[:, ctx * stride:]
    return out, x_ext[:, -ctx:]


def _convnext_stream(x, dw_state, p):
    h, new_dw = _conv_stream(x, dw_state, p["dwconv_w"], p["dwconv_b"], groups=x.shape[-1])
    h = blocks.layer_norm(h, p["norm_w"], p["norm_b"])
    h = h @ p["pwconv1_w"] + p["pwconv1_b"]
    h = F.gelu(h, approximate="none")
    h = h @ p["pwconv2_w"] + p["pwconv2_b"]
    return x + h * p["gamma"], new_dw


def _residual_unit_stream(x, st, p, dilation: int):
    """A residual unit of a chunk: units that take the fused kernel go to its
    stream entry (the carry is the raw input tail: snake is pointwise and
    snake(0) == 0, so it is equivalent to the post-snake carry below). A
    chunk of B > 1 streams arrives as a time slice of a wider tensor, which
    the entry takes contiguous."""
    from . import fused_blocks

    if fused_blocks.residual_unit_should_fuse(x):
        return fused_blocks.residual_unit_stream(x.contiguous(), st, p, dilation)
    h = blocks.snake_beta(x, p["act1_alpha"], p["act1_beta"])
    h, new_st = _conv_stream(h, st, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = blocks.snake_beta(h, p["act2_alpha"], p["act2_beta"])
    h = blocks.causal_conv1d(h, p["conv2_w"], p["conv2_b"])  # k=1: no context
    return x + h, new_st


def _pre_transformer_cached(
    params: dict,
    cfg: VocoderConfig,
    x: torch.Tensor,  # [B, S, hidden] new rows at absolute positions pos..pos+S
    kv_k: torch.Tensor,  # [L, B, maxT, H, D], rows pos..pos+S written in place
    kv_v: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """``_pre_transformer`` with the K/V history read from (and appended to)
    a cache: a query at position p scores every cache row, and rows past p
    are masked to -1e30 (exact softmax zeros), so it sums the rows 0..p the
    batch path sums."""
    b, s, _ = x.shape
    nh, d = cfg.num_heads, cfg.head_dim
    max_t = kv_k.shape[2]
    inv_freq = tnn.rope_inv_freq(d, cfg.rope_theta, device=x.device)
    positions = pos + torch.arange(s, device=x.device)
    cos, sin = tnn.rope_cos_sin(positions.float(), inv_freq)
    mask = (torch.arange(max_t, device=x.device)[None, :] <= positions[:, None])[None, None, None]

    h = x
    for i in range(cfg.num_layers):
        p = tnn.layer_params_at(params["layers"], i)
        normed = tnn.rms_norm(h, p["input_ln"], cfg.rms_norm_eps)
        q = tnn.apply_rope((normed @ p["q_proj"]).reshape(b, s, nh, d), cos, sin)
        k = tnn.apply_rope((normed @ p["k_proj"]).reshape(b, s, nh, d), cos, sin)
        v = (normed @ p["v_proj"]).reshape(b, s, nh, d)
        kv_k[i, :, pos:pos + s] = k
        kv_v[i, :, pos:pos + s] = v
        attn = tnn.gqa_attention(q, kv_k[i], kv_v[i], mask, 1.0 / d**0.5)
        h = h + (attn.reshape(b, s, nh * d) @ p["o_proj"]) * p["attn_scale"]
        normed = tnn.rms_norm(h, p["post_ln"], cfg.rms_norm_eps)
        mlp = (F.silu(normed @ p["gate_proj"]) * (normed @ p["up_proj"])) @ p["down_proj"]
        h = h + mlp * p["mlp_scale"]
    return h


@torch.no_grad()
def decode_stream_chunk(
    params: dict,
    cfg: VocoderConfig,
    state: VocoderStreamState,
    codes: torch.Tensor,  # [B, 16, S] the next S frames
) -> tuple[torch.Tensor, VocoderStreamState]:
    """Decode the next chunk of frames, carrying exact causal context.

    Returns ([B, S * total_upsample] f32 audio, the updated state; its KV
    cache is the given one, written in place). The audio equals the
    matching slice of the batch ``decode`` of all frames fed so far (up to
    matmul-tiling ulps), at the cost of a chunk-local decode.
    """
    with profiling.annotate("q3.vocoder"):
        s = codes.shape[-1]
        if state.pos + s > state.kv_k.shape[2]:
            # A chunk that runs past the KV cache (a stream's last chunk, padded
            # with zero-code rows): room for it, so that its rows land at their
            # own positions (the JAX package's in-place update clamps them back).
            pad = state.kv_k.new_zeros(state.kv_k.shape[:2] + (state.pos + s - state.kv_k.shape[2],)
                                       + state.kv_k.shape[3:])
            state = state._replace(kv_k=torch.cat([state.kv_k, pad], 2), kv_v=torch.cat([state.kv_v, pad], 2))
        cs = state.conv
        new_cs: dict = {"upsample": [], "blocks": []}
        q = rvq_deembed(params, cfg, codes).float()

        h, new_cs["pre_conv"] = _conv_stream(q, cs["pre_conv"], params["pre_conv_w"], params["pre_conv_b"])
        h = h @ params["input_proj_w"] + params["input_proj_b"]
        h = _pre_transformer_cached(params, cfg, h, state.kv_k, state.kv_v, state.pos)
        h = tnn.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        h = h @ params["output_proj_w"] + params["output_proj_b"]  # [B, S, latent]

        for stage, st, ratio in zip(params["upsample"], cs["upsample"], cfg.upsampling_ratios):
            h, new_up = _tconv_stream(h, st["up"], stage["up_w"], stage["up_b"], ratio)
            h, new_dw = _convnext_stream(h, st["dw"], stage["convnext"])
            new_cs["upsample"].append({"up": new_up, "dw": new_dw})

        h, new_cs["init_conv"] = _conv_stream(h, cs["init_conv"], params["init_conv_w"], params["init_conv_b"])
        for block, st, rate in zip(params["decoder_blocks"], cs["blocks"], cfg.upsample_rates):
            hb = blocks.snake_beta(h, block["snake_alpha"], block["snake_beta"])
            h, new_up = _tconv_stream(hb, st["up"], block["up_w"], block["up_b"], rate)
            new_blk = {"up": new_up}
            for key, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
                h, new_blk[key] = _residual_unit_stream(h, st[key], block[key], dil)
            new_cs["blocks"].append(new_blk)

        h = blocks.snake_beta(h, params["final_snake_alpha"], params["final_snake_beta"])
        h, new_cs["final"] = _conv_stream(h, cs["final"], params["final_conv_w"], params["final_conv_b"])
        wav = torch.clamp(h[..., 0], -1.0, 1.0)
        return wav, VocoderStreamState(state.kv_k, state.kv_v, new_cs, state.pos + s)


def _conv_w(w: torch.Tensor) -> torch.Tensor:
    """HF conv / transposed-conv weight [A, B, K] -> [K, B, A], f32 (the JAX
    package's layout, which this vocoder takes)."""
    return w.float().permute(2, 1, 0).contiguous()


def _lin(w: torch.Tensor) -> torch.Tensor:
    """HF linear weight [out, in] -> [in, out], f32."""
    return w.float().t().contiguous()


def _f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def _normalized_codebook(embedding_sum: torch.Tensor, cluster_usage: torch.Tensor) -> torch.Tensor:
    """The codebook: each row's embedding sum over its usage (at least 1e-7), f32."""
    return embedding_sum.float() / cluster_usage.float().clamp(min=1e-7)[:, None]


def _convnext_params(w: dict, p: str) -> dict:
    return {
        "dwconv_w": _conv_w(w[f"{p}.dwconv.conv.weight"]),
        "dwconv_b": _f32(w[f"{p}.dwconv.conv.bias"]),
        "norm_w": _f32(w[f"{p}.norm.weight"]),
        "norm_b": _f32(w[f"{p}.norm.bias"]),
        "pwconv1_w": _lin(w[f"{p}.pwconv1.weight"]),
        "pwconv1_b": _f32(w[f"{p}.pwconv1.bias"]),
        "pwconv2_w": _lin(w[f"{p}.pwconv2.weight"]),
        "pwconv2_b": _f32(w[f"{p}.pwconv2.bias"]),
        "gamma": _f32(w[f"{p}.gamma"]),
    }


def _residual_unit_params(w: dict, p: str) -> dict:
    return {
        "act1_alpha": _f32(w[f"{p}.act1.alpha"]),
        "act1_beta": _f32(w[f"{p}.act1.beta"]),
        "conv1_w": _conv_w(w[f"{p}.conv1.conv.weight"]),
        "conv1_b": _f32(w[f"{p}.conv1.conv.bias"]),
        "act2_alpha": _f32(w[f"{p}.act2.alpha"]),
        "act2_beta": _f32(w[f"{p}.act2.beta"]),
        "conv2_w": _conv_w(w[f"{p}.conv2.conv.weight"]),
        "conv2_b": _f32(w[f"{p}.conv2.conv.bias"]),
    }


def load_vocoder_params(w: dict, cfg: VocoderConfig = VocoderConfig()) -> dict:
    """The vocoder's tree from a speech tokenizer's HF ``decoder.*`` tensors,
    f32 whatever their dtype, on the device that holds them."""
    layers = []
    for i in range(cfg.num_layers):
        p = f"decoder.pre_transformer.layers.{i}"
        layers.append({
            "input_ln": _f32(w[f"{p}.input_layernorm.weight"]),
            "q_proj": _lin(w[f"{p}.self_attn.q_proj.weight"]),
            "k_proj": _lin(w[f"{p}.self_attn.k_proj.weight"]),
            "v_proj": _lin(w[f"{p}.self_attn.v_proj.weight"]),
            "o_proj": _lin(w[f"{p}.self_attn.o_proj.weight"]),
            "attn_scale": _f32(w[f"{p}.self_attn_layer_scale.scale"]),
            "post_ln": _f32(w[f"{p}.post_attention_layernorm.weight"]),
            "gate_proj": _lin(w[f"{p}.mlp.gate_proj.weight"]),
            "up_proj": _lin(w[f"{p}.mlp.up_proj.weight"]),
            "down_proj": _lin(w[f"{p}.mlp.down_proj.weight"]),
            "mlp_scale": _f32(w[f"{p}.mlp_layer_scale.scale"]),
        })
    stacked_layers = {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}

    upsample = []
    for i, _ in enumerate(cfg.upsampling_ratios):
        p = f"decoder.upsample.{i}"
        upsample.append({
            "up_w": _conv_w(w[f"{p}.0.conv.weight"]),
            "up_b": _f32(w[f"{p}.0.conv.bias"]),
            "convnext": _convnext_params(w, f"{p}.1"),
        })

    decoder_blocks = []
    for i, _ in enumerate(cfg.upsample_rates):
        bp = f"decoder.decoder.{i + 1}.block"
        decoder_blocks.append({
            "snake_alpha": _f32(w[f"{bp}.0.alpha"]),
            "snake_beta": _f32(w[f"{bp}.0.beta"]),
            "up_w": _conv_w(w[f"{bp}.1.conv.weight"]),
            "up_b": _f32(w[f"{bp}.1.conv.bias"]),
            "res1": _residual_unit_params(w, f"{bp}.2"),
            "res2": _residual_unit_params(w, f"{bp}.3"),
            "res3": _residual_unit_params(w, f"{bp}.4"),
        })

    q = "decoder.quantizer"
    return {
        "first_codebook": _normalized_codebook(w[f"{q}.rvq_first.vq.layers.0._codebook.embedding_sum"],
                                               w[f"{q}.rvq_first.vq.layers.0._codebook.cluster_usage"]),
        "rest_codebooks": torch.stack([
            _normalized_codebook(w[f"{q}.rvq_rest.vq.layers.{i}._codebook.embedding_sum"],
                                 w[f"{q}.rvq_rest.vq.layers.{i}._codebook.cluster_usage"])
            for i in range(cfg.num_quantizers - 1)
        ]),
        # 1x1 conv weights [out, in, 1] -> dense [in, out]
        "first_output_proj": _lin(w[f"{q}.rvq_first.output_proj.weight"][:, :, 0]),
        "rest_output_proj": _lin(w[f"{q}.rvq_rest.output_proj.weight"][:, :, 0]),
        "pre_conv_w": _conv_w(w["decoder.pre_conv.conv.weight"]),
        "pre_conv_b": _f32(w["decoder.pre_conv.conv.bias"]),
        "input_proj_w": _lin(w["decoder.pre_transformer.input_proj.weight"]),
        "input_proj_b": _f32(w["decoder.pre_transformer.input_proj.bias"]),
        "layers": stacked_layers,
        "final_norm": _f32(w["decoder.pre_transformer.norm.weight"]),
        "output_proj_w": _lin(w["decoder.pre_transformer.output_proj.weight"]),
        "output_proj_b": _f32(w["decoder.pre_transformer.output_proj.bias"]),
        "upsample": upsample,
        "init_conv_w": _conv_w(w["decoder.decoder.0.conv.weight"]),
        "init_conv_b": _f32(w["decoder.decoder.0.conv.bias"]),
        "decoder_blocks": decoder_blocks,
        "final_snake_alpha": _f32(w["decoder.decoder.5.alpha"]),
        "final_snake_beta": _f32(w["decoder.decoder.5.beta"]),
        "final_conv_w": _conv_w(w["decoder.decoder.6.conv.weight"]),
        "final_conv_b": _f32(w["decoder.decoder.6.conv.bias"]),
    }


def init_vocoder_params(gen: torch.Generator, cfg: VocoderConfig = VocoderConfig()) -> dict:
    """Random-init vocoder tree (tests / synthetic benchmarking), f32, on the
    generator's device."""
    dev = gen.device

    def rnd(shape, scale=0.02):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * scale

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    def conv(cin, cout, k):
        return rnd((k, cin, cout)), zeros(cout)

    def tconv(cin, cout, k):
        return rnd((k, cout, cin)), zeros(cout)

    def convnext(dim):
        return {
            "dwconv_w": rnd((7, 1, dim)),
            "dwconv_b": zeros(dim),
            "norm_w": full(dim, 1.0),
            "norm_b": zeros(dim),
            "pwconv1_w": rnd((dim, 4 * dim)),
            "pwconv1_b": zeros(4 * dim),
            "pwconv2_w": rnd((4 * dim, dim)),
            "pwconv2_b": zeros(dim),
            "gamma": full(dim, 1.0),
        }

    def res_unit(dim):
        c1w, c1b = conv(dim, dim, 7)
        c2w, c2b = conv(dim, dim, 1)
        return {
            "act1_alpha": zeros(dim),
            "act1_beta": zeros(dim),
            "conv1_w": c1w,
            "conv1_b": c1b,
            "act2_alpha": zeros(dim),
            "act2_beta": zeros(dim),
            "conv2_w": c2w,
            "conv2_b": c2b,
        }

    hs, hd, inter, nl = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.intermediate_size, cfg.num_layers
    layers = {
        "input_ln": torch.ones((nl, hs), device=dev),
        "q_proj": rnd((nl, hs, hd)),
        "k_proj": rnd((nl, hs, hd)),
        "v_proj": rnd((nl, hs, hd)),
        "o_proj": rnd((nl, hd, hs)),
        "attn_scale": torch.full((nl, hs), 0.01, device=dev),
        "post_ln": torch.ones((nl, hs), device=dev),
        "gate_proj": rnd((nl, hs, inter)),
        "up_proj": rnd((nl, hs, inter)),
        "down_proj": rnd((nl, inter, hs)),
        "mlp_scale": torch.full((nl, hs), 0.01, device=dev),
    }

    pre_w, pre_b = conv(cfg.codebook_dim, cfg.latent_dim, 3)
    init_w, init_b = conv(cfg.latent_dim, cfg.decoder_dim, 7)
    upsample = []
    for r in cfg.upsampling_ratios:
        uw, ub = tconv(cfg.latent_dim, cfg.latent_dim, 2 * r)
        upsample.append({"up_w": uw, "up_b": ub, "convnext": convnext(cfg.latent_dim)})
    decoder_blocks = []
    ch = cfg.decoder_dim
    for r in cfg.upsample_rates:
        out_ch = ch // 2
        uw, ub = tconv(ch, out_ch, 2 * r)
        decoder_blocks.append(
            {
                "snake_alpha": zeros(ch),
                "snake_beta": zeros(ch),
                "up_w": uw,
                "up_b": ub,
                "res1": res_unit(out_ch),
                "res2": res_unit(out_ch),
                "res3": res_unit(out_ch),
            }
        )
        ch = out_ch
    fw, fb = conv(ch, 1, cfg.final_kernel)
    ed = cfg.codebook_embed_dim
    return {
        "first_codebook": rnd((cfg.codebook_size, ed), 1.0),
        "rest_codebooks": rnd((cfg.num_quantizers - 1, cfg.codebook_size, ed), 1.0),
        "first_output_proj": rnd((ed, cfg.codebook_dim)),
        "rest_output_proj": rnd((ed, cfg.codebook_dim)),
        "pre_conv_w": pre_w,
        "pre_conv_b": pre_b,
        "input_proj_w": rnd((cfg.latent_dim, cfg.hidden_size)),
        "input_proj_b": zeros(cfg.hidden_size),
        "layers": layers,
        "final_norm": full(cfg.hidden_size, 1.0),
        "output_proj_w": rnd((cfg.hidden_size, cfg.latent_dim)),
        "output_proj_b": zeros(cfg.latent_dim),
        "upsample": upsample,
        "init_conv_w": init_w,
        "init_conv_b": init_b,
        "decoder_blocks": decoder_blocks,
        "final_snake_alpha": zeros(ch),
        "final_snake_beta": zeros(ch),
        "final_conv_w": fw,
        "final_conv_b": fb,
    }
