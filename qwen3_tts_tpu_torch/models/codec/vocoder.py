"""Decoder12Hz vocoder: 16-codebook codec frames -> 24 kHz waveform.

PyTorch port of the batch path of ``qwen3_tts_tpu/models/codec/vocoder.py``
(the streaming decode comes later; the JAX package's streamed audio equals
its batch decode sample for sample):
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
right-padding the frame axis to a bucket and trimming is exact. f32
throughout, at full matmul and conv precision (TF32 is off, see the
package's ``__init__``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

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
    padded_t = ((t + bucket - 1) // bucket) * bucket
    padded = np.zeros((codes.shape[0], codes.shape[1], padded_t), np.int64)
    padded[..., :t] = codes
    dev = params["first_codebook"].device
    with torch.no_grad():
        wav = decode(params, cfg, torch.from_numpy(padded).to(dev))
    return wav[:, : t * cfg.total_upsample].cpu().numpy()


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
