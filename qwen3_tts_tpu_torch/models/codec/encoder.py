"""Mimi speech-tokenizer encoder: 24 kHz audio -> 16-codebook 12.5 Hz codes.

PyTorch port of ``qwen3_tts_tpu/models/codec/encoder.py`` (ICL voice
cloning tokenizes its reference audio with it), f32 on every device (the
package turns TF32 off at import):

  SEANet encoder   conv k7 -> 4 x [resnet, ELU, strided conv k=2r s=r]
                   (ratios 4,5,6,8, channels 64 -> 1024) -> ELU -> conv k3
                   -> [B, T_25hz, 512]
  transformer      8 causal layers, 8 heads x 64, LayerNorm(+bias),
                   gelu MLP 2048, layer-scale, RoPE theta 1e4,
                   sliding window 250
  downsample       causal conv k4 s2 (replicate pad), 25 -> 12.5 Hz
  split RVQ        semantic RVQ (1 codebook) + acoustic RVQ (15 residual
                   codebooks), euclidean nearest neighbour, input
                   projected 512 -> 256 per RVQ

Every conv uses Mimi's causal padding: left pad = effective kernel -
stride, plus right "extra" padding so the last frame is complete. The
SEANet runs channels-first on ``F.conv1d`` (kernels ``[Cout, Cin, K]``,
converted from the JAX package's ``[K, Cin, Cout]`` by ``models.weights.
mimi_encoder_from_numpy``, or taken from an HF speech tokenizer by
``Encoder12Hz.from_weights``). The JAX package pads the audio to a sample
bucket and masks; the port runs at the true length, whose codes the
bucketed ones equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ... import profiling
from .quantizer import nearest_code


@dataclass(frozen=True)
class MimiEncoderConfig:
    sampling_rate: int = 24000
    num_filters: int = 64
    ratios: tuple[int, ...] = (8, 6, 5, 4)  # config order; the encoder applies them reversed
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    compress: int = 2
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    sliding_window: int = 250
    layer_scale: float = 0.01
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 16
    downsample_stride: int = 2


def _causal_pad_amounts(length: int, k_eff: int, stride: int) -> tuple[int, int]:
    """Mimi causal padding: (left, right_extra) for an input of ``length``.

    left = k_eff - stride; the right extra completes the final frame.
    """
    padding_total = k_eff - stride
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - padding_total
    return padding_total, max(ideal - length, 0)


def _mimi_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    stride: int = 1,
    dilation: int = 1,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Causal Mimi conv on channels-first [B, Cin, T]; w [Cout, Cin, K]."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    left, extra = _causal_pad_amounts(x.shape[2], k_eff, stride)
    if left + extra > 0:
        x = F.pad(x, (left, extra), mode=pad_mode)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def _resnet_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """ELU -> conv k3 -> ELU -> conv k1, identity shortcut."""
    h = _mimi_conv(F.elu(x), p["conv1_w"], p["conv1_b"])
    h = _mimi_conv(F.elu(h), p["conv2_w"], p["conv2_b"])
    return x + h


def _seanet_encoder(params: dict, cfg: MimiEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, 1, N] audio -> [B, hidden, T_25hz]."""
    h = _mimi_conv(x, params["init_w"], params["init_b"])
    for stage, ratio in zip(params["stages"], reversed(cfg.ratios)):
        h = F.elu(_resnet_block(h, stage["resnet"]))
        h = _mimi_conv(h, stage["down_w"], stage["down_b"], stride=ratio)
    return _mimi_conv(F.elu(h), params["final_w"], params["final_b"])


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _rope_rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _transformer(params: dict, cfg: MimiEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """8 causal layers with sliding-window attention; x: [B, T, hidden]."""
    b, t, _ = x.shape
    nh, d = cfg.num_heads, cfg.head_dim
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
    emb = torch.cat([pos[:, None] * inv_freq[None, :]] * 2, dim=-1)
    cos, sin = torch.cos(emb)[None, None], torch.sin(emb)[None, None]  # [1, 1, T, D]
    q_idx, k_idx = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None, :]
    mask = (k_idx <= q_idx) & (q_idx - k_idx < cfg.sliding_window)

    def heads(y):
        return y.reshape(b, t, nh, d).transpose(1, 2)

    h = x
    for p in params["layers"]:
        normed = _layer_norm(h, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
        q = _rope_rotate_half(heads(normed @ p["q_proj"]), cos, sin)
        k = _rope_rotate_half(heads(normed @ p["k_proj"]), cos, sin)
        v = heads(normed @ p["v_proj"])
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        attn = torch.softmax(torch.where(mask, scores, torch.full_like(scores, -1e30)), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, t, nh * d) @ p["o_proj"]
        h = h + out * p["attn_scale"]
        normed = _layer_norm(h, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
        h = h + F.gelu(normed @ p["fc1"], approximate="none") @ p["fc2"] * p["mlp_scale"]
    return h


def _rvq_encode(x: torch.Tensor, proj: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Residual VQ encode: x [B, T, hidden] -> codes [Q, B, T]."""
    residual = x @ proj  # [B, T, codebook_dim]
    codes = []
    for codebook in codebooks:
        idx = nearest_code(residual, codebook)
        codes.append(idx)
        residual = residual - codebook[idx]
    return torch.stack(codes)


def rvq_margins(x: torch.Tensor, proj: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``_rvq_encode``'s squared-distance gap between each chosen codeword
    and the runner-up, [Q, B, T]: how far a code is from a tie."""
    residual, gaps = x @ proj, []
    for codebook in codebooks:
        d2 = (residual**2).sum(-1, keepdim=True) - 2.0 * residual @ codebook.T + (codebook**2).sum(-1)
        top2 = torch.topk(d2, 2, dim=-1, largest=False).values
        gaps.append(top2[..., 1] - top2[..., 0])
        residual = residual - codebook[torch.argmin(d2, dim=-1)]
    return torch.stack(gaps)


def hidden(params: dict, cfg: MimiEncoderConfig, audio: torch.Tensor) -> torch.Tensor:
    """[B, N] 24 kHz audio -> the quantizers' input [B, T_12hz, hidden]."""
    h = _seanet_encoder(params["seanet"], cfg, audio.float()[:, None, :])
    h = _transformer(params["transformer"], cfg, h.transpose(1, 2))
    return _mimi_conv(h.transpose(1, 2), params["downsample_w"], None, stride=cfg.downsample_stride,
                      pad_mode="replicate").transpose(1, 2)


def forward(params: dict, cfg: MimiEncoderConfig, audio: torch.Tensor) -> torch.Tensor:
    """[B, N] 24 kHz audio -> [B, T_12hz, num_quantizers] int64 codes."""
    h = hidden(params, cfg, audio)
    semantic = _rvq_encode(h, params["semantic_proj"], params["semantic_codebooks"])  # [1, B, T]
    acoustic = _rvq_encode(h, params["acoustic_proj"], params["acoustic_codebooks"])  # [15, B, T]
    return torch.cat([semantic, acoustic]).permute(1, 2, 0)  # [B, T, 16]


def stage_lengths(cfg: MimiEncoderConfig, n_samples: int) -> tuple[list[int], int, int]:
    """True sequence lengths through the encoder, host ints:
    ([input length of each strided SEANet conv], t_25hz, t_12hz)."""

    def out_len(length: int, k_eff: int, stride: int) -> int:
        left, extra = _causal_pad_amounts(length, k_eff, stride)
        return (length + left + extra - k_eff) // stride + 1

    length = out_len(n_samples, cfg.kernel_size, 1)  # init conv (stride 1)
    lens = []
    for ratio in reversed(cfg.ratios):
        lens.append(length)  # resnet convs are stride-1: length unchanged
        length = out_len(length, 2 * ratio, ratio)
    t25 = out_len(length, cfg.last_kernel_size, 1)
    t12 = out_len(t25, 2 * cfg.downsample_stride, cfg.downsample_stride)
    return lens, t25, t12


class Encoder12Hz:
    """24 kHz samples -> [T, 16] int32 codes on the device that holds
    ``params`` (the port's layout: ``models.weights.mimi_encoder_from_numpy``)."""

    def __init__(self, params: dict, cfg: MimiEncoderConfig = MimiEncoderConfig()):
        self.params = params
        self.cfg = cfg
        self.device = params["downsample_w"].device

    @torch.no_grad()
    def encode(self, samples: np.ndarray) -> np.ndarray:
        with profiling.annotate("q3.speech_encoder") as span:
            samples = np.asarray(samples, np.float32)
            if len(samples) == 0:
                span.set("frames", 0)
                return np.zeros((0, self.cfg.num_quantizers), np.int32)
            _, _, t12 = stage_lengths(self.cfg, len(samples))
            codes = forward(self.params, self.cfg, torch.from_numpy(samples).to(self.device)[None])
            with profiling.annotate("q3.wait"):
                out = codes[0, :t12].to(torch.int32).cpu().numpy()
            span.set("frames", len(out))
            return out

    @classmethod
    def from_weights(cls, weights: dict, cfg: MimiEncoderConfig = MimiEncoderConfig()) -> "Encoder12Hz":
        """An encoder from a speech tokenizer's HF ``encoder.*`` tensors, on the
        device that holds them: conv kernels kept in ``F.conv1d``'s
        ``[Cout, Cin, K]`` (a missing bias is None), linear weights
        ``[in, out]``, each codebook its embedding sum over its usage (at
        least 1e-5). Raises ``KeyError`` on a missing tensor."""
        p = "encoder"

        def f32(key):
            return weights[key].float().contiguous()

        def conv(key):
            bias = f"{key}.bias"
            return f32(f"{key}.weight"), (f32(bias) if bias in weights else None)

        def lin(key):
            return weights[f"{key}.weight"].float().t().contiguous()

        # SEANet layer indices: 0 init; stage i: resnet 3i+1, strided conv 3i+3;
        # the final conv after the last stage (modeling_mimi.MimiEncoder).
        init_w, init_b = conv(f"{p}.encoder.layers.0.conv")
        stages = []
        for i in range(len(cfg.ratios)):
            rb = f"{p}.encoder.layers.{3 * i + 1}.block"
            c1w, c1b = conv(f"{rb}.1.conv")
            c2w, c2b = conv(f"{rb}.3.conv")
            dw, db = conv(f"{p}.encoder.layers.{3 * i + 3}.conv")
            stages.append({"resnet": {"conv1_w": c1w, "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b},
                           "down_w": dw, "down_b": db})
        final_w, final_b = conv(f"{p}.encoder.layers.{3 * len(cfg.ratios) + 2}.conv")

        layers = []
        for i in range(cfg.num_layers):
            lp = f"{p}.encoder_transformer.layers.{i}"
            layers.append({
                "ln1_w": f32(f"{lp}.input_layernorm.weight"),
                "ln1_b": f32(f"{lp}.input_layernorm.bias"),
                "q_proj": lin(f"{lp}.self_attn.q_proj"),
                "k_proj": lin(f"{lp}.self_attn.k_proj"),
                "v_proj": lin(f"{lp}.self_attn.v_proj"),
                "o_proj": lin(f"{lp}.self_attn.o_proj"),
                "attn_scale": f32(f"{lp}.self_attn_layer_scale.scale"),
                "ln2_w": f32(f"{lp}.post_attention_layernorm.weight"),
                "ln2_b": f32(f"{lp}.post_attention_layernorm.bias"),
                "fc1": lin(f"{lp}.mlp.fc1"),
                "fc2": lin(f"{lp}.mlp.fc2"),
                "mlp_scale": f32(f"{lp}.mlp_layer_scale.scale"),
            })

        def codebook(key):
            usage = weights[f"{key}.cluster_usage"].float().clamp(min=1e-5)
            return weights[f"{key}.embed_sum"].float() / usage[:, None]

        def proj(key):  # a 1x1 conv [out, in, 1] as dense [in, out]
            return weights[f"{key}.input_proj.weight"].float()[:, :, 0].t().contiguous()

        sq = f"{p}.quantizer.semantic_residual_vector_quantizer"
        aq = f"{p}.quantizer.acoustic_residual_vector_quantizer"
        params = {
            "seanet": {"init_w": init_w, "init_b": init_b, "stages": stages, "final_w": final_w, "final_b": final_b},
            "transformer": {"layers": layers},
            "downsample_w": f32(f"{p}.downsample.conv.weight"),
            "semantic_proj": proj(sq),
            "semantic_codebooks": torch.stack([codebook(f"{sq}.layers.0.codebook")]),
            "acoustic_proj": proj(aq),
            "acoustic_codebooks": torch.stack(
                [codebook(f"{aq}.layers.{i}.codebook") for i in range(cfg.num_quantizers - 1)]),
        }
        return cls(params, cfg)
