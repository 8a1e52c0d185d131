"""Legacy 25 Hz codec decoder (exported utility; not in the main pipeline).

PyTorch port of ``qwen3_tts_tpu/models/codec/legacy_decoder.py``: a generic
BigVGAN-style decoder on the generic RVQ utility: RVQ de-embed (the
quantizers' embeddings concatenated) -> input projection -> bidirectional
pre-transformer -> upsample stages (transposed conv + leaky ReLU + 3
residual conv blocks) -> final conv. The production path is
``vocoder.decode``; this exists for codec experiments and API parity. f32
with TF32 off (the package pins both flags at import); no kernel of its
own (the JAX module has none either). The parameter tree keeps linear
weights as [in, out], as the JAX tree does, and conv kernels in PyTorch's
layouts (conv [Cout, Cin, K], transposed conv [Cin, Cout, K]), as the HF
checkpoint holds them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops import nn
from ...utils.device import device_or_card
from .quantizer import ResidualVectorQuantizer

EPS = 1e-6


@dataclass(frozen=True)
class LegacyDecoderConfig:
    hidden_size: int = 1024
    num_layers: int = 8
    num_heads: int = 16
    upsample_ratios: tuple[int, ...] = (4, 5, 8, 3)  # 480x total
    num_quantizers: int = 16
    codebook_dim: int = 256
    codebook_size: int = 2048
    out_channels: int = 1

    @property
    def total_upsample(self) -> int:
        t = 1
        for r in self.upsample_ratios:
            t *= r
        return t

    def output_length(self, seq_len: int) -> int:
        """Exact sample count for ``seq_len`` frames under ConvTranspose1d
        semantics: an odd (k - stride) adds one sample a stage (k = 2 *
        ratio, padding (k - stride) // 2)."""
        t = seq_len
        for r in self.upsample_ratios:
            k, pad = 2 * r, (2 * r - r) // 2
            t = (t - 1) * r + k - 2 * pad
        return t


def _same_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """SAME-padded conv on [B, C, T] (k // 2 in front, the rest behind, as
    the JAX package pads); weight [Cout, Cin, K]."""
    k = weight.shape[-1]
    return F.conv1d(F.pad(x, (k // 2, k - 1 - k // 2)), weight, bias)


def _channel_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the channels of [B, C, T]."""
    return nn.rms_norm(x.transpose(1, 2), weight, EPS).transpose(1, 2)


def _residual_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = F.silu(_same_conv(_channel_norm(x, p["norm1"]), p["conv1_w"], p["conv1_b"]))
    return x + _same_conv(_channel_norm(h, p["norm2"]), p["conv2_w"], p["conv2_b"])


def _linear(x: torch.Tensor, layer: dict, key: str) -> torch.Tensor:
    out = x @ layer[key]
    bias = layer.get(key + "_b")
    return out if bias is None else out + bias


class CodecDecoder:
    """Generic 25 Hz RVQ decoder."""

    def __init__(self, params: dict, cfg: LegacyDecoderConfig = LegacyDecoderConfig()):
        self.params = params
        self.cfg = cfg
        self.quantizer = ResidualVectorQuantizer(params["codebooks"])

    @property
    def device(self) -> torch.device:
        return self.params["codebooks"].device

    @torch.no_grad()
    def decode(self, tokens) -> torch.Tensor:
        """tokens [B, Q, S] (a tensor or an array) -> audio [B,
        ``cfg.output_length(S)``] on the decoder's device."""
        cfg, p = self.cfg, self.params
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        emb = self.quantizer.decode(tokens)  # [B, S, Q, D]
        b, s, q, d = emb.shape
        x = emb.reshape(b, s, q * d) @ p["input_proj_w"] + p["input_proj_b"]
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        for layer in p["layers"]:
            normed = nn.rms_norm(x, layer["norm1"], EPS)
            qh, kh, vh = (_linear(normed, layer, key).reshape(b, s, nh, hd) for key in ("q", "k", "v"))
            attn = nn.gqa_attention(qh, kh, vh, None, 1.0 / hd**0.5)
            x = x + _linear(attn.reshape(b, s, nh * hd), layer, "o")
            normed = nn.rms_norm(x, layer["norm2"], EPS)
            x = x + _linear(F.silu(_linear(normed, layer, "fc1")), layer, "fc2")
        x = nn.rms_norm(x, p["pre_norm"], EPS).transpose(1, 2)  # [B, C, S]
        for stage, ratio in zip(p["upsample"], cfg.upsample_ratios):
            k = stage["up_w"].shape[-1]
            x = F.conv_transpose1d(x, stage["up_w"], stage["up_b"], stride=ratio, padding=(k - ratio) // 2)
            x = F.leaky_relu(x, 0.1)
            for block in stage["res"]:
                x = _residual_block(x, block)
        return _same_conv(x, p["final_w"], p["final_b"])[:, 0]

    @classmethod
    def from_weights(
        cls,
        weights: dict,
        cfg: LegacyDecoderConfig = LegacyDecoderConfig(),
        prefix: str = "",
        device: torch.device | str | None = None,
    ) -> "CodecDecoder":
        """Build from safetensors weights (tensors or arrays), on ``device``
        (the card when None). Keys relative to ``prefix``:
        ``quantizer.layers.{i}.codebook.weight``, ``input_proj.{weight,bias}``,
        ``pre_transformer.{i}.self_attn.{q,k,v,o}_proj.* / mlp.fc{1,2}.* /
        norm{1,2}.weight``, ``pre_norm.weight``, ``upsample.{i}.conv.*``
        (ConvTranspose [Cin, Cout, K]), ``residual.{i}.{j}.conv{1,2}.* /
        norm{1,2}.weight``, ``final_conv.{weight,bias}``."""
        dev = device_or_card(device)

        def arr(key: str) -> torch.Tensor:
            return torch.as_tensor(weights[prefix + key], dtype=torch.float32).to(dev)

        def lin_t(key: str) -> torch.Tensor:  # [out, in] -> [in, out]
            return arr(key + ".weight").T.contiguous()

        layers = []
        for i in range(cfg.num_layers):
            lp = f"pre_transformer.{i}."
            layer = {"norm1": arr(lp + "norm1.weight"), "norm2": arr(lp + "norm2.weight")}
            for key, name in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
                              ("o", "self_attn.o_proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                layer[key] = lin_t(lp + name)
                layer[key + "_b"] = arr(lp + name + ".bias")
            layers.append(layer)
        upsample = []
        for i in range(len(cfg.upsample_ratios)):
            res = []
            for j in range(3):
                rp = f"residual.{i}.{j}."
                res.append({"norm1": arr(rp + "norm1.weight"), "conv1_w": arr(rp + "conv1.weight"),
                            "conv1_b": arr(rp + "conv1.bias"), "norm2": arr(rp + "norm2.weight"),
                            "conv2_w": arr(rp + "conv2.weight"), "conv2_b": arr(rp + "conv2.bias")})
            upsample.append({"up_w": arr(f"upsample.{i}.conv.weight"), "up_b": arr(f"upsample.{i}.conv.bias"),
                             "res": res})
        params = {
            "codebooks": torch.stack([arr(f"quantizer.layers.{i}.codebook.weight")
                                      for i in range(cfg.num_quantizers)]),
            "input_proj_w": lin_t("input_proj"),
            "input_proj_b": arr("input_proj.bias"),
            "layers": layers,
            "pre_norm": arr("pre_norm.weight"),
            "upsample": upsample,
            "final_w": arr("final_conv.weight"),
            "final_b": arr("final_conv.bias"),
        }
        return cls(params, cfg)

    @classmethod
    def random(
        cls,
        generator: torch.Generator,
        cfg: LegacyDecoderConfig = LegacyDecoderConfig(),
        device: torch.device | str | None = None,
    ) -> "CodecDecoder":
        """Random weights drawn from ``generator`` on the CPU (the JAX
        package's shapes and scales; other numbers than its ``jax.random``
        key gives), then placed on ``device`` (the card when None)."""
        dev = device_or_card(device)
        h = cfg.hidden_size

        def rnd(*shape: int, scale: float = 0.02) -> torch.Tensor:
            return (torch.randn(shape, generator=generator) * scale).to(dev)

        def ones(n: int) -> torch.Tensor:
            return torch.ones(n, device=dev)

        def zeros(n: int) -> torch.Tensor:
            return torch.zeros(n, device=dev)

        layers = [{"norm1": ones(h), "q": rnd(h, h), "k": rnd(h, h), "v": rnd(h, h), "o": rnd(h, h),
                   "norm2": ones(h), "fc1": rnd(h, 4 * h), "fc2": rnd(4 * h, h)} for _ in range(cfg.num_layers)]
        upsample = []
        ch = h
        for r in cfg.upsample_ratios:
            out = ch // 2
            res = [{"norm1": ones(out), "conv1_w": rnd(out, out, 7), "conv1_b": zeros(out), "norm2": ones(out),
                    "conv2_w": rnd(out, out, 7), "conv2_b": zeros(out)} for _ in range(3)]
            upsample.append({"up_w": rnd(ch, out, 2 * r), "up_b": zeros(out), "res": res})
            ch = out
        params = {
            "codebooks": rnd(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim, scale=1.0),
            "input_proj_w": rnd(cfg.codebook_dim * cfg.num_quantizers, h),
            "input_proj_b": zeros(h),
            "layers": layers,
            "pre_norm": ones(h),
            "upsample": upsample,
            "final_w": rnd(cfg.out_channels, ch, 7),
            "final_b": zeros(cfg.out_channels),
        }
        return cls(params, cfg)
