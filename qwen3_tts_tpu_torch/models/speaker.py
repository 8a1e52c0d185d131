"""ECAPA-TDNN speaker encoder: reference audio -> x-vector.

PyTorch port of ``qwen3_tts_tpu/models/speaker.py``, in float32 on every
device (the JAX package runs it f32 at HIGHEST precision; the package turns
TF32 off at import). Activations are channels-first ``[B, C, T]`` so the
convolutions are ``F.conv1d`` (kernels ``[Cout, Cin, K]``, converted from
the JAX package's ``[K, Cin, Cout]`` by ``models.weights.
speaker_encoder_from_numpy``, or taken as they are from an HF checkpoint by
``SpeakerEncoder.from_weights``); the 1x1 layers of the SE blocks, the
attention head and the final projection are dense ``[Cin, Cout]`` matmuls.

  blocks[0]   TDNN(mel 128 -> ch0, k5)                      + ReLU
  blocks[1-3] SE-Res2Net(ch, k3, dilation 2/3/4, scale 8, SE 128)
  MFA         cat(block outputs) -> TDNN(k1) -> 1536
  ASP         attentive statistics pooling -> [2C]
  FC          1x1 conv -> enc_dim (1024 / 2048), unnormalized

The JAX package pads the mel to a frame bucket and masks reflection and
pooling to the true length, which gives the unpadded result; the port runs
at the true length, so there is nothing to mask.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling
from ..audio.mel import MelSpectrogram, speaker_encoder_config
from ..utils.device import device_or_card
from .config import SpeakerEncoderConfig


def _reflect_index(n: int, left: int, right: int, device) -> torch.Tensor:
    """Rows of a [.., n] axis reflect-padded by (left, right), edge excluded
    (PyTorch's "reflect"): -i for i < 0, 2n-2-i for i >= n, clipped into
    the axis as the JAX package's gather clips (which only matters for n
    below the pad)."""
    idx = torch.arange(-left, n + right, device=device)
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)
    return idx.clamp(0, n - 1)


def _reflect_same_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Conv1d with PyTorch padding="same", padding_mode="reflect".

    x: [B, Cin, T]; w: [Cout, Cin, K]. total_pad = dilation*(K-1), split
    left = total//2, right = the rest.
    """
    total = dilation * (w.shape[-1] - 1)
    if total > 0:
        left = total // 2
        x = x.index_select(2, _reflect_index(x.shape[2], left, total - left, x.device))
    return F.conv1d(x, w, b, dilation=dilation)


def _tdnn(x: torch.Tensor, p: dict, dilation: int = 1) -> torch.Tensor:
    """TimeDelayNetBlock: reflect-same conv + ReLU."""
    return F.relu(_reflect_same_conv(x, p["w"], p["b"], dilation))


def _res2net(x: torch.Tensor, blocks: list, scale: int, dilation: int) -> torch.Tensor:
    """Scale-split cascade: chunk 0 passes; chunk i adds the previous output."""
    chunk = x.shape[1] // scale
    outs = [x[:, :chunk]]
    for i, p in enumerate(blocks):
        piece = x[:, (i + 1) * chunk:(i + 2) * chunk]
        outs.append(_tdnn(piece if i == 0 else piece + outs[-1], p, dilation))
    return torch.cat(outs, dim=1)


def _se_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Squeeze-excitation: mean over T -> 1x1 convs -> sigmoid gate."""
    s = x.mean(dim=2)  # [B, C]
    s = F.relu(s @ p["conv1_w"] + p["conv1_b"])
    s = torch.sigmoid(s @ p["conv2_w"] + p["conv2_b"])
    return x * s[:, :, None]


def _se_res2net(x: torch.Tensor, p: dict, dilation: int, scale: int) -> torch.Tensor:
    h = _tdnn(x, p["tdnn1"])
    h = _res2net(h, p["res2net"], scale, dilation)
    h = _tdnn(h, p["tdnn2"])
    return _se_block(h, p["se"]) + x


def _asp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Attentive statistics pooling over time: [B, C, T] -> [B, 2C]."""
    mean = x.mean(dim=2, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=2, keepdim=True) + 1e-5)
    attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
    a = torch.tanh(_tdnn(attn_in, p["tdnn"]))  # [B, A, T]
    a = a.transpose(1, 2) @ p["conv_w"] + p["conv_b"]  # [B, T, C]
    a = torch.softmax(a, dim=1)  # over time
    xt = x.transpose(1, 2)  # [B, T, C]
    w_mean = (xt * a).sum(dim=1)
    w_std = torch.sqrt((((xt - w_mean[:, None, :]) ** 2) * a).sum(dim=1) + 1e-5)
    return torch.cat([w_mean, w_std], dim=-1)


def forward(params: dict, cfg: SpeakerEncoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """Batched mel [B, n_mels, T] -> embeddings [B, enc_dim] (unnormalized)."""
    h = _tdnn(mel.float(), params["initial"], cfg.enc_dilations[0])
    outs = []
    for i, block in enumerate(params["se_res2net"]):
        h = _se_res2net(h, block, cfg.enc_dilations[i + 1], cfg.enc_res2net_scale)
        outs.append(h)
    h = _tdnn(torch.cat(outs, dim=1), params["mfa"], cfg.enc_dilations[4])
    return _asp(h, params["asp"]) @ params["fc_w"] + params["fc_b"]


class SpeakerEncoder:
    """Audio samples -> x-vector: the mel on the host (numpy, as the JAX
    package computes it), the network on the device that holds ``params``
    (the port's layout: ``models.weights.speaker_encoder_from_numpy``)."""

    def __init__(self, params: dict, cfg: SpeakerEncoderConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["fc_w"].device
        self.mel = MelSpectrogram(replace(speaker_encoder_config(), n_mels=cfg.mel_dim))

    @torch.no_grad()
    def encode(self, samples: np.ndarray) -> np.ndarray:
        """24 kHz mono samples -> [enc_dim] float32 x-vector."""
        with profiling.annotate("q3.speaker_encoder"):
            mel = self.mel.compute_for_speaker_encoder(np.asarray(samples))  # [n_mels, T]
            out = forward(self.params, self.cfg, torch.from_numpy(mel).to(self.device)[None])
            with profiling.annotate("q3.wait"):
                return out[0].cpu().numpy()

    @classmethod
    def from_weights(cls, weights: dict, cfg: SpeakerEncoderConfig | None = None) -> "SpeakerEncoder":
        """An encoder from an HF checkpoint's ``speaker_encoder.*`` tensors, on
        the device that holds them. HF conv kernels are already ``F.conv1d``'s
        ``[Cout, Cin, K]``; the 1x1 layers of the SE blocks, the attention
        head and the final projection become dense ``[Cin, Cout]``."""
        cfg = cfg or SpeakerEncoderConfig()
        p = "speaker_encoder"

        def f32(key):
            return weights[key].float().contiguous()

        def tdnn(key):
            return {"w": f32(f"{key}.conv.weight"), "b": f32(f"{key}.conv.bias")}

        def conv1x1(key):
            return weights[f"{key}.weight"].float()[:, :, 0].t().contiguous(), f32(f"{key}.bias")

        se_blocks = []
        for i in range(1, 4):
            bp = f"{p}.blocks.{i}"
            c1w, c1b = conv1x1(f"{bp}.se_block.conv1")
            c2w, c2b = conv1x1(f"{bp}.se_block.conv2")
            se_blocks.append({
                "tdnn1": tdnn(f"{bp}.tdnn1"),
                "res2net": [tdnn(f"{bp}.res2net_block.blocks.{j}") for j in range(cfg.enc_res2net_scale - 1)],
                "tdnn2": tdnn(f"{bp}.tdnn2"),
                "se": {"conv1_w": c1w, "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b},
            })
        asp_w, asp_b = conv1x1(f"{p}.asp.conv")
        fc_w, fc_b = conv1x1(f"{p}.fc")
        params = {
            "initial": tdnn(f"{p}.blocks.0"),
            "se_res2net": se_blocks,
            "mfa": tdnn(f"{p}.mfa"),
            "asp": {"tdnn": tdnn(f"{p}.asp.tdnn"), "conv_w": asp_w, "conv_b": asp_b},
            "fc_w": fc_w,
            "fc_b": fc_b,
        }
        return cls(params, cfg)

    @classmethod
    def from_random(cls, generator: torch.Generator, cfg: SpeakerEncoderConfig | None = None,
                    device: torch.device | str | None = None) -> "SpeakerEncoder":
        """An encoder of random weights drawn from ``generator`` on the CPU
        (the JAX package's shapes and scales: normal x 0.05, zero biases;
        other numbers than its ``jax.random`` key gives), in the port's
        layout, then placed on ``device`` (the card when None)."""
        cfg = cfg or SpeakerEncoderConfig()
        dev = device_or_card(device)

        def rnd(*shape: int) -> torch.Tensor:
            return (torch.randn(shape, generator=generator) * 0.05).to(dev)

        def zeros(n: int) -> torch.Tensor:
            return torch.zeros(n, device=dev)

        def tdnn(cin: int, cout: int, k: int) -> dict:
            return {"w": rnd(cout, cin, k), "b": zeros(cout)}  # F.conv1d's [Cout, Cin, K]

        ch, ks = cfg.enc_channels, cfg.enc_kernel_sizes
        chunk = ch[1] // cfg.enc_res2net_scale
        se_blocks = [{
            "tdnn1": tdnn(ch[i], ch[i], 1),
            "res2net": [tdnn(chunk, chunk, ks[i]) for _ in range(cfg.enc_res2net_scale - 1)],
            "tdnn2": tdnn(ch[i], ch[i], 1),
            "se": {"conv1_w": rnd(ch[i], cfg.enc_se_channels), "conv1_b": zeros(cfg.enc_se_channels),
                   "conv2_w": rnd(cfg.enc_se_channels, ch[i]), "conv2_b": zeros(ch[i])},
        } for i in range(1, 4)]
        params = {
            "initial": tdnn(cfg.mel_dim, ch[0], ks[0]),
            "se_res2net": se_blocks,
            "mfa": tdnn(sum(ch[1:4]), ch[4], ks[4]),
            "asp": {"tdnn": tdnn(ch[4] * 3, cfg.enc_attention_channels, 1),
                    "conv_w": rnd(cfg.enc_attention_channels, ch[4]), "conv_b": zeros(ch[4])},
            "fc_w": rnd(ch[4] * 2, cfg.enc_dim),
            "fc_b": zeros(cfg.enc_dim),
        }
        return cls(params, cfg)
