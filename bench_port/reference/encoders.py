"""Plain float32 reference of the two audio encoders of a Qwen3-TTS Base model, for the benchmark's check.

* The ECAPA-TDNN speaker encoder (arXiv:2005.07143) with its mel front end:
  a reflect-padded STFT (Hann window, magnitude spectrum), a Slaney mel
  filterbank and log compression; a TDNN, three SE-Res2Net blocks,
  multi-layer feature aggregation, attentive statistics pooling and a
  final 1x1 projection to the x-vector.
* The 12 Hz speech encoder of the speech tokenizer (Mimi, arXiv:2410.00037):
  a SEANet convolution stack with causal padding, a causal transformer
  with a sliding window, a strided downsampling convolution to 12.5 Hz and
  a split residual vector quantiser (one semantic codebook, 15 acoustic
  ones), euclidean nearest neighbour.

Written from their equations in plain PyTorch: every product in float32
with TF32 off, no kernels. It imports nothing of the program under test.
The weights are the benchmark's flat trees, named as a published
checkpoint names them (``speaker_encoder.*`` in the model, ``encoder.*``
in the speech tokenizer), convolution kernels ``[Cout, Cin, K]``, linear
weights ``[out, in]``.

Departures and choices, shared with the program under test: the TDNN
blocks are a convolution and a ReLU with no batch norm (the checkpoint
holds no norm's tensors); both standard deviations of the pooling take
1e-5 under the root; the mel front end is the one the published speaker
encoder uses (24 kHz, n_fft 1024, hop 256, window 1024, 128 bins, 0-12 kHz)
in ``MEL`` below, not a key of the configuration. The speech encoder's
codes are judged stage by stage (``speech_code_gaps``): at each stage the
residual the program's earlier codes leave, since one flipped code at a
near-tie would move every later stage.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# The speaker encoder's front end.
MEL = {"sample_rate": 24000, "n_fft": 1024, "hop": 256, "win": 1024, "fmin": 0.0, "fmax": 12000.0}
STD_EPS = 1e-5  # under the root of both standard deviations of the pooling
CODEBOOK_EPS = 1e-5  # the least cluster usage a codebook entry is divided by


# ---------------------------------------------------------------------------
# Mel front end
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's scale: linear (3 mels a 200 Hz) below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    return np.where(f < 1000.0, lin, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4))


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m < 15.0, m * 200.0 / 3.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0))


def mel_filterbank(n_mels: int) -> np.ndarray:
    """[n_mels, n_fft / 2 + 1] triangles between mel-spaced edges, each
    scaled to unit area in Hz (Slaney's normalisation), float64."""
    n_freqs = MEL["n_fft"] // 2 + 1
    edges = _mel_to_hz(np.linspace(_hz_to_mel(MEL["fmin"]), _hz_to_mel(MEL["fmax"]), n_mels + 2))
    freqs = np.arange(n_freqs) * MEL["sample_rate"] / MEL["n_fft"]
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rising = (freqs - lo) / (mid - lo)
    falling = (hi - freqs) / (hi - mid)
    return np.maximum(0.0, np.minimum(rising, falling)) * (2.0 / (hi - lo))


def speaker_mel(samples: torch.Tensor, n_mels: int) -> torch.Tensor:
    """24 kHz samples [N] -> log mel [n_mels, frames]: the signal reflect-
    padded by (n_fft - hop) / 2 on each side, frames of n_fft every hop under
    a periodic Hann window, the magnitude sqrt(re^2 + im^2 + 1e-9) of their
    spectrum through the filterbank, log(max(., 1e-5))."""
    n_fft, hop = MEL["n_fft"], MEL["hop"]
    pad = (n_fft - hop) // 2
    x = F.pad(samples.to(torch.float32)[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop)  # [T, n_fft]
    i = torch.arange(MEL["win"], dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / MEL["win"])
    spec = torch.fft.rfft(frames * window, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(device=x.device, dtype=torch.float32)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-5)).T


# ---------------------------------------------------------------------------
# ECAPA-TDNN speaker encoder
# ---------------------------------------------------------------------------


def _tdnn(w: dict, key: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Convolution over x [C, T] with 'same' reflect padding (the left side
    the smaller half), then ReLU."""
    kernel, bias = w[f"{key}.conv.weight"].float(), w[f"{key}.conv.bias"].float()
    total = dilation * (kernel.shape[-1] - 1)
    if total:
        x = F.pad(x[None], (total // 2, total - total // 2), mode="reflect")[0]
    return F.relu(F.conv1d(x[None], kernel, bias, dilation=dilation)[0])


def _dense(w: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution ``[Cout, Cin, 1]`` on x [..., Cin]."""
    return x @ w[f"{key}.weight"].float()[:, :, 0].T + w[f"{key}.bias"].float()


def speaker_xvector(w: dict, cfg: dict, samples: torch.Tensor) -> torch.Tensor:
    """24 kHz samples [N] -> the x-vector [enc_dim]."""
    p, dil, scale = "speaker_encoder", cfg["enc_dilations"], cfg["enc_res2net_scale"]
    h = _tdnn(w, f"{p}.blocks.0", speaker_mel(samples, cfg["mel_dim"]), dil[0])
    outs = []
    for i in range(1, 4):
        b = f"{p}.blocks.{i}"
        y = _tdnn(w, f"{b}.tdnn1", h)
        pieces = list(y.chunk(scale, dim=0))
        res = [pieces[0]]
        for j in range(1, scale):
            res.append(_tdnn(w, f"{b}.res2net_block.blocks.{j - 1}", pieces[j] if j == 1 else pieces[j] + res[-1],
                             dil[i]))
        y = _tdnn(w, f"{b}.tdnn2", torch.cat(res))
        gate = torch.sigmoid(_dense(w, f"{b}.se_block.conv2", F.relu(_dense(w, f"{b}.se_block.conv1", y.mean(1)))))
        h = y * gate[:, None] + h
        outs.append(h)
    h = _tdnn(w, f"{p}.mfa", torch.cat(outs), dil[4])
    mean = h.mean(1, keepdim=True)
    std = torch.sqrt(((h - mean) ** 2).mean(1, keepdim=True) + STD_EPS)
    a = torch.tanh(_tdnn(w, f"{p}.asp.tdnn", torch.cat([h, mean.expand_as(h), std.expand_as(h)])))
    a = torch.softmax(_dense(w, f"{p}.asp.conv", a.T), dim=0).T  # [C, T], over time
    w_mean = (h * a).sum(1)
    w_std = torch.sqrt((((h - w_mean[:, None]) ** 2) * a).sum(1) + STD_EPS)
    return _dense(w, f"{p}.fc", torch.cat([w_mean, w_std]))


# ---------------------------------------------------------------------------
# Mimi speech encoder
# ---------------------------------------------------------------------------


def downsample_stride(cfg: dict) -> int:
    """The last convolution's stride: the SEANet's frame rate over the codes'."""
    return round(cfg["sampling_rate"] / math.prod(cfg["upsampling_ratios"]) / cfg["frame_rate"])


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int = 1, mode: str = "constant") -> torch.Tensor:
    """Mimi's causal convolution of x [C, T]: the effective kernel less the
    stride padded on the left, and on the right what completes the last
    frame."""
    k = kernel.shape[-1]
    total = k - stride
    frames = (x.shape[-1] - k + total) / stride + 1
    extra = (math.ceil(frames) - 1) * stride + k - total - x.shape[-1]
    if total + extra > 0:
        x = F.pad(x[None], (total, max(extra, 0)), mode=mode)[0]
    return F.conv1d(x[None], kernel.float(), None if bias is None else bias.float(), stride=stride)[0]


def _conv(w: dict, key: str, x: torch.Tensor, stride: int = 1, mode: str = "constant") -> torch.Tensor:
    return _causal_conv(x, w[f"{key}.weight"], w.get(f"{key}.bias"), stride, mode)


def _layer_norm(w: dict, key: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{key}.weight"].float(), w[f"{key}.bias"].float(), eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [T, heads, D] at positions 0..T-1 (halves rotated)."""
    t, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _transformer(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal layers over x [T, hidden], each query over the ``sliding_window``
    keys up to its own: layer-normed attention and GELU MLP, each branch
    scaled by its layer scale."""
    t, heads, d = x.shape[0], cfg["num_attention_heads"], cfg["head_dim"]
    q_i, k_i = torch.arange(t, device=x.device)[:, None], torch.arange(t, device=x.device)[None, :]
    allowed = (k_i <= q_i) & (q_i - k_i < cfg["sliding_window"])
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.encoder_transformer.layers.{i}"

        def lin(name, v):
            return v @ w[f"{p}.{name}.weight"].float().T

        h = _layer_norm(w, f"{p}.input_layernorm", x, cfg["norm_eps"])
        q = _rope(lin("self_attn.q_proj", h).reshape(t, heads, d), cfg["rope_theta"])
        k = _rope(lin("self_attn.k_proj", h).reshape(t, heads, d), cfg["rope_theta"])
        v = lin("self_attn.v_proj", h).reshape(t, heads, d)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
        att = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        out = lin("self_attn.o_proj", torch.einsum("hqk,khd->qhd", att, v).reshape(t, heads * d))
        x = x + out * w[f"{p}.self_attn_layer_scale.scale"].float()
        h = _layer_norm(w, f"{p}.post_attention_layernorm", x, cfg["norm_eps"])
        x = x + lin("mlp.fc2", F.gelu(lin("mlp.fc1", h))) * w[f"{p}.mlp_layer_scale.scale"].float()
    return x


def speech_hidden(w: dict, cfg: dict, samples: torch.Tensor) -> torch.Tensor:
    """24 kHz samples [N] -> the quantisers' input [T_12.5Hz, hidden]: SEANet
    (a convolution, then for each ratio from the last: an ELU-convolution
    residual unit, ELU and a strided convolution; ELU and a last
    convolution), the transformer at 25 Hz, the downsampling convolution
    (replicate padding)."""
    p = "encoder.encoder.layers"
    x = _conv(w, f"{p}.0.conv", samples.to(torch.float32)[None])
    for i, ratio in enumerate(reversed(cfg["upsampling_ratios"])):
        r = f"{p}.{3 * i + 1}.block"
        x = x + _conv(w, f"{r}.3.conv", F.elu(_conv(w, f"{r}.1.conv", F.elu(x))))
        x = _conv(w, f"{p}.{3 * i + 3}.conv", F.elu(x), stride=ratio)
    x = _conv(w, f"{p}.{3 * len(cfg['upsampling_ratios']) + 2}.conv", F.elu(x))
    x = _transformer(w, cfg, x.T).T
    return _conv(w, "encoder.downsample.conv", x, stride=downsample_stride(cfg), mode="replicate").T


def quantizers(w: dict, cfg: dict) -> list[tuple[torch.Tensor, list[torch.Tensor]]]:
    """The two residual quantisers in code order: (input projection [hidden,
    dim], codebooks [size, dim] each), a codebook its entries' sum over its
    usage (at least ``CODEBOOK_EPS``)."""
    out = []
    for name, n in (("semantic", cfg["num_semantic_quantizers"]),
                    ("acoustic", cfg["num_quantizers"] - cfg["num_semantic_quantizers"])):
        p = f"encoder.quantizer.{name}_residual_vector_quantizer"
        books = [w[f"{p}.layers.{j}.codebook.embed_sum"].float()
                 / w[f"{p}.layers.{j}.codebook.cluster_usage"].float().clamp(min=CODEBOOK_EPS)[:, None]
                 for j in range(n)]
        out.append((w[f"{p}.input_proj.weight"].float()[:, :, 0].T, books))
    return out


def speech_codes(w: dict, cfg: dict, samples: torch.Tensor) -> torch.Tensor:
    """24 kHz samples [N] -> codes [T, num_quantizers]: each stage the
    codeword nearest its residual."""
    h, codes = speech_hidden(w, cfg, samples), []
    for proj, books in quantizers(w, cfg):
        r = h @ proj
        for book in books:
            idx = torch.cdist(r, book).argmin(-1)
            codes.append(idx)
            r = r - book[idx]
    return torch.stack(codes, dim=1)


def speech_code_gaps(w: dict, cfg: dict, samples: torch.Tensor, codes: torch.Tensor) -> torch.Tensor | None:
    """The reference's verdict on codes [T, num_quantizers] of the clip: at
    each stage, by how much farther the code's codeword lies from the
    residual than the nearest codeword does, over the residual's norm
    [T, num_quantizers]; the residual is the reference's, less the given
    codes' codewords of the stages before. None where the code count is not
    the reference's frame count."""
    h = speech_hidden(w, cfg, samples)
    if codes.shape[0] != h.shape[0]:
        return None
    codes, gaps, col = codes.long(), [], 0
    for proj, books in quantizers(w, cfg):
        r = h @ proj
        for book in books:
            dist = torch.sqrt(((r[:, None, :] - book[None]) ** 2).sum(-1))  # [T, size], by differences
            got = dist.gather(1, codes[:, col:col + 1])[:, 0]
            gaps.append((got - dist.min(-1).values) / r.norm(dim=-1).clamp(min=1e-30))
            r = r - book[codes[:, col]]
            col += 1
    return torch.stack(gaps, dim=1)
