"""Codec building blocks: causal convs, SnakeBeta, ConvNeXt, decoder blocks.

PyTorch port of ``qwen3_tts_tpu/models/codec/blocks.py``, in the JAX
package's channels-last layout: activations ``[batch, time, channels]``,
conv kernels ``[K, Cin/groups, Cout]``. Dense convs run as K shifted matmuls
and depthwise convs as K shifted broadcast multiplies (the JAX package's
taps form), so the two packages sum in the same order; other group counts
as K shifted products a group. Every op is causal
(output at t depends only on inputs <= t), which makes right-padded time
bucketing exact for the whole vocoder.

Matmuls here are f32 at full precision: the package turns TF32 off at import.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Left-padded causal conv. x: [B, T, Cin]; kernel: [K, Cin/groups, Cout].

    out[t] = sum_i x[t - (k-1-i)*d] @ w[i], taps ascending. Dense
    (groups=1) taps are matmuls and depthwise (groups == Cin == Cout) taps
    broadcast multiplies; any other ``groups`` (the JAX package's
    ``conv_general_dilated`` with ``feature_group_count``) takes, a tap at a
    time, one product a group: output channels [g·Cout/G, (g+1)·Cout/G) from
    input channels [g·Cin/G, (g+1)·Cin/G). Channels that ``groups`` does not
    divide raise ``ValueError``, as XLA refuses them.
    """
    k, cpg, cout = kernel.shape
    b, t, cin = x.shape
    pad = dilation * (k - 1)
    xp = F.pad(x, (0, 0, pad, 0))
    if groups == 1:
        taps = (xp[:, i * dilation : i * dilation + t] @ kernel[i] for i in range(k))
    elif groups == cin and cpg == 1 and cout == cin:
        taps = (xp[:, i * dilation : i * dilation + t] * kernel[i, 0] for i in range(k))
    else:
        if groups < 1 or cin % groups or cout % groups or cin // groups != cpg:
            raise ValueError(f"causal_conv1d: groups={groups} does not divide x's {cin} input channels into the "
                             f"kernel's {tuple(kernel.shape)} [K, Cin/groups, Cout]")
        # [K, G, Cin/G, Cout/G]: group g's columns of the kernel.
        wg = kernel.reshape(k, cpg, groups, cout // groups).transpose(1, 2)

        def tap(i: int) -> torch.Tensor:
            xg = xp[:, i * dilation : i * dilation + t].reshape(b * t, groups, cpg).transpose(0, 1)
            return (xg @ wg[i]).transpose(0, 1).reshape(b, t, cout)

        taps = (tap(i) for i in range(k))
    out = None
    for o in taps:
        out = o if out is None else out + o
    if bias is not None:
        out = out + bias
    return out


def causal_trans_conv1d(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, stride: int
) -> torch.Tensor:
    """Transposed conv with right-trim to exactly T*stride outputs.

    x: [B, T, Cin]; kernel: [K, Cout, Cin]. Polyphase form: with output index
    t = u*stride + r, out[u*stride + r] = sum_m x[u - m] @ W[r + m*stride],
    so each of the ceil(K/stride) taps is one [T, Cin] @ [Cin, stride*Cout]
    matmul and the phase axis reshapes into time.
    """
    b, t, cin = x.shape
    k, cout, _ = kernel.shape
    s = stride
    m_max = -(-k // s)
    wpad = torch.zeros((m_max * s, cout, cin), dtype=kernel.dtype, device=kernel.device)
    wpad[:k] = kernel
    # [m_max, s, Cout, Cin] -> per-tap [Cin, s*Cout] with r-major columns.
    wm = wpad.reshape(m_max, s, cout, cin).permute(0, 3, 1, 2).reshape(m_max, cin, s * cout)
    out = torch.zeros((b, t, s * cout), dtype=x.dtype, device=x.device)
    for m in range(m_max):
        xm = x if m == 0 else F.pad(x, (0, 0, m, 0))[:, :t]
        out = out + xm @ wm[m]
    out = out.reshape(b, t * s, cout)
    if bias is not None:
        out = out + bias
    return out


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta activation: x + sin^2(exp(alpha) * x) / (exp(beta) + 1e-9).

    alpha, beta: [C]; x channels-last.
    """
    a = torch.exp(alpha)
    inv_b = 1.0 / (torch.exp(beta) + 1e-9)
    s = torch.sin(x * a)
    return x + s * s * inv_b


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def convnext_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Depthwise causal conv k7 -> LayerNorm -> Linear 4x -> GELU(erf) ->
    Linear -> gamma scale -> residual. x: [B, T, C]."""
    h = causal_conv1d(x, p["dwconv_w"], p["dwconv_b"], groups=x.shape[-1])
    h = layer_norm(h, p["norm_w"], p["norm_b"])
    h = h @ p["pwconv1_w"] + p["pwconv1_b"]
    h = F.gelu(h, approximate="none")
    h = h @ p["pwconv2_w"] + p["pwconv2_b"]
    return x + h * p["gamma"]


def residual_unit(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    """Snake -> dilated causal conv k7 -> Snake -> 1x1 conv -> residual.

    f32 units with C <= 512 (the vocoder's tail) go to the fused kernel's
    wrapper (``fused_blocks.residual_unit``); wider ones run the taps form.
    """
    from . import fused_blocks

    if fused_blocks.residual_unit_should_fuse(x):
        return fused_blocks.residual_unit(x, p, dilation)
    return fused_blocks.residual_unit_plain(x, p, dilation)


def decoder_block(x: torch.Tensor, p: dict, rate: int) -> torch.Tensor:
    """BigVGAN-style block: Snake -> TransConv(x rate) -> 3 residual units
    (dilations 1, 3, 9)."""
    h = snake_beta(x, p["snake_alpha"], p["snake_beta"])
    h = causal_trans_conv1d(h, p["up_w"], p["up_b"], rate)
    h = residual_unit(h, p["res1"], 1)
    h = residual_unit(h, p["res2"], 3)
    return residual_unit(h, p["res3"], 9)


def upsample_stage(x: torch.Tensor, p: dict, ratio: int) -> torch.Tensor:
    """Pre-decoder upsample: TransConv(x ratio) -> ConvNeXt block."""
    h = causal_trans_conv1d(x, p["up_w"], p["up_b"], ratio)
    return convnext_block(h, p["convnext"])
