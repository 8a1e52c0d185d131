"""The card's published peaks and the operations and bytes of the work, counted from shapes.

Frozen copies of ``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``bound`` and
``cp_frame_bound`` in ``chip_smoke.py``, and of the counts it makes for
kernel 3 (``talker_trials``) and kernel 2's stream entry
(``kernel2_stream``), taken from a configuration's widths instead of tensors.
Each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

import math

from .spec import downsample_stride

# NVIDIA H100 SXM data sheet, dense rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}
# Vocoder rows a frame at the channel counts of kernel 2's units (C <= 512).
UNIT_ROWS_PER_FRAME = {384: 160, 192: 640, 96: 1920}
UNIT_DILATIONS = (1, 3, 9)


def bound_ms(n_bytes: float, ops: float, kind: str = "bf16") -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]) * 1e3


def layer_params(c: dict) -> tuple[int, int]:
    """(projection weights, norm weights) of one decoder layer."""
    h, inter, d = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    q, kv = c["num_attention_heads"] * d, c["num_key_value_heads"] * d
    return h * (q + 2 * kv) + q * h + 2 * h * inter + inter * h, 2 * d + 2 * h


def cp_frame_bound_ms(dims: dict) -> float:
    """Kernel 1, one frame: every weight read once (layer projections and
    norms, the final norm, the 15 heads, the mtp projection), the two input
    rows and the 14 embedding rows the codes pick, the 15 codes written;
    operations: the 16 positions through every projection and the mtp
    projection, and the 15 heads."""
    c, e = dims["code_predictor"], dims["talker"]["hidden_size"]
    item = ITEM[dims["dtype"]]
    proj, norms = layer_params(c)
    layers = c["num_hidden_layers"]
    g, h, v = c["num_code_groups"] - 1, c["hidden_size"], c["vocab_size"]
    mtp = e * h + h if e != h else 0
    mtp_w = e * h if e != h else 0
    n_bytes = item * (layers * (proj + norms) + g * h * v + h + mtp) + (g + 1) * e * item + g * 4
    ops = 2 * (16 * (layers * proj + mtp_w) + g * h * v)
    return bound_ms(n_bytes, ops)


def talker_step_bound_ms(dims: dict, pos: int) -> float:
    """Kernel 3, one step writing cache row ``pos``: the layers' weights once,
    the input and output rows, the pos + 1 live rows of K and V read in every
    layer; operations: the projections and the attention over those rows."""
    t = dims["talker"]
    item = ITEM[dims["dtype"]]
    proj, norms = layer_params(t)
    layers, d = t["num_hidden_layers"], t["head_dim"]
    kvd = t["num_key_value_heads"] * d
    n_bytes = item * (layers * (proj + norms) + 2 * t["hidden_size"]) + layers * (pos + 1) * 2 * kvd * item
    ops = 2 * layers * proj + layers * 4 * (pos + 1) * t["num_attention_heads"] * d
    return bound_ms(n_bytes, ops)


def residual_unit_chunk_bound_ms(frames: int) -> float:
    """Kernel 2's stream entry over one chunk of ``frames`` frames: its 9
    units (C = 384 / 192 / 96, dilations 1 / 3 / 9), each reading its carried
    6 * d rows and the chunk's rows, writing the chunk's rows, reading its
    weights (a k7 and a 1x1 convolution, biases, two SnakeBeta pairs), f32;
    operations: both convolutions' products over the chunk's rows in 3xTF32
    (three TF32 products each)."""
    n_bytes = ops = 0
    for c, per in UNIT_ROWS_PER_FRAME.items():
        rows = frames * per
        for d in UNIT_DILATIONS:
            n_bytes += 4 * (6 * d + 2 * rows) * c + 4 * (8 * c * c + 6 * c)
            ops += 2 * rows * c * c * 8
    return bound_ms(n_bytes, 3 * ops, "tf32")


# ---------------------------------------------------------------------------
# Model FLOPs of a request, for the whole step's share of the peak
# ---------------------------------------------------------------------------


def _stack_flops(c: dict, rows: int, attended: int) -> int:
    """``rows`` rows through a decoder stack, attending over ``attended``
    (row, key) pairs in all: the products and the attention's two."""
    proj, _ = layer_params(c)
    return c["num_hidden_layers"] * (2 * rows * proj + 4 * attended * c["num_attention_heads"] * c["head_dim"])


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def vocoder_flops_per_frame(v: dict) -> int:
    """The 12 Hz decoder's products a frame, past the pre-transformer's
    attention: the causal convolutions (taps x Cin x Cout a row), the
    transposed convolutions, the ConvNeXt and pre-transformer layers."""
    cb, lat, hs = v["codebook_dim"], v["latent_dim"], v["hidden_size"]
    hd, inter = v["num_heads"] * v["head_dim"], v["intermediate_size"]
    f = 2 * 3 * cb * lat + 2 * lat * hs + 2 * hs * lat
    f += v["num_layers"] * 2 * (3 * hs * hd + hd * hs + 3 * hs * inter)
    rows = 1
    for r in v["upsampling_ratios"]:
        f += rows * 2 * (2 * r) * lat * lat  # transposed conv: its taps on each input row
        rows *= r
        f += rows * (2 * 7 * lat + 2 * 2 * lat * 4 * lat)  # ConvNeXt
    ch = v["decoder_dim"]
    f += rows * 2 * 7 * lat * ch
    for r in v["upsample_rates"]:
        out = ch // 2
        f += rows * 2 * (2 * r) * ch * out
        rows *= r
        f += rows * 3 * 2 * 8 * out * out  # three residual units: k7 and 1x1
        ch = out
    return f + rows * 2 * v["final_kernel"] * ch


def request_flops(dims: dict, frames: int, text_tokens: int, prompt_rows: int = 10, text_rows: int | None = None,
                  prefix_frames: int = 0, encoder_flops: int = 0) -> int:
    """Model FLOPs of one request of ``frames`` frames: the text projection of
    its ``text_rows`` rows (a preset speaker's prompt_rows + text_tokens + 1:
    the prompt's, the trailing text's and the pad's), the talker's prefill of
    ``prompt_rows``, the frames - 1 steps that make codes 1.. (each attending
    over every row before it), the codec head at each of those, the code
    predictor's 16 rows a frame and 15 heads, and the vocoder over the
    frames behind ``prefix_frames`` reference frames that it decodes first
    (an in-context clone's), attending over all of them; and
    ``encoder_flops`` (``encoder_flops``, where the request makes its clone
    prompt). The defaults are a preset speaker's 10-row prompt."""
    t, c, v = dims["talker"], dims["code_predictor"], dims["vocoder"]
    h, e = t["hidden_size"], t["text_hidden_size"]
    if text_rows is None:
        text_rows = prompt_rows + text_tokens + 1
    f = 2 * text_rows * (e * e + e * h)
    f += _stack_flops(t, prompt_rows, _tri(prompt_rows))
    steps = frames - 1
    f += _stack_flops(t, steps, sum(prompt_rows + 1 + i for i in range(steps)))
    f += 2 * (steps + 1) * h * t["vocab_size"]
    ch = c["hidden_size"]
    mtp = 2 * 16 * h * ch if h != ch else 0
    f += frames * (_stack_flops(c, 16, _tri(16)) + mtp + 2 * (c["num_code_groups"] - 1) * ch * c["vocab_size"])
    hd = v["num_heads"] * v["head_dim"]
    decoded = frames + prefix_frames
    f += decoded * vocoder_flops_per_frame(v) + v["num_layers"] * 4 * _tri(decoded) * hd
    return f + encoder_flops


# ---------------------------------------------------------------------------
# A Base model's audio encoders, on a clip of n samples
# ---------------------------------------------------------------------------


def _causal_len(length: int, k: int, stride: int) -> int:
    """The output length of Mimi's causal convolution (padded to whole frames)."""
    return math.ceil((length - k + (k - stride)) / stride + 1)


def speaker_encoder_flops(s: dict, samples: int) -> int:
    """The ECAPA-TDNN's products over a clip's mel frames (hop 256 after a
    (1024 - 256) / 2 reflect pad a side): its convolutions, the SE gates,
    the pooling's two and the projection. The mel runs on the host and is
    not counted."""
    t = (samples + 768 - 1024) // 256 + 1
    ch, ks, scale, se, att = (s["enc_channels"], s["enc_kernel_sizes"], s["enc_res2net_scale"],
                              s["enc_se_channels"], s["enc_attention_channels"])
    f = 2 * t * s["mel_dim"] * ch[0] * ks[0]
    for i in range(1, 4):
        part = ch[i] // scale
        f += 2 * t * (ch[i - 1] * ch[i] + ch[i] * ch[i]) + (scale - 1) * 2 * t * part * part * ks[i]
        f += 2 * 2 * ch[i] * se
    f += 2 * t * sum(ch[1:4]) * ch[4] * ks[4]
    f += 2 * t * (3 * ch[4] * att + att * ch[4]) + 2 * 2 * ch[4] * s["enc_dim"]
    return f


def speech_encoder_flops(e: dict, samples: int) -> int:
    """The 12 Hz speech encoder's products over a clip: SEANet's convolutions
    at each stage's length, the transformer at 25 Hz (attention over the
    sliding window), the downsampling convolution, the two quantisers'
    projections and every stage's distances to its whole codebook."""
    length, ch = _causal_len(samples, e["kernel_size"], 1), e["num_filters"]
    f = 2 * length * ch * e["kernel_size"]
    for r in reversed(e["upsampling_ratios"]):
        half = ch // e["compress"]
        f += 2 * length * (ch * half * e["residual_kernel_size"] + half * ch)
        length = _causal_len(length, 2 * r, r)
        f += 2 * length * ch * 2 * ch * 2 * r
        ch *= 2
    h, hd = e["hidden_size"], e["num_attention_heads"] * e["head_dim"]
    f += 2 * length * ch * h * e["last_kernel_size"]
    pairs = sum(min(q + 1, e["sliding_window"]) for q in range(length))
    f += e["num_hidden_layers"] * (2 * length * (4 * h * hd + 2 * h * e["intermediate_size"]) + 4 * pairs * hd)
    stride = downsample_stride(e)
    frames = _causal_len(length, 2 * stride, stride)
    f += 2 * frames * h * h * 2 * stride
    return f + 2 * frames * (2 * h * e["codebook_dim"] + e["num_quantizers"] * e["codebook_size"] * e["codebook_dim"])


def encoder_flops(dims: dict, samples: int, icl: bool) -> int:
    """A clone prompt's encoders on a clip: the speaker encoder, and for an
    in-context clone the speech encoder too."""
    f = speaker_encoder_flops(dims["speaker_encoder"], samples)
    return f + speech_encoder_flops(dims["speech_encoder"], samples) if icl else f
