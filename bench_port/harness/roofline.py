"""The card's published peaks and the operations and bytes of the work, counted from shapes.

Frozen copies of ``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``bound`` and
``cp_frame_bound`` in ``chip_smoke.py``, and of the counts it makes for
kernel 3 (``talker_trials``) and kernel 2's stream entry
(``kernel2_stream``), taken from a configuration's widths instead of tensors.
Each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

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


def request_flops(dims: dict, frames: int, text_tokens: int, prompt_rows: int = 10) -> int:
    """Model FLOPs of one CustomVoice request of ``frames`` frames: the text
    projection of its rows, the talker's prefill, the frames - 1 steps that
    make codes 1.. (each attending over every row before it), the codec head
    at each of those, the code predictor's 16 rows a frame and 15 heads, and
    the vocoder."""
    t, c, v = dims["talker"], dims["code_predictor"], dims["vocoder"]
    h, e = t["hidden_size"], t["text_hidden_size"]
    f = 2 * (prompt_rows + text_tokens + 1) * (e * e + e * h)
    f += _stack_flops(t, prompt_rows, _tri(prompt_rows))
    steps = frames - 1
    f += _stack_flops(t, steps, sum(prompt_rows + 1 + i for i in range(steps)))
    f += 2 * (steps + 1) * h * t["vocab_size"]
    ch = c["hidden_size"]
    mtp = 2 * 16 * h * ch if h != ch else 0
    f += frames * (_stack_flops(c, 16, _tri(16)) + mtp + 2 * (c["num_code_groups"] - 1) * ch * c["vocab_size"])
    hd = v["num_heads"] * v["head_dim"]
    f += frames * vocoder_flops_per_frame(v) + v["num_layers"] * 4 * _tri(frames) * hd
    return f
