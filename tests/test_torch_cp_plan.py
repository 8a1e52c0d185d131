"""The launch plan of kernel 1 (``fused_layer.cp_frame_plan``) on the CPU.

The frame kernel takes its grid, each projection's column ownership and its
ring's tile sizes from this plan; the kernel itself runs only on a card
(``tests/test_torch_kernels.py``). Here: at the 1.7B code predictor's widths
in all three weight kinds, and at the small configs the card tests and
``chip_smoke.py`` run, every output column of every projection and head is
owned by exactly one block, the tiles cover K exactly once, a block's shared
memory fits an H100's 232,448 bytes and the grid its 132 SMs; shapes the
kernel cannot take raise.
"""

from dataclasses import replace

import pytest
import torch

from qwen3_tts_tpu_torch.models import code_predictor
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer

CP_1P7B = config_for_variant("1.7B", "custom_voice").code_predictor
CP_0P6B = config_for_variant("0.6B", "custom_voice").code_predictor
# tests/test_torch_kernels.py's CP_CFG and chip_smoke.py's small models.
CP_TEST = CodePredictorConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=512, codec_embed_dim=512,
)
CP_SMALL = CodePredictorConfig(
    hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
    num_key_value_heads=1, head_dim=64, vocab_size=256,
)
CP_SMALL_INT8 = CodePredictorConfig(
    hidden_size=256, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=256,
)
# The widest vocab the kernel takes (2^16): head slices wider than a TMA
# box row, streamed in 256-column segments.
CP_WIDE_VOCAB = replace(CP_1P7B, vocab_size=65536)
CONFIGS = {"1.7B": CP_1P7B, "0.6B": CP_0P6B, "test": CP_TEST, "small": CP_SMALL, "small_int8": CP_SMALL_INT8,
           "wide_vocab": CP_WIDE_VOCAB}
KINDS = [("float32", torch.float32), ("bfloat16", torch.bfloat16), ("int8", torch.bfloat16), ("int8", torch.float32)]


def _shapes(cfg):
    sc = cfg.layer_stack()
    qd, kvd = sc.num_heads * sc.head_dim, sc.num_kv_heads * sc.head_dim
    shapes = {
        "qkv": (sc.hidden_size, qd + 2 * kvd), "o": (qd, sc.hidden_size),
        "gate_up": (sc.hidden_size, 2 * sc.intermediate_size), "down": (sc.intermediate_size, sc.hidden_size),
        "head": (sc.hidden_size, cfg.vocab_size),
    }
    if cfg.needs_projection:
        shapes["mtp"] = (cfg.embed_dim, sc.hidden_size)
    return shapes


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kind,dtype", KINDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_owns_every_column_once(name, kind, dtype, sms):
    cfg = CONFIGS[name]
    plan = fused_layer.cp_frame_plan(cfg, kind, dtype, sms)
    shapes = _shapes(cfg)
    assert set(plan.projs) == set(shapes)
    assert cfg.num_attention_heads <= plan.grid <= min(sms, 132)
    assert plan.smem_bytes <= fused_layer.CP_FRAME_SMEM_LIMIT
    # The regions follow the ring in order, 128-byte aligned, and each holds
    # two rows of what the kernel puts there (the kernel checks the same).
    at = [fused_layer.CP_FRAME_STAGES * plan.stage_bytes, *plan.regions.values(), plan.smem_bytes]
    assert list(plan.regions) == ["xs", "red", "cs", "own", "misc"]
    assert at == sorted(at) and all(a % 128 == 0 for a in at[:-1])
    room = {name: (b - a) // 8 for name, a, b in zip(plan.regions, at[1:], at[2:])}
    assert room["misc"] * 2 >= fused_layer.CP_FRAME_MISC_FLOATS
    assert room["own"] >= plan.projs["o"].nv * plan.projs["o"].vec
    assert plan.projs["down"].nv == plan.projs["o"].nv
    for proj, (k, n) in shapes.items():
        p = plan.projs[proj]
        assert (p.k, p.n) == (k, n), proj
        assert p.nv & (p.nv - 1) == 0 and p.nv * p.halves <= fused_layer.CP_FRAME_THREADS
        nvt = p.nv * p.halves
        groups = 8 if nvt < 32 else fused_layer.CP_FRAME_THREADS // nvt
        assert room["xs"] >= k and room["red"] >= groups * nvt * p.vec and room["cs"] >= nvt * p.vec, proj
        assert 1 <= p.blocks <= plan.grid
        owned = [c for b in range(p.blocks) for c in p.columns(b)]
        assert sorted(owned) == list(range(n)), proj  # each column exactly once
        assert all(p.columns(b) for b in range(p.blocks)) and not p.columns(p.blocks)
        # A block's gate and up columns are the same SiLU*up inputs.
        if proj == "gate_up":
            for b in range(p.blocks):
                cols = p.columns(b)
                gate, up = cols[: len(cols) // 2], cols[len(cols) // 2 :]
                assert [c + n // 2 for c in gate] == up
        # The tiles cover K exactly once, each fits a ring stage and is whole
        # TMA boxes, and a box's rows land 128-byte aligned.
        rows = [r for k0 in range(0, k, p.tile_rows) for r in range(k0, min(k0 + p.tile_rows, k))]
        assert rows == list(range(k))
        assert p.tile_rows * p.nv * p.halves * 16 <= plan.stage_bytes
        assert p.box_rows & (p.box_rows - 1) == 0 and p.box_rows <= 256
        assert k % p.box_rows == 0 and p.tile_rows % p.box_rows == 0 and p.box_rows * p.nv * 16 % 128 == 0
        item = 1 if kind == "int8" and proj != "mtp" else torch.finfo(dtype).bits // 8
        assert p.vec * item == 16 and p.box_vecs * p.vec <= 256 and p.nv % p.box_vecs == 0
        # A box row is one segment of the slice, or 256-column segments of it.
        assert p.box_vecs == p.nv or (p.box_vecs * p.vec == 256 and (n // p.halves) % 256 == 0)
    ints = plan.ints(cfg)
    assert len(ints) == 18 + 5 * len(fused_layer.CP_FRAME_PROJS)


def test_plan_at_1p7b():
    """The 1.7B plan: in bf16 128 blocks of 1 / 4 / 2 vectors (o, down, mtp /
    qkv / head) and 96 blocks of 4 + 4 for gate|up (f32: twice the vectors
    of half the columns); int8 vectors hold twice bf16's columns, so half
    the vectors, and o and down go to 64 blocks; the whole ring in one H100
    block."""
    want = {
        "bfloat16": {"mtp": (1, 128), "qkv": (4, 128), "o": (1, 128), "gate_up": (4, 96), "down": (1, 128),
                     "head": (2, 128)},
        "float32": {"mtp": (2, 128), "qkv": (8, 128), "o": (2, 128), "gate_up": (8, 96), "down": (2, 128),
                    "head": (4, 128)},
        "int8": {"mtp": (1, 128), "qkv": (2, 128), "o": (1, 64), "gate_up": (2, 96), "down": (1, 64),
                 "head": (1, 128)},
    }
    for kind, owners in want.items():
        plan = fused_layer.cp_frame_plan(CP_1P7B, kind)
        assert plan.grid == 128
        assert {name: (p.nv, p.blocks) for name, p in plan.projs.items()} == owners
        assert fused_layer.CP_FRAME_SMEM_LIMIT - 1024 < plan.smem_bytes <= fused_layer.CP_FRAME_SMEM_LIMIT


@pytest.mark.parametrize("change", [
    dict(hidden_size=1020),          # not a multiple of a bf16 vector (8 columns)
    dict(head_dim=300),              # more than a block's threads
    dict(num_code_groups=17),        # 16 acoustic codes: more than 16 cache rows
    dict(num_attention_heads=12, num_key_value_heads=5),  # heads not a multiple of kv heads
    dict(vocab_size=2047),           # odd vocab: not a multiple of a vector
])
def test_plan_refuses_shapes_the_kernel_does_not_take(change):
    with pytest.raises(ValueError, match="cp_frame_plan"):
        fused_layer.cp_frame_plan(replace(CP_1P7B, **change), "bfloat16")


def test_plan_refuses_kinds_and_cards_it_cannot_fill():
    with pytest.raises(ValueError, match="weight kind"):
        fused_layer.cp_frame_plan(CP_1P7B, "float16")
    with pytest.raises(ValueError, match="activations"):
        fused_layer.cp_frame_plan(CP_1P7B, "bfloat16", torch.float32)
    with pytest.raises(ValueError, match="cp_frame_plan"):
        fused_layer.cp_frame_plan(CP_1P7B, "bfloat16", sms=8)  # fewer SMs than q heads


def _meta_tree(cfg, kind: str) -> dict:
    """A fused code-predictor tree of ``cfg``'s shapes on the meta device
    (shapes and dtypes only), plain ("bfloat16") or int8."""
    sc = cfg.layer_stack()
    L, H, D, I = sc.num_layers, sc.hidden_size, sc.head_dim, sc.intermediate_size
    G, V, E = cfg.num_acoustic, cfg.vocab_size, cfg.embed_dim
    nqkv = (sc.num_heads + 2 * sc.num_kv_heads) * D

    def linear(*shape):
        if kind == "int8":
            return {"q8": torch.empty(shape, dtype=torch.int8, device="meta"),
                    "scale": torch.empty(shape[:-2] + shape[-1:], device="meta")}
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    layers = {"qkv_proj": linear(L, H, nqkv), "o_proj": linear(L, sc.num_heads * D, H),
              "gateup_proj": linear(L, H, 2 * I), "down_proj": linear(L, I, H),
              "input_ln": t(L, H), "post_ln": t(L, H), "q_norm": t(L, D), "k_norm": t(L, D)}
    return {"layers": layers, "lm_heads": linear(G, H, V), "codec_embeddings": t(G, V, E), "norm": t(H)}


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("change,frame", [
    (dict(vocab_size=65536), True),                             # the widest vocab the kernel takes
    (dict(intermediate_size=32768), False),                     # two staged rows of K leave no ring
    (dict(num_attention_heads=136, num_key_value_heads=8), False),  # more q heads than SMs
])
def test_route_takes_the_frame_kernel_where_the_plan_does(change, frame, kind):
    """The JAX gate sends these trees to the frame kernel; the port's gate
    also asks the plan, so a tree the kernel cannot take goes down another
    route instead of raising on the card."""
    cfg = replace(CP_TEST, **change)
    params = _meta_tree(cfg, kind)
    assert fused_layer.has_stream_pack(params["layers"], cfg.hidden_size)
    assert fused_layer.supports_cp_frame_kernel(params, cfg) is frame
    assert (code_predictor.cp_route(params, cfg) == "frame") is frame


def test_trace_phases_sums_the_stamps():
    """``cp_frame_trace_phases`` on stamps made up for a 1-layer, 2-group
    code predictor with no mtp projection (phases per pass: qkv, attention,
    o, gate_up, down, head): each phase's work runs from the previous
    phase's last leave to its own last arrival, and its barrier from there
    to its last leave."""
    cfg = replace(CP_SMALL, num_hidden_layers=1, num_code_groups=3)  # 2 passes
    phases = 2 * 6
    stamps = torch.zeros((2, phases * 4), dtype=torch.int64)
    t = 1000
    for i in range(phases):
        for b in range(2):
            owns = i % 6 != 1 and (b == 0 or i % 6 != 5)  # attention and block 1's head: no GEMV
            start, end, arrive, leave = t + 100, t + 300 + 10 * b, t + 400 + 10 * b, t + 500
            stamps[b, 4 * i:4 * i + 4] = torch.tensor([start if owns else 0, end if owns else 0, arrive, leave])
        t += 500
    got = fused_layer.cp_frame_trace_phases(stamps, cfg)
    assert got["span"] == pytest.approx((t - 1100) / 1e3)
    for kind in ("qkv", "attention", "o", "gate_up", "down", "head"):
        assert got[kind]["phases"] == 2
        assert got[kind]["barrier"] == pytest.approx(2 * 0.09)
    assert got["qkv"]["stage"] == pytest.approx(0.1) and got["qkv"]["tiles"] == pytest.approx(2 * 0.21)
    assert got["attention"]["tiles"] == 0.0
