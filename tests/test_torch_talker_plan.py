"""The launch plan of kernel 3 (``fused_layer.talker_step_plan``) on the CPU.

The talker step kernel takes its grid, each projection's column groups and
its ring's tile sizes from this plan; the kernel itself runs only on a card
(``tests/test_torch_kernels.py``). Here: at the 1.7B and 0.6B talkers'
widths and at the small configs the card tests and ``chip_smoke.py`` run,
in all three weight kinds, with caches of 160, 2080 and 2624 rows, every
weight of every projection is streamed by exactly one block (the groups
cover every output column once, each over the whole K), the tiles cover K
exactly once and never cross an H-wide chunk of o or down, a block's
shared memory fits an H100's 232,448 bytes and the grid its 132 SMs, and
at 1.7B every projection is streamed by at least 120 of them; shapes the
kernel cannot take make the talker's decode steps take the layer path.
"""

from dataclasses import replace

import pytest
import torch

from qwen3_tts_tpu_torch.models import talker
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.config import TalkerConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer, nn

T_1P7B = config_for_variant("1.7B", "custom_voice").talker
T_0P6B = config_for_variant("0.6B", "custom_voice").talker
# tests/test_torch_kernels.py's TALKER_CFG (and chip_smoke.py's SMALL_TALKER
# widths), chip_smoke.py's small f32 model, tests/test_torch_talker_step.py's.
T_TEST = TalkerConfig(
    text_embed_dim=128, hidden_size=256, text_proj_intermediate=128, intermediate_size=512,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
)
T_SMALL = TalkerConfig(
    text_embed_dim=128, hidden_size=128, text_proj_intermediate=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=64,
)
T_TINY = TalkerConfig(
    text_embed_dim=32, hidden_size=64, text_proj_intermediate=32, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
)
CONFIGS = {"1.7B": T_1P7B, "0.6B": T_0P6B, "test": T_TEST, "small": T_SMALL, "tiny": T_TINY}
KINDS = [("float32", torch.float32), ("bfloat16", torch.bfloat16), ("int8", torch.bfloat16), ("int8", torch.float32)]
ROWS = [160, 2080, 2624]


def _shapes(cfg):
    sc = cfg.layer_stack()
    H, I, qd = sc.hidden_size, sc.intermediate_size, sc.num_heads * sc.head_dim
    return {"qkv": (H, qd + 2 * sc.num_kv_heads * sc.head_dim, 1), "o": (qd, H, 1), "gate_up": (H, 2 * I, 2),
            "down": (I, H, 1)}


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kind,dtype", KINDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_streams_every_weight_once(name, kind, dtype, rows):
    cfg = CONFIGS[name]
    plan = fused_layer.talker_step_plan(cfg, kind, dtype, 132, rows)
    check_plan(cfg, plan, kind, dtype, rows)
    if name == "1.7B":
        assert all(p.groups >= 120 for p in plan.projs.values()), plan.projs


def check_plan(cfg, plan, kind: str, dtype, rows: int, normalised: bool = False) -> None:
    """The rules of a step plan (kernel 3's, or kernel 7's ``normalised``
    one, whose heads attend in one chunk) that the kernel also checks."""
    sc = cfg.layer_stack()
    assert list(plan.projs) == list(fused_layer.TALKER_STEP_PROJS)
    assert sc.num_heads <= plan.grid <= 132
    assert plan.smem_bytes <= fused_layer.CP_FRAME_SMEM_LIMIT
    # The regions follow the ring in order, 128-byte aligned, and each holds
    # what the kernel puts there (the kernel checks the same).
    at = [fused_layer.TALKER_STEP_STAGES * plan.stage_bytes, *plan.regions.values(), plan.smem_bytes]
    assert list(plan.regions) == ["xs", "red", "cs", "misc"]
    assert at == sorted(at) and all(a % 128 == 0 for a in at[:-1])
    room = {region: (b - a) // 4 for region, a, b in zip(plan.regions, at[1:], at[2:])}
    room["cs"] //= 2  # two rows: a chunk's sums and the running total
    chunks = 1 if normalised else min(fused_layer.TALKER_STEP_MAX_CHUNKS, plan.grid // sc.num_heads)
    assert room["misc"] >= fused_layer.TALKER_STEP_MISC_FIXED + max(fused_layer.TALKER_STEP_CHUNK_ROWS,
                                                                     -(-rows // chunks))
    assert room["xs"] >= max(p.k for p in plan.projs.values())
    item = 1 if kind == "int8" else torch.finfo(dtype).bits // 8
    for proj, (k, n, halves) in _shapes(cfg).items():
        p = plan.projs[proj]
        assert (p.k, p.n, p.halves, p.chunk) == (k, n, halves, sc.hidden_size), proj
        assert p.vec * item == 16 and p.nv * p.halves <= 256 and p.nv * p.vec <= 256
        assert 1 <= p.groups <= plan.grid
        # Each column in exactly one group, each group a run of whole vectors
        # (gate and up: the same columns of both halves).
        owned = [c for g in range(p.groups) for c in p.columns(g)]
        assert sorted(owned) == list(range(n)), proj
        assert all(p.columns(g) for g in range(p.groups)) and not p.columns(p.groups)
        if proj == "gate_up":
            for g in range(p.groups):
                cols = p.columns(g)
                assert [c + n // 2 for c in cols[: len(cols) // 2]] == cols[len(cols) // 2:]
        # The tiles cover K exactly once and never cross a chunk, each fits a
        # ring stage and is whole TMA boxes, and a box's rows land 128-byte
        # aligned.
        tiles = [range(k0, min(k0 + p.tile_rows, k)) for k0 in range(0, k, p.tile_rows)]
        assert [r for tile in tiles for r in tile] == list(range(k))
        assert all(tile[0] // p.chunk == tile[-1] // p.chunk for tile in tiles)
        assert p.tile_rows * p.nv * p.halves * 16 <= plan.stage_bytes
        assert p.box_rows & (p.box_rows - 1) == 0 and p.box_rows <= 256
        assert p.chunk % p.box_rows == 0 and p.tile_rows % p.box_rows == 0 and p.box_rows * p.nv * 16 % 128 == 0
        nvt = p.nv * p.halves
        groups = 8 if nvt < 32 and nvt & (nvt - 1) == 0 else 256 // nvt
        assert room["red"] >= groups * nvt * p.vec and room["cs"] >= nvt * p.vec, proj
    assert len(plan.ints(cfg, rows)) == 14 + 4 * len(fused_layer.TALKER_STEP_PROJS)


def test_plan_at_1p7b():
    """The 1.7B plans: every projection streamed by 128 blocks (every block
    over the same K rows at once), and the ring's four tiles in one H100
    block."""
    for kind, dtype in KINDS:
        plan = fused_layer.talker_step_plan(T_1P7B, kind, dtype)
        assert plan.grid == 128
        assert [p.groups for p in plan.projs.values()] == [128] * 4, kind
        assert fused_layer.CP_FRAME_SMEM_LIMIT - 1024 < plan.smem_bytes <= fused_layer.CP_FRAME_SMEM_LIMIT


@pytest.mark.parametrize("change", [
    dict(head_dim=192, num_attention_heads=4, num_key_value_heads=2),  # wider than 128: more than a block's threads
    dict(head_dim=4),                                                 # not a whole 16-byte vector of bf16
    dict(num_attention_heads=136, num_key_value_heads=8, head_dim=16, hidden_size=2176),  # more q heads than 128
])
def test_plan_refuses_shapes_the_kernel_does_not_take(change):
    with pytest.raises(ValueError, match="talker_step_plan"):
        fused_layer.talker_step_plan(replace(T_TEST, **change), "bfloat16")


def test_plan_refuses_kinds_and_cards_it_cannot_fill():
    with pytest.raises(ValueError, match="weight kind"):
        fused_layer.talker_step_plan(T_1P7B, "float16")
    with pytest.raises(ValueError, match="activations"):
        fused_layer.talker_step_plan(T_1P7B, "bfloat16", torch.float32)
    with pytest.raises(ValueError, match="talker_step_plan"):
        fused_layer.talker_step_plan(T_1P7B, "bfloat16", sms=8)  # fewer SMs than q heads


def _tree(cfg, seed=0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    small_vocab = replace(cfg, text_vocab_size=256, codec_vocab_size=256)
    return W.fuse_model_params(W.init_talker_params(gen, small_vocab, torch.float32))


@pytest.mark.parametrize("weights,tol", [("plain", 1e-5), ("int8", 1e-4)])
@pytest.mark.parametrize("change,kernel", [
    ({}, True),
    (dict(head_dim=192), False),  # the plan refuses a head wider than 128 (more than a block's threads)
    (dict(head_dim=256), False),
])
def test_decode_steps_take_the_kernel_where_the_plan_does(change, kernel, weights, tol, monkeypatch):
    """The JAX gate (a fused tree whose dims tile by H) admits these trees;
    the port's gate also asks the plan, so a tree the kernel cannot take
    runs the layer path instead of raising on the card. Its steps there
    equal the plain whole step on the same f32 tree (plain weights 1e-5;
    int8: the bf16-rounded matmul inputs may move by an ulp under another
    f32 summation order, 1e-4)."""
    from qwen3_tts_tpu_torch.ops import quant

    cfg = replace(T_TEST, **change)
    params = _tree(cfg)
    if weights == "int8":
        params = quant.quantize_talker_params(params)
    stack = cfg.layer_stack()
    assert fused_layer.has_stream_pack(params["layers"], cfg.hidden_size)
    cache = nn.init_kv_cache(stack, 1, 32, torch.float32)
    assert talker.stream_plane_mode(params, cfg, cache) is kernel
    assert fused_layer.supports_talker_step_kernel(params["layers"], stack, 32) is kernel
    if kernel:
        return

    def refuse(*args, **kwargs):
        raise AssertionError("the layer path must not call talker_step")

    monkeypatch.setattr(fused_layer, "talker_step", refuse)
    gen = torch.Generator().manual_seed(3)
    kvd = stack.num_kv_heads * stack.head_dim
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen))
    ck, cv = cache.k.clone().view(stack.num_layers, 32, kvd), cache.v.clone().view(stack.num_layers, 32, kvd)
    x = torch.randn((1, 1, cfg.hidden_size), generator=gen)
    h, _ = talker.decode_step(params, cfg, x, 20, cache)
    want = nn.rms_norm(fused_layer.talker_step_plain(params["layers"], x, stack, ck, cv, 20), params["norm"],
                       cfg.rms_norm_eps)
    torch.testing.assert_close(h, want, rtol=tol, atol=tol)


def test_trace_phases_sums_the_stamps():
    """``talker_step_trace_phases`` on stamps made up for a 1-layer talker
    (phases: qkv, attention, o, gate_up, down): each phase's work runs from
    the previous phase's last leave to its own last arrival, its barrier
    from there to its last leave, and its epilogue is what is left of the
    work after staging and the longest work."""
    cfg = replace(T_SMALL, num_hidden_layers=1)
    stamps = torch.zeros((2, 5 * 4), dtype=torch.int64)
    t = 1000
    for i in range(5):
        for b in range(2):
            owns = b == 0 or i != 1  # block 1 has no attention item
            start, end, arrive, leave = t + 100, t + 300 + 10 * b, t + 400 + 10 * b, t + 500
            stamps[b, 4 * i:4 * i + 4] = torch.tensor([start if owns else 0, end if owns else 0, arrive, leave])
        t += 500
    got = fused_layer.talker_step_trace_phases(stamps, cfg)
    assert got["span"] == pytest.approx((t - 1100) / 1e3)
    for kind in ("qkv", "attention", "o", "gate_up", "down"):
        k = got[kind]
        assert k["phases"] == 1 and k["barrier"] == pytest.approx(0.09)
        assert k["work"] == pytest.approx(k["stage"] + k["tiles"] + k["epilogue"])
    assert got["attention"]["tiles"] == pytest.approx(0.2)
    assert got["qkv"]["tiles"] == pytest.approx(0.21) and got["qkv"]["epilogue"] == pytest.approx(0.1)
