"""The launch plan of kernels 5 and 6 (``fused_layer.fused_step_plan``) on
the CPU, and which code-predictor trees take them.

Kernels 5 and 6 take their grid, each projection's column groups, their
ring's tiles and their attention chunks from this plan; the kernels run
only on a card (``tests/test_torch_kernels.py``, ``chip_smoke.py``). Here,
at every shape the JAX gates send to the "layer_steps" route in the repo's
configs and tests (the 1.7B code predictor at intermediate 2816, the stock
3072 forced onto the route, the small configs of
``tests/test_torch_cp_step.py`` and ``chip_smoke.py``) and at the 1.7B
talker's 4-chip shard (2080 rows), in bf16 and f32: every output column of
each projection is owned by exactly one block over the whole K, the tiles
cover K exactly once, shared memory stays within an H100 block's 232,448
bytes, heads x chunks fit the grid and the chunks hold every live row;
shapes outside the kernels are refused with a reason; and no shape the
first kernels 5 and 6 took (N a multiple of 256, K of 64, head_dim a
multiple of 32 up to 256) is refused, over hidden sizes up to 8192, up to
64 q heads and caches up to the talker's 2624 rows. A ``FusedStepPack``
cannot be built on the CPU.
"""

from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.models.config import config_for_variant as j_config_for_variant
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer, nn, quant
from test_fused_layer import CFG
from test_torch_cp_step import _abstract_cp, _jax_route, _meta_tree, _port_cfg

ROWS = fused_layer.CP_MAX_SEQ
DTYPES = [torch.bfloat16, torch.float32]
CP_1P7B = config_for_variant("1.7B", "custom_voice").code_predictor
# chip_smoke.py's SMALL_INT8 "layer_steps" code predictor.
CP_SMALL = CodePredictorConfig(
    hidden_size=512, intermediate_size=768, num_hidden_layers=2, num_attention_heads=8,
    num_key_value_heads=4, head_dim=64, vocab_size=256, codec_embed_dim=256,
)
# The 1.7B talker's per-chip shard on 4 chips (chip_smoke.py's TP4).
TP4 = nn.LayerStackConfig(hidden_size=2048, intermediate_size=1536, num_layers=28, num_heads=4, num_kv_heads=2,
                          head_dim=128)
CASES = {
    "1.7B-i2816": (dc_replace(CP_1P7B, intermediate_size=2816).layer_stack(), ROWS),
    "1.7B-i3072": (CP_1P7B.layer_stack(), ROWS),
    "CFG": (_port_cfg(CFG).layer_stack(), ROWS),
    "small": (CP_SMALL.layer_stack(), ROWS),
    "tp4": (TP4, 2080),
}


def _shapes(sc) -> dict:
    H, I, qd = sc.hidden_size, sc.intermediate_size, sc.num_heads * sc.head_dim
    return {"qkv": (H, qd + 2 * sc.num_kv_heads * sc.head_dim, 1), "o": (qd, H, 1), "gate_up": (H, 2 * I, 2),
            "down": (I, H, 1)}


def check_plan(sc, plan, dtype, max_seq: int, sms: int = 132) -> None:
    """The rules of a plan of kernels 5 and 6 (the kernels check the same)."""
    assert list(plan.projs) == list(fused_layer.FUSED_STEP_PROJS)
    assert sc.num_heads <= plan.grid <= sms
    # Heads x chunks fit the grid, and the chunks hold every live row.
    assert 1 <= plan.max_chunks <= fused_layer.FUSED_STEP_MAX_CHUNKS
    assert sc.num_heads * plan.max_chunks <= plan.grid
    assert plan.chunk_rows >= fused_layer.FUSED_STEP_CHUNK_ROWS and plan.chunk_rows * plan.max_chunks >= max_seq
    # Shared memory: the ring, then the regions in order, 128-byte aligned,
    # each holding what the kernels put there, within an H100 block's bytes.
    assert plan.smem_bytes <= fused_layer.CP_FRAME_SMEM_LIMIT
    at = [fused_layer.FUSED_STEP_STAGES * plan.stage_bytes, *plan.regions.values(), plan.smem_bytes]
    assert list(plan.regions) == ["xs", "red", "cs", "misc"]
    assert at == sorted(at) and all(a % 128 == 0 for a in at[:-1])
    room = {region: (b - a) // 4 for region, a, b in zip(plan.regions, at[1:], at[2:])}
    assert room["misc"] >= fused_layer.FUSED_STEP_MISC_FIXED + plan.chunk_rows
    shapes = _shapes(sc)
    assert room["xs"] >= max(k for k, _, _ in shapes.values())
    for name, (k, n, halves) in shapes.items():
        p = plan.projs[name]
        assert (p.k, p.n, p.halves, p.chunk, p.vec) == (k, n, halves, k, 16)  # one flat sum over K
        nvt = p.nv * halves
        assert 1 <= nvt <= 256 and p.nv * 16 <= 256 and p.groups <= plan.grid
        assert room["cs"] >= nvt * 16 and room["red"] >= fused_layer._reduce_groups(nvt) * nvt * 16
        # Every output column owned by exactly one block.
        owned = [c for g in range(p.groups) for c in p.columns(g)]
        assert sorted(owned) == list(range(n)), name
        # K covered once: whole tiles of whole power-of-two row groups, each
        # tile one TMA copy a half (at most 256 groups), landing 128-byte
        # aligned in a ring slot.
        assert p.box_rows & (p.box_rows - 1) == 0 and p.box_rows <= 256 and k % p.box_rows == 0
        assert p.tile_rows % p.box_rows == 0 and p.tile_rows // p.box_rows <= 256 and k % p.tile_rows == 0
        assert p.box_rows * p.nv * 16 % 128 == 0 and p.tile_rows * nvt * 16 <= plan.stage_bytes
        tiles = [(t * p.tile_rows, (t + 1) * p.tile_rows) for t in range(k // p.tile_rows)]
        assert tiles[0][0] == 0 and tiles[-1][1] == k and all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_streams_every_weight_once(name, dtype):
    sc, rows = CASES[name]
    plan = fused_layer.fused_step_plan(sc, dtype, 132, rows)
    check_plan(sc, plan, dtype, rows)
    assert plan.ints(sc, rows)[:7] == [sc.num_layers, sc.hidden_size, sc.num_heads, sc.num_kv_heads, sc.head_dim,
                                       sc.intermediate_size, rows]
    assert len(plan.ints(sc, rows)) == 31


def test_plan_at_1p7b():
    """The 1.7B code predictor at intermediate 2816: qkv over 128 blocks (2
    vectors of 16 int8 columns), gate|up over 88 (2 of each half), o and
    down over 64 (one: their 1024 columns); the grid is 128, each slice one
    tile (gate|up two), so a call's ring holds all of a block's weights at
    once; 17 rows take one chunk a head. At the shard, 32 chunks of at
    most 65 rows a head."""
    sc, rows = CASES["1.7B-i2816"]
    plan = fused_layer.fused_step_plan(sc, torch.bfloat16, 132, rows)
    assert plan.grid == 128 and plan.max_chunks == 8 and plan.chunk_rows == 64
    assert {n: (p.nv, p.groups, p.k // p.tile_rows) for n, p in plan.projs.items()} == {
        "qkv": (2, 128, 1), "o": (1, 64, 1), "gate_up": (2, 88, 2), "down": (1, 64, 1)}
    assert sum(p.k // p.tile_rows for p in plan.projs.values()) <= 2 * (fused_layer.FUSED_STEP_STAGES - 1)
    sc, rows = CASES["tp4"]
    plan = fused_layer.fused_step_plan(sc, torch.bfloat16, 132, rows)
    assert (plan.grid, plan.max_chunks, plan.chunk_rows) == (128, 32, 65)


REFUSED = [
    ("head_dim 288", dict(head_dim=288), ROWS, "head_dim"),
    ("head_dim 20 in bf16", dict(head_dim=20), ROWS, "head_dim"),
    ("6 heads over 4", dict(num_heads=6, num_kv_heads=4), ROWS, "heads"),
    ("160 heads", dict(num_heads=160, num_kv_heads=8, head_dim=32), ROWS, "heads"),
    ("intermediate 2808", dict(intermediate_size=2808), ROWS, "gate_up"),
    ("hidden 1000", dict(hidden_size=1000), ROWS, "o has"),
    ("intermediate 65536", dict(intermediate_size=65536), ROWS, "column groups"),
    # One chunk a head of 50000 rows: its scores leave no room for the ring.
    ("50000 rows over 128 heads", dict(num_heads=128, num_kv_heads=8, head_dim=32), 50000, "TMA box"),
]


@pytest.mark.parametrize("change,rows,reason", [c[1:] for c in REFUSED], ids=[c[0] for c in REFUSED])
def test_plan_refuses_shapes_outside_the_kernels(change, rows, reason):
    sc = dc_replace(CASES["1.7B-i2816"][0], **change)
    with pytest.raises(ValueError, match=f"fused_step_plan: .*{reason}"):
        fused_layer.fused_step_plan(sc, torch.bfloat16, 132, rows)
    with pytest.raises(ValueError, match="fused_step_plan: activations"):
        fused_layer.fused_step_plan(CASES["1.7B-i2816"][0], torch.float16)


def _pr3_took(H, I, Hq, KV, D) -> bool:
    """What the first kernels 5 and 6 took (int8 GEMV tiles of 256 columns
    and 64 K rows; heads of a multiple of 32, at most 256)."""
    qd, nqkv = Hq * D, (Hq + 2 * KV) * D
    return (H % 256 == 0 and nqkv % 256 == 0 and qd % 64 == 0 and (2 * I) % 256 == 0 and I % 64 == 0
            and D % 32 == 0 and 0 < D <= 256 and Hq % KV == 0)


SWEEP = [(H, I, Hq, KV, D) for H in (256, 512, 1024, 2048, 4096, 8192) for I in (H // 2, 3 * H, 2816)
         for Hq, KV in ((1, 1), (4, 2), (16, 8), (64, 8)) for D in (32, 64, 96, 128, 160, 224, 256)
         if _pr3_took(H, I, Hq, KV, D)]


@pytest.mark.parametrize("rows", [1, ROWS, 2624])
@pytest.mark.parametrize("dtype", DTYPES)
def test_no_shape_the_first_kernels_took_is_refused(dtype, rows):
    assert len(SWEEP) > 300
    for H, I, Hq, KV, D in SWEEP:
        sc = nn.LayerStackConfig(hidden_size=H, intermediate_size=I, num_layers=5, num_heads=Hq, num_kv_heads=KV,
                                 head_dim=D)
        check_plan(sc, fused_layer.fused_step_plan(sc, dtype, 132, rows), dtype, rows)


J_1P7B = j_config_for_variant("1.7B", "custom_voice").code_predictor
ROUTE_CASES = [
    ("1.7B-intermediate-2816", dc_replace(J_1P7B, intermediate_size=2816)),
    ("1.7B-intermediate-1536", dc_replace(J_1P7B, intermediate_size=1536)),
    ("CFG", CFG),
    ("small", dc_replace(CFG, **{f: getattr(CP_SMALL, f) for f in (
        "hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads", "head_dim",
        "vocab_size")})),
]


@pytest.mark.parametrize("name,jcfg", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_every_layer_steps_tree_gets_a_plan(name, jcfg):
    """The JAX gates send these int8 trees to kernels 5 + 6 (shapes only:
    ``jax.eval_shape``; no stream pack, since a dim does not tile by the
    hidden size), and so does the port's ``cp_route``; the kernels' plan
    takes each, in bf16 and f32."""
    from qwen3_tts_tpu.ops import fused_layer as jfl

    stack = jcfg.layer_stack()
    abstract = _abstract_cp(jcfg, True, jnp.float32)
    pack = jax.eval_shape(lambda layers: jfl.make_stream_pack(layers, stack), abstract["layers"])
    jparams = dict(abstract, stream_pack=pack) if pack is not None else abstract
    assert _jax_route(jparams, jcfg) == "layer_steps"
    cfg = _port_cfg(jcfg)
    assert tcp.cp_route(_meta_tree(abstract), cfg) == "layer_steps"
    for dtype in DTYPES:
        check_plan(cfg.layer_stack(), fused_layer.fused_step_plan(cfg, dtype, 132, ROWS), dtype, ROWS)


def test_pack_is_not_built_on_the_cpu():
    """The pack holds TMA descriptors of device memory: on the CPU (or in a
    dtype the kernels do not take) it raises before touching the kernel
    library; the wrappers run the plain versions there without one."""
    sc = _port_cfg(CFG).layer_stack()
    gen = torch.Generator().manual_seed(0)
    layers = quant.quantize_layer_stack(W.fuse_layer_params(W.init_layer_stack(
        gen, sc.num_layers, sc.hidden_size, sc.intermediate_size, sc.num_heads, sc.num_kv_heads, sc.head_dim,
        torch.float32)))
    with pytest.raises(ValueError, match="FusedStepPack: the kernels run on CUDA"):
        fused_layer.FusedStepPack(layers, sc, torch.float32, "cpu")
    with pytest.raises(ValueError, match="FusedStepPack: the kernels run on CUDA"):
        fused_layer.FusedStepPack(layers, sc, torch.float16, "cuda")
    x = torch.randn((1, sc.hidden_size))
    layer = nn.layer_params_at(layers, 1)
    before = fused_layer.fused_mlp_step.launches
    got = fused_layer.fused_mlp_step(x, layer, sc.intermediate_size, sc.rms_norm_eps, layer_index=1)
    assert torch.equal(got, fused_layer.fused_mlp_step_plain(x, layer, sc.intermediate_size, sc.rms_norm_eps))
    assert fused_layer.fused_mlp_step.launches == before
