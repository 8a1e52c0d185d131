"""The launch plan of kernel 7 (``fused_layer.talker_step_plan(...,
normalised=True)``) on the CPU, and which code-predictor trees get one.

Kernel 7 is kernel 3's body in its normalised form, so its plan keeps
kernel 3's rules (``test_torch_talker_plan.check_plan``): at the 1.7B and
0.6B code predictors' widths and at the small stacks the tests and
``chip_smoke.py`` run, int8 weights with bf16 and f32 activations, 17
cache rows: every column owned by one block over the whole K, the TMA
boxes dividing the H-wide chunks of o and down, shared memory within an
H100 block's 232,448 bytes, the grid within 132 SMs; one attention chunk a
head (at most 256 rows). Every code-predictor tree the JAX gates send to
kernel 7 (the "streamed_step" route) at the published and the test widths
gets a plan, a head of 256 too (the normalised form holds an element of
q and one of k a thread; kernel 3 keeps its heads of at most 128).
"""

from dataclasses import replace as dc_replace

import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.models.config import config_for_variant as j_config_for_variant
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer
from test_fused_layer import STREAM_CFG
from test_pipeline import TINY_CP
from test_torch_cp_step import _abstract_cp, _jax_route, _meta_tree, _port_cfg
from test_torch_talker_plan import check_plan

ROWS = fused_layer.CP_MAX_SEQ
# tests/test_torch_kernels.py's CP_CFG and chip_smoke.py's SMALL_INT8
# "streamed_step" code predictor (vocab 255: the frame kernel refuses it).
CP_SMALL = CodePredictorConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=255,
)
CONFIGS = {
    "1.7B": config_for_variant("1.7B", "custom_voice").code_predictor,
    "0.6B": config_for_variant("0.6B", "custom_voice").code_predictor,
    "small": CP_SMALL,
    "stream": _port_cfg(STREAM_CFG),
    "tiny": _port_cfg(TINY_CP),
}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_streams_every_weight_once(name, dtype):
    cfg = CONFIGS[name]
    plan = fused_layer.talker_step_plan(cfg.layer_stack(), "int8", dtype, 132, ROWS, normalised=True)
    check_plan(cfg, plan, "int8", dtype, ROWS, normalised=True)
    # The same plan as kernel 3's at these rows: one chunk of at most 256
    # rows needs no more attention scratch.
    assert plan == fused_layer.talker_step_plan(cfg.layer_stack(), "int8", dtype, 132, ROWS)


def test_plan_at_1p7b():
    """The 1.7B code predictor: qkv over 128 blocks (2 vectors of 16 int8
    columns each), gate|up over 96, o and down over 64 (one vector: their
    1024 columns); the grid is 128."""
    for dtype in DTYPES:
        plan = fused_layer.talker_step_plan(CONFIGS["1.7B"].layer_stack(), "int8", dtype, 132, ROWS, True)
        assert plan.grid == 128
        assert {n: (p.nv, p.groups) for n, p in plan.projs.items()} == {
            "qkv": (2, 128), "o": (1, 64), "gate_up": (2, 96), "down": (1, 64)}


def test_normalised_plan_holds_one_chunk():
    stack = CONFIGS["1.7B"].layer_stack()
    fused_layer.talker_step_plan(stack, "int8", torch.bfloat16, 132, fused_layer.TALKER_STEP_CHUNK_ROWS, True)
    with pytest.raises(ValueError, match="talker_step_plan"):
        fused_layer.talker_step_plan(stack, "int8", torch.bfloat16, 132, fused_layer.TALKER_STEP_CHUNK_ROWS + 1,
                                     True)


J_1P7B = j_config_for_variant("1.7B", "custom_voice").code_predictor
J_0P6B = j_config_for_variant("0.6B", "custom_voice").code_predictor
ROUTE_CASES = [
    ("1.7B-odd-vocab", dc_replace(J_1P7B, vocab_size=2047)),
    ("1.7B-17-groups", dc_replace(J_1P7B, num_code_groups=17)),
    ("0.6B-odd-vocab", dc_replace(J_0P6B, vocab_size=2047)),
    ("0.6B-17-groups", dc_replace(J_0P6B, num_code_groups=17)),
    ("STREAM_CFG-odd-vocab", dc_replace(STREAM_CFG, vocab_size=127)),
    ("TINY_CP-odd-vocab", dc_replace(TINY_CP, vocab_size=127)),
    ("small", dc_replace(STREAM_CFG, **{f: getattr(CP_SMALL, f) for f in (
        "hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads", "head_dim",
        "vocab_size")})),
    # The widest head the normalised form takes (kernel 3's plan refuses it).
    ("head-dim-256", dc_replace(J_1P7B, vocab_size=2047, head_dim=256, num_attention_heads=8,
                                num_key_value_heads=4)),
]


@pytest.mark.parametrize("name,jcfg", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_every_streamed_step_tree_gets_a_plan(name, jcfg):
    """The JAX gates send these int8 trees to kernel 7 (shapes only:
    ``jax.eval_shape``), and so does the port's ``cp_route``; the kernel's
    plan takes each, in bf16 and f32, the head of 256 too, which kernel 3's
    plan refuses."""
    import jax

    from qwen3_tts_tpu.ops import fused_layer as jfl

    stack = jcfg.layer_stack()
    abstract = _abstract_cp(jcfg, True, jnp.float32)
    pack = jax.eval_shape(lambda layers: jfl.make_stream_pack(layers, stack), abstract["layers"])
    jparams = dict(abstract, stream_pack=pack) if pack is not None else abstract
    assert _jax_route(jparams, jcfg) == "streamed_step"
    cfg = _port_cfg(jcfg)
    assert tcp.cp_route(_meta_tree(abstract), cfg) == "streamed_step"
    for dtype in DTYPES:
        plan = fused_layer.talker_step_plan(cfg.layer_stack(), "int8", dtype, 132, ROWS, normalised=True)
        check_plan(cfg, plan, "int8", dtype, ROWS, normalised=True)
        if stack.head_dim > fused_layer.TALKER_STEP_MAX_HEAD_DIM:
            with pytest.raises(ValueError, match="talker_step_plan: the kernel does not take"):
                fused_layer.talker_step_plan(cfg.layer_stack(), "int8", dtype, 132, ROWS)
