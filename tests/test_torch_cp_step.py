"""The port's per-step int8 code predictor against the JAX package's.

The plain versions of kernels 5, 6 and 7 (what ``fused_attention_step``,
``fused_mlp_step`` and ``streamed_decode_step`` run on CPU tensors) are held
against the JAX Pallas kernels ``fused_attention_step``, ``fused_mlp_step``
and ``streamed_decode_step`` in interpret mode, as
``tests/test_fused_layer.py`` runs them, on the same numpy-seeded inputs:

* f32: within 1e-5 of max|JAX| (the same rounding points; the f32 sums run
  in another order);
* bf16: within one bf16 ulp (2^-7) of max|JAX| (a sum in another order may
  round one ulp the other way);
* every cache row other than ``pos`` bit-unchanged.

``predict_acoustic_codes`` must give the JAX codes token-exactly on both
per-step routes, the slice runs end to end token-exactly against the JAX
int8 model, and the route the port picks must be the JAX gates' for each
configuration. The CUDA kernels are held against these plain versions on
the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

from dataclasses import asdict
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.config import config_for_variant as j_config_for_variant
from qwen3_tts_tpu.ops import fused_layer as jfl
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, ModelConfig, ModelType, TalkerConfig
from qwen3_tts_tpu_torch.ops import fused_layer as tfl
from qwen3_tts_tpu_torch.ops import quant as TQ
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_fused_layer import CFG, STREAM_CFG
from test_pipeline import TINY_CP, TINY_TALKER, TINY_VOC, FakeTokenizer

torch.set_num_threads(1)

S = jcp.CP_MAX_SEQ  # 17 cache rows
ODD_VOCAB_CFG = dc_replace(STREAM_CFG, vocab_size=127)  # dims tile; the frame kernel refuses the vocab
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(jcfg) -> CodePredictorConfig:
    return CodePredictorConfig(**{f: getattr(jcfg, f) for f in CodePredictorConfig.__dataclass_fields__})


def _int8_cp(cfg, seed):
    """A fused int8 code predictor as a JAX tree: f32 weights drawn with the
    port's init (the JAX init compiles a program per leaf) and quantized by
    the port's quantizer, bit for bit the JAX package's
    (``tests/test_torch_quant.py``)."""
    gen = torch.Generator().manual_seed(seed)
    tree = TW.fuse_model_params(TW.init_code_predictor_params(gen, _port_cfg(cfg), torch.float32))
    return jax.tree.map(jnp.asarray, _torch_to_numpy(TQ.quantize_code_predictor_params(tree)))


def _layer(params, jdt, seed):
    """Layer 0 of an int8 tree, its norms moved off 1 and rounded to the
    working type (the same values in both packages)."""
    rs = np.random.RandomState(seed)
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    for name in ("input_ln", "post_ln", "q_norm", "k_norm"):
        layer[name] = jnp.asarray(1.0 + 0.1 * rs.randn(*layer[name].shape).astype(np.float32), jdt)
    return layer


def _torch_to_numpy(tree):
    """A port tree of CPU tensors -> the same tree of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _torch_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_to_numpy(v) for v in tree)
    return tree


def _port_tree(jtree, tdt):
    """A JAX tree as the port's, plain leaves in ``tdt`` (int8 and scales kept)."""
    return TW.from_numpy_tree(_numpy(jtree), "cpu", tdt)


def _close(got: torch.Tensor, want, bf16: bool) -> None:
    want = np.asarray(want, np.float32)
    tol = (2.0**-7 if bf16 else 1e-5) * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def _rope(stack):
    inv = jnn.rope_inv_freq(stack.head_dim, stack.rope_theta)
    cos_t, sin_t = jnn.rope_cos_sin(jnp.arange(S, dtype=jnp.float32), inv)
    return cos_t, sin_t, torch.from_numpy(np.array(cos_t)), torch.from_numpy(np.array(sin_t))


@pytest.mark.parametrize("pos", [2, 9, 16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_attention_step_plain_matches_jax_kernel(jdt, tdt, residual, pos):
    """Kernel 5 at H = 64, 4 q / 2 kv heads, D = 16, S = 17: the output, the
    written row, and every other row bit-unchanged."""
    stack = STREAM_CFG.layer_stack()
    layer = _layer(_int8_cp(STREAM_CFG, 20), jdt, 21)
    rs = np.random.RandomState(pos)
    x = rs.randn(1, stack.hidden_size).astype(np.float32)
    ck0, cv0 = (rs.randn(S, 32).astype(np.float32) for _ in range(2))
    cos_t, sin_t, tcos, tsin = _rope(stack)
    jy, jck, jcv = jfl.fused_attention_step(
        jnp.asarray(x, jdt), layer, cos_t[pos : pos + 1], sin_t[pos : pos + 1], jnp.asarray(ck0, jdt),
        jnp.asarray(cv0, jdt), jnp.int32(pos), 4, 2, 16, stack.rms_norm_eps, residual=residual,
    )

    tlayer = _port_tree(layer, tdt)
    ck, cv = torch.from_numpy(ck0).to(tdt), torch.from_numpy(cv0).to(tdt)
    ck_before, cv_before = ck.clone(), cv.clone()
    before = tfl.fused_attention_step.launches
    ty = tfl.fused_attention_step(
        torch.from_numpy(x).to(tdt), tlayer, tcos, tsin, ck, cv, pos, 4, 2, 16, stack.rms_norm_eps, residual
    )
    assert tfl.fused_attention_step.launches == before  # CPU tensors take the plain version
    assert ty.dtype == tdt and ty.shape == (1, stack.hidden_size)
    bf16 = tdt == torch.bfloat16
    _close(ty, jy.astype(jnp.float32), bf16)
    _close(ck[pos], jck[pos].astype(jnp.float32), bf16)
    _close(cv[pos], jcv[pos].astype(jnp.float32), bf16)
    others = torch.arange(S) != pos
    assert torch.equal(ck[others], ck_before[others]) and torch.equal(cv[others], cv_before[others])


def test_attention_step_plain_reads_only_live_rows():
    """Rows above ``pos`` may hold anything (a reused or tensor-parallel
    cache): NaN there changes nothing, where a masked product would give NaN."""
    stack = STREAM_CFG.layer_stack()
    tlayer = _port_tree(_layer(_int8_cp(STREAM_CFG, 22), jnp.float32, 23), torch.float32)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1, 64).astype(np.float32))
    ck, cv = (torch.from_numpy(rs.randn(S, 32).astype(np.float32)) for _ in range(2))
    ck_nan, cv_nan = ck.clone(), cv.clone()
    ck_nan[8:], cv_nan[8:] = float("nan"), float("nan")
    _, _, tcos, tsin = _rope(stack)
    want = tfl.fused_attention_step(x, tlayer, tcos, tsin, ck, cv, 7, 4, 2, 16, stack.rms_norm_eps)
    got = tfl.fused_attention_step(x, tlayer, tcos, tsin, ck_nan, cv_nan, 7, 4, 2, 16, stack.rms_norm_eps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_mlp_step_plain_matches_jax_kernel(jdt, tdt, residual):
    """Kernel 6 at H = 64, I = 128."""
    layer = _layer(_int8_cp(STREAM_CFG, 24), jdt, 25)
    x = np.random.RandomState(5).randn(1, 64).astype(np.float32)
    jy = jfl.fused_mlp_step(jnp.asarray(x, jdt), layer, STREAM_CFG.intermediate_size, 1e-6, residual=residual)
    before = tfl.fused_mlp_step.launches
    ty = tfl.fused_mlp_step(
        torch.from_numpy(x).to(tdt), _port_tree(layer, tdt), STREAM_CFG.intermediate_size, 1e-6, residual
    )
    assert tfl.fused_mlp_step.launches == before
    assert ty.dtype == tdt and ty.shape == (1, 64)
    _close(ty, jy.astype(jnp.float32), tdt == torch.bfloat16)


@pytest.mark.parametrize("jdt,tdt,pos", [(*DTYPES[0], 3), (*DTYPES[1], 16)], ids=["float32-pos3", "bfloat16-pos16"])
def test_streamed_step_plain_matches_jax_kernel(jdt, tdt, pos):
    """Kernel 7 at STREAM_CFG (H = 64, I = 128, 2 layers): the port's plain
    step on the canonical tree against JAX ``streamed_decode_step`` on
    ``make_stream_pack`` of the same tree."""
    stack = STREAM_CFG.layer_stack()
    params = _int8_cp(STREAM_CFG, 26)
    layers = dict(params["layers"])
    rs = np.random.RandomState(27)
    for name in ("input_ln", "post_ln", "q_norm", "k_norm"):
        layers[name] = jnp.asarray(1.0 + 0.1 * rs.randn(*layers[name].shape).astype(np.float32), jdt)
    pack = jfl.make_stream_pack(layers, stack)
    assert pack is not None and pack["plan"] == (2, 1, 4, 2)  # K-split o (1 chunk) and down (2 chunks)
    x = rs.randn(1, 1, 64).astype(np.float32)
    ck0, cv0 = (rs.randn(2, S, 32).astype(np.float32) for _ in range(2))
    cos_t, sin_t, tcos, tsin = _rope(stack)
    jy, jck, jcv = jfl.streamed_decode_step(
        layers, pack, jnp.asarray(x, jdt), stack, jnp.asarray(ck0, jdt), jnp.asarray(cv0, jdt), jnp.int32(pos),
        cos_t, sin_t,
    )

    tlayers = _port_tree(layers, tdt)
    ck, cv = torch.from_numpy(ck0).to(tdt), torch.from_numpy(cv0).to(tdt)
    ck_before, cv_before = ck.clone(), cv.clone()
    before = tfl.streamed_decode_step.launches
    ty = tfl.streamed_decode_step(tlayers, torch.from_numpy(x).to(tdt), stack, ck, cv, pos, tcos, tsin)
    assert tfl.streamed_decode_step.launches == before
    assert ty.dtype == tdt and ty.shape == (1, 1, 64)
    bf16 = tdt == torch.bfloat16
    _close(ty, jy.astype(jnp.float32), bf16)
    _close(ck[:, pos], jck[:, pos].astype(jnp.float32), bf16)
    _close(cv[:, pos], jcv[:, pos].astype(jnp.float32), bf16)
    others = torch.arange(S) != pos
    assert torch.equal(ck[:, others], ck_before[:, others]) and torch.equal(cv[:, others], cv_before[:, others])
    # The same step through run_fused_decode_step's kernel-7 route.
    ck2, cv2 = ck_before.clone(), cv_before.clone()
    y2 = tfl.run_fused_decode_step(tlayers, torch.from_numpy(x).to(tdt), stack, ck2, cv2, pos, tcos, tsin, True)
    assert torch.equal(y2, ty) and torch.equal(ck2, ck)


@pytest.mark.parametrize(
    "jcfg,route",
    [(CFG, "layer_steps"), (ODD_VOCAB_CFG, "streamed_step")],
    ids=["intermediate-not-multiple-of-H", "odd-vocab"],
)
def test_predict_acoustic_codes_per_step_routes_match_jax(jcfg, route):
    """Int8, f32 activations: the JAX package runs kernels 5 + 6 (no pack:
    I = 96 is not a multiple of H = 64) or kernel 7 (a pack, but an odd
    vocab the frame kernel refuses); the port takes the same route and its
    codes are token-exact."""
    params = _int8_cp(jcfg, 28)
    pack = jfl.make_stream_pack(params["layers"], jcfg.layer_stack())
    assert (pack is not None) == (route == "streamed_step")
    jparams = dict(params, stream_pack=pack) if pack is not None else params
    assert not jfl.supports_cp_frame_kernel(jparams, jcfg) and jfl.supports_fused_step(params["layers"])

    cfg = _port_cfg(jcfg)
    tparams = TW.from_numpy_tree(_numpy(params), "cpu")
    assert tcp.cp_route(tparams, cfg) == route
    rs = np.random.RandomState(29)
    counters = (tfl.cp_frame, tfl.fused_attention_step, tfl.fused_mlp_step, tfl.streamed_decode_step)
    before = [k.launches for k in counters]
    hidden, semantic = (rs.randn(1, 1, jcfg.embed_dim).astype(np.float32) for _ in range(2))
    want = np.asarray(jcp.predict_acoustic_codes(jparams, jcfg, jnp.asarray(hidden), jnp.asarray(semantic)))
    got = tcp.predict_acoustic_codes(tparams, cfg, torch.from_numpy(hidden), torch.from_numpy(semantic))
    assert got.dtype == torch.int32 and got.shape == (jcfg.num_acoustic,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [k.launches for k in counters] == before
    # Both per-step routes compute the same frame here (f32).
    other = tcp._predict_acoustic_codes_fused(
        tparams, cfg, torch.from_numpy(hidden), torch.from_numpy(semantic), streamed=route != "streamed_step"
    )
    np.testing.assert_array_equal(other.numpy(), want)


def _jax_route(jparams, jcfg) -> str:
    """The route of JAX ``predict_acoustic_codes`` for these parameters."""
    if jfl.supports_cp_frame_kernel(jparams, jcfg):
        return "frame"
    if jfl.supports_fused_step(jparams["layers"]):
        return "streamed_step" if jparams.get("stream_pack") is not None else "layer_steps"
    return "layers"


def _abstract_cp(jcfg, int8: bool, dtype):
    def build(key):
        params = JW.fuse_model_params(JW.init_code_predictor_params(key, jcfg, dtype))
        return jq.quantize_code_predictor_params(params) if int8 else params

    return jax.eval_shape(build, jax.random.PRNGKey(0))


def _meta_tree(tree):
    dtypes = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.int8): torch.int8}
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.empty(tree.shape, dtype=dtypes[jnp.dtype(tree.dtype)], device="meta")


ROUTE_CASES = [
    ("0.6B", j_config_for_variant("0.6B", "custom_voice").code_predictor),
    ("1.7B", j_config_for_variant("1.7B", "custom_voice").code_predictor),
    ("1.7B-17-groups", dc_replace(j_config_for_variant("1.7B", "custom_voice").code_predictor, num_code_groups=17)),
    ("1.7B-odd-vocab", dc_replace(j_config_for_variant("1.7B", "custom_voice").code_predictor, vocab_size=2047)),
    ("1.7B-intermediate-2816", dc_replace(j_config_for_variant("1.7B", "custom_voice").code_predictor,
                                          intermediate_size=2816)),
    ("CFG", CFG),
    ("STREAM_CFG", STREAM_CFG),
    ("STREAM_CFG-odd-vocab", ODD_VOCAB_CFG),
]


@pytest.mark.parametrize("name,jcfg", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_table_matches_jax_gates(name, jcfg):
    """For int8 and bf16 trees: the port's gate picks the route the JAX gates
    pick given the stream pack the JAX ``Qwen3TTS`` builds on the TPU, the
    card's counterpart (int8 and bf16 alike). Shapes only
    (``jax.eval_shape``, meta tensors)."""
    stack = jcfg.layer_stack()
    cfg = _port_cfg(jcfg)
    for int8, jdt in ((True, jnp.float32), (False, jnp.bfloat16)):
        abstract = _abstract_cp(jcfg, int8, jdt)
        pack = jax.eval_shape(lambda layers: jfl.make_stream_pack(layers, stack), abstract["layers"])
        jparams = dict(abstract, stream_pack=pack) if pack is not None else abstract
        want = _jax_route(jparams, jcfg)
        got = tcp.cp_route(_meta_tree(abstract), cfg)
        assert got == want, (name, "int8" if int8 else "bf16", got, want)


def test_route_table_of_the_published_widths():
    """What the gates give at the published widths: the frame kernel for
    both checkpoints, int8 and bf16 on the card; the per-step routes only
    for other code predictors."""
    routes = {}
    for name, jcfg in ROUTE_CASES[:5]:
        tparams = _meta_tree(_abstract_cp(jcfg, True, jnp.float32))
        routes[name] = tcp.cp_route(tparams, _port_cfg(jcfg))
    assert routes == {
        "0.6B": "frame", "1.7B": "frame", "1.7B-17-groups": "streamed_step", "1.7B-odd-vocab": "streamed_step",
        "1.7B-intermediate-2816": "layer_steps",
    }


def test_tiny_int8_model_per_step_path_matches_jax():
    """The slice end to end: a tiny int8 model whose code predictor has an
    odd vocab (127), so both packages take kernel 7 per step, through
    ``Qwen3TTS.from_numpy(..., quantize_int8=True, device="cpu")`` against
    the JAX ``Qwen3TTS(..., quantize_int8=True)``. The JAX model keeps the
    code predictor's stream pack (its interpret-mode ``streamed_decode_step``)
    and drops the talker's, as ``tests/test_torch_pipeline.py`` does, so that
    its talker rounds where the port's plain talker step does. Frames
    token-exact; audio within atol 1e-5 (f32 vocoder, sums in another order)."""
    from qwen3_tts_tpu.models.config import ModelConfig as JModelConfig
    from qwen3_tts_tpu.models.config import ModelType as JModelType
    from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS
    from qwen3_tts_tpu.pipeline import SynthesisOptions as JOptions

    jtalker = dc_replace(TINY_TALKER, intermediate_size=64)
    jcp_cfg = dc_replace(TINY_CP, vocab_size=127)
    jcfg = JModelConfig(model_type=JModelType.CUSTOM_VOICE, model_size="0b6", talker=jtalker, code_predictor=jcp_cfg)
    cfg = ModelConfig(
        model_type=ModelType.CUSTOM_VOICE, model_size="0b6",
        talker=TalkerConfig(**asdict(jtalker)), code_predictor=CodePredictorConfig(**asdict(jcp_cfg)),
    )
    voc = tvoc.VocoderConfig(**asdict(TINY_VOC))
    # One set of f32 weights for both packages, drawn with the port's init
    # (the JAX init compiles a program per leaf, ~20 s here).
    gen = torch.Generator().manual_seed(3)
    trees = [
        _torch_to_numpy(t)
        for t in (
            TW.init_talker_params(gen, cfg.talker, torch.float32),
            TW.init_code_predictor_params(gen, cfg.code_predictor, torch.float32),
            tvoc.init_vocoder_params(gen, voc),
        )
    ]
    jm = JQwen3TTS(jcfg, *jax.tree.map(jnp.asarray, trees), FakeTokenizer(), vocoder_config=TINY_VOC, quantize_int8=True)
    jm.talker_params.pop("stream_pack")
    assert "stream_pack" in jm.cp_params and not jfl.supports_cp_frame_kernel(jm.cp_params, jcp_cfg)

    tm = Qwen3TTS.from_numpy(cfg, *trees, FakeTokenizer(), vocoder_config=voc, quantize_int8=True, device="cpu")
    assert tcp.cp_route(tm.cp_params, cfg.code_predictor) == "streamed_step"
    text = "per step"
    jopts, topts = JOptions(max_length=6, seed=42), SynthesisOptions(max_length=6, seed=42)
    want = jm._custom_voice_session(text, "ryan", "english", jopts).run_to_completion()
    jaudio = jm.decode_codes(want)
    got = tm._custom_voice_session(text, "ryan", "english", topts).run_to_completion()
    np.testing.assert_array_equal(got, want)
    taudio, timing = tm.synthesize_with_timing(text, "ryan", "english", topts)
    assert timing.generation_frames == len(want)
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0, atol=1e-5)


def test_default_device_is_the_card(monkeypatch):
    """``from_random`` / ``from_numpy`` build on the card unless asked for the
    CPU (every CPU test passes ``device="cpu"``); with no card they raise
    instead of building on the CPU."""
    cfg = ModelConfig(
        model_type=ModelType.CUSTOM_VOICE, model_size="0b6",
        talker=TalkerConfig(**asdict(TINY_TALKER)), code_predictor=CodePredictorConfig(**asdict(TINY_CP)),
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Qwen3TTS.from_random(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Qwen3TTS.from_numpy(cfg, {}, {}, {})
