"""The talker's batch-1 prefill as one CUDA graph (``talker.PrefillGraph``).

On any machine: the rule that picks the graph (``talker.prefill_graph_key``:
a plain tree, a ``KVCache`` of one stream, a prompt whose rows are all live,
no w8a8) and ``talker.prefill``'s dispatch on it, with stand-in graphs; the
eager prefill as it was; the ``graph`` counter of ``q3.prefill`` on the CPU.

On the card (``gpu``), at the 1.7B and 0.6B CustomVoice widths in bf16 and
int8 (``Qwen3TTS.from_random``, full depth): the replay bit-equal to the
eager prefill (last hidden, logits, first token, cache rows), kernel 4's
``launches`` per replay, sessions open side by side, eager prefills of other
shapes between replays, one replay a session and the span's counter. This
file imports no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_prefill_graph.py`` runs it on a machine with a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import profiling
from qwen3_tts_tpu_torch.generation import core, prefill
from qwen3_tts_tpu_torch.models import talker
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.codec import vocoder
from qwen3_tts_tpu_torch.models.config import (CodePredictorConfig, ModelConfig, ModelType, TalkerConfig,
                                               config_for_variant)
from qwen3_tts_tpu_torch.ops import nn, quant
from qwen3_tts_tpu_torch.parallel.sharding import ShardedTree
from qwen3_tts_tpu_torch.pipeline import CUSTOM_VOICE_PROMPT_LEN, Qwen3TTS, SynthesisOptions, VoiceClonePrompt

torch.set_num_threads(1)

ROWS = CUSTOM_VOICE_PROMPT_LEN
TALKER = TalkerConfig(text_embed_dim=32, hidden_size=64, text_proj_intermediate=32, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                      codec_vocab_size=3072)
CP = CodePredictorConfig(hidden_size=64, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, vocab_size=128)
VOC = vocoder.VocoderConfig(codebook_dim=16, latent_dim=24, hidden_size=16, num_layers=2, num_heads=2, head_dim=8,
                            intermediate_size=32, codebook_size=2048, codebook_embed_dim=8, decoder_dim=32)


class Tokens:
    """One token a word."""

    def encode(self, text):
        return [200 + (sum(map(ord, w)) * 37) % 300 for w in text.split()]


def _talker(seed: int = 3, dtype=torch.float32) -> dict:
    return W.init_talker_params(torch.Generator().manual_seed(seed), TALKER, dtype)


def _inputs(params: dict, rows: int = ROWS, streams: int = 1, seed: int = 4):
    """(prompt [streams, rows, hidden], a fresh cache of 32 rows)."""
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randn((streams, rows, TALKER.hidden_size), generator=gen).to(params["norm"].dtype)
    return prompt, nn.init_kv_cache(TALKER.layer_stack(), streams, 32, params["norm"].dtype)


def _card_key(params: dict, rows: int = ROWS) -> tuple:
    """The key a graph of ``params`` on the card would have."""
    dtype = params["norm"].dtype
    return torch.device("cuda", 0), dtype, (1, rows, TALKER.hidden_size), dtype, id(params)


def _refusing(key):
    """A stand-in graph of ``key`` that must not be replayed."""

    def replay(*_):
        raise AssertionError("replayed a graph that does not fit the call")

    return SimpleNamespace(key=key, replay=replay)


def test_key_of_a_batch1_prompt():
    params = _talker()
    prompt, cache = _inputs(params)
    assert talker.prefill_graph_key(params, prompt, ROWS, cache) == (
        torch.device("cpu"), torch.float32, (1, ROWS, TALKER.hidden_size), torch.float32, id(params))
    other, cache12 = _inputs(params, rows=12)
    assert talker.prefill_graph_key(params, other, 12, cache12)[2] == (1, 12, TALKER.hidden_size)


@pytest.mark.parametrize("case", ["sharded", "tp_cache", "two_streams", "padded", "w8a8"])
def test_key_is_none_off_the_rule(case):
    """A sharded tree, a ``TPCache``, B > 1, prefill_len short of the rows
    and w8a8 each keep the eager path, whatever graph is handed in."""
    params = _talker()
    prompt, cache = _inputs(params, streams=2 if case == "two_streams" else 1)
    n = ROWS - 1 if case == "padded" else ROWS
    if case == "sharded":
        params = ShardedTree([params], ["cpu"])
    if case == "tp_cache":
        cache = nn.TPCache((cache,))
    if case == "w8a8":
        with quant.w8a8_scope(True):
            assert talker.prefill_graph_key(params, prompt, n, cache) is None
        return
    assert talker.prefill_graph_key(params, prompt, n, cache) is None


def test_graph_needs_a_card_tree():
    with pytest.raises(ValueError, match="CUDA graph"):
        talker.PrefillGraph(_talker(), TALKER, ROWS)


def _eager_as_before(params, prompt, n, cache):
    """The prefill as the port ran it before the graph: the layer stack,
    the final norm, row ``n - 1`` and the codec head."""
    stack = TALKER.layer_stack()
    h = nn.run_layer_stack(params["layers"], prompt, stack, cache, torch.arange(prompt.shape[1]), 0,
                           self_attn_prefill=True)
    h = nn.rms_norm(h, params["norm"], TALKER.rms_norm_eps)
    last = h[torch.arange(1), torch.tensor([n - 1])][:, None]
    return last, quant.mm(last, params["codec_head"])[:, 0, :]


@pytest.mark.parametrize("graph", ["none", "card", "another_tree", "another_rows", "another_dtype"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfitting_graph_runs_the_eager_prefill(graph, dtype):
    """Without a graph, or with one whose key the call does not give (a
    card graph of this tree on a CPU call, another tree, another row count,
    another dtype), ``talker.prefill`` is the eager prefill, bit for bit."""
    params = _talker(dtype=dtype)
    prompt, cache = _inputs(params)
    cpu_key = talker.prefill_graph_key(params, prompt, ROWS, cache)
    stub = {"none": None, "card": _refusing(_card_key(params)),
            "another_tree": _refusing(cpu_key[:4] + (id(_talker(dtype=dtype)),)),
            "another_rows": _refusing(cpu_key[:2] + ((1, 12, TALKER.hidden_size),) + cpu_key[3:]),
            "another_dtype": _refusing(cpu_key[:1] + (torch.float16,) + cpu_key[2:])}[graph]
    last, logits = talker.prefill(params, TALKER, prompt, ROWS, cache, stub)
    _, ref_cache = _inputs(params)
    ref_last, ref_logits = _eager_as_before(params, prompt, ROWS, ref_cache)
    assert torch.equal(last, ref_last) and torch.equal(logits, ref_logits)
    assert torch.equal(cache.k, ref_cache.k) and torch.equal(cache.v, ref_cache.v)


def test_fitting_graph_is_replayed():
    """A graph whose key the call gives is replayed, once, with the prompt
    and the call's cache; the eager path does not run."""
    params = _talker()
    prompt, cache = _inputs(params)
    calls = []
    stub = SimpleNamespace(key=talker.prefill_graph_key(params, prompt, ROWS, cache),
                           replay=lambda p, c: calls.append((p, c)) or ("last", "logits"))
    assert talker.prefill(params, TALKER, prompt, ROWS, cache, stub) == ("last", "logits")
    assert len(calls) == 1 and calls[0][0] is prompt and calls[0][1] is cache
    assert not cache.k.any()


def _tiny_model() -> Qwen3TTS:
    gen = torch.Generator().manual_seed(3)
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="0b6", talker=TALKER, code_predictor=CP)
    return Qwen3TTS(cfg, W.init_talker_params(gen, TALKER, torch.float32),
                    W.init_code_predictor_params(gen, CP, torch.float32), vocoder.init_vocoder_params(gen, VOC),
                    Tokens(), vocoder_config=VOC)


def _sessions(model, text="a few words to say"):
    """One session of each prompt layout of a CustomVoice model: preset
    speaker, voice design, x-vector clone."""
    opts = SynthesisOptions(max_length=6, min_new_tokens=6, seed=5)
    vec = np.linspace(-1, 1, model.config.talker.hidden_size).astype(np.float32)
    return {"custom_voice": lambda: model.synthesize_streaming(text, "ryan", "english", opts),
            "voice_design": lambda: model.synthesize_voice_design_streaming(text, "a calm low voice", "english", opts),
            "xvector_clone": lambda: model.synthesize_voice_clone_streaming(text, VoiceClonePrompt(vec), "english",
                                                                            opts)}


@pytest.mark.parametrize("layout", ["custom_voice", "voice_design", "xvector_clone"])
def test_cpu_prefill_counts_no_graph(layout):
    """On the CPU the model holds no graph, and every ``q3.prefill`` span
    reads ``graph`` 0."""
    model = _tiny_model()
    assert model.prefill_graph is None
    with profiling.spans() as got:
        list(_sessions(model)[layout]())
    spans = [s for s in got if s.name == "q3.prefill"]
    assert len(spans) == 1 and spans[0].counters == {"graph": 0}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

FORMS = [("1.7B", False), ("1.7B", True), ("0.6B", False), ("0.6B", True)]
_MODELS: dict = {}


def _card_model(variant: str, int8: bool) -> Qwen3TTS:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")
    if (variant, int8) not in _MODELS:
        model = Qwen3TTS.from_random(config_for_variant(variant, "custom_voice"), seed=0,
                                     device=torch.device("cuda", 0), quantize_int8=int8)
        model.tokenizer = Tokens()
        _MODELS[(variant, int8)] = model
    return _MODELS[(variant, int8)]


def _card_prompt(model, text="the first words of a short sentence", speaker="ryan"):
    """The CustomVoice prompt rows of ``text`` and a fresh session cache."""
    from qwen3_tts_tpu_torch.models import tokens as T

    text_ids, text_len = model._pad_ids(model._encode_text(text))
    prompt, n, _, _ = prefill.custom_voice_rows(model.talker_params, text_ids, text_len,
                                                T.speaker_info(speaker).token_id, T.language_token_id("english"))
    return prompt, n, model._new_cache(n, 64)


def _first_token(model, last, logits, cache):
    scfg = SynthesisOptions(temperature=0.9, seed=11).sampling_config()
    return core.init_state(scfg, logits, last, ROWS, cache, model._uniforms(11, 64), 64).token


@pytest.mark.gpu
@pytest.mark.parametrize("variant,int8", FORMS)
def test_replay_is_the_eager_prefill(variant, int8):
    """Last hidden, logits, first token and cache rows 0-9 bit-equal to the
    eager prefill; the rows past the prompt untouched; kernel 4's launches
    advance by an eager prefill's count a replay."""
    model = _card_model(variant, int8)
    params, cfg, graph = model.talker_params, model.config.talker, model.prefill_graph
    prompt, n, cache_e = _card_prompt(model)
    _, _, cache_g = _card_prompt(model)
    assert n == ROWS and talker.graph_fits(graph, params, prompt, n, cache_g)
    talker.prefill(params, cfg, prompt, n, _card_prompt(model)[2], graph)  # the capture, if not yet made
    k4 = quant.int8_matmul.launches
    eager = talker.prefill(params, cfg, prompt, n, cache_e)
    k4_eager = quant.int8_matmul.launches - k4
    replayed = talker.prefill(params, cfg, prompt, n, cache_g, graph)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches - k4 - k4_eager == k4_eager == graph.k4_launches
    assert (k4_eager > 0) == int8
    for a, b in zip(eager, replayed):
        assert a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(cache_e.k, cache_g.k) and torch.equal(cache_e.v, cache_g.v)
    assert not cache_g.k[:, :, n:].any() and cache_g.k[:, :, :n].abs().sum() > 0
    assert torch.equal(_first_token(model, *eager, cache_e), _first_token(model, *replayed, cache_g))


@pytest.mark.gpu
@pytest.mark.parametrize("variant,int8", FORMS)
def test_other_prefills_between_replays_change_nothing(variant, int8):
    """Eager prefills of other shapes (a longer prompt, a padded one, two
    streams) between two replays change neither the second replay nor what
    the first returned."""
    model = _card_model(variant, int8)
    params, cfg, graph = model.talker_params, model.config.talker, model.prefill_graph
    prompt, n, cache1 = _card_prompt(model)
    first = talker.prefill(params, cfg, prompt, n, cache1, graph)
    kept = [t.clone() for t in first] + [cache1.k.clone(), cache1.v.clone()]
    gen = torch.Generator(device=prompt.device).manual_seed(2)
    for rows, n_live, streams in ((16, 16, 1), (16, 13, 1), (ROWS, ROWS, 2)):
        other = torch.randn((streams, rows, prompt.shape[-1]), generator=gen, device=prompt.device).to(prompt.dtype)
        cache = nn.init_kv_cache(cfg.layer_stack(), streams, 32, prompt.dtype, prompt.device)
        assert not talker.graph_fits(graph, params, other, n_live, cache)
        if streams == 1:
            talker.prefill(params, cfg, other, n_live, cache, graph)
        else:
            talker.prefill_batch(params, cfg, other, [n_live] * streams, cache)
    second = talker.prefill(params, cfg, prompt, n, _card_prompt(model)[2], graph)
    torch.cuda.synchronize()
    for a, b in zip(list(first) + [cache1.k, cache1.v], kept):
        assert torch.equal(a, b)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,int8", FORMS)
def test_sessions_side_by_side(variant, int8):
    """Two streams opened before either runs its loop give the codes each
    gives alone; each open replays the graph once, and the graph is
    captured once."""
    model = _card_model(variant, int8)
    graph = model.prefill_graph
    opts = SynthesisOptions(max_length=12, min_new_tokens=12, seed=7, temperature=0.9)
    texts = (("one short line of words", "ryan"), ("another and somewhat longer line of words to say", "vivian"))

    def codes(session):
        for _ in session:
            pass
        return session.state.frames[:12].clone()

    alone = [codes(model.synthesize_streaming(t, s, "english", opts)) for t, s in texts]
    captured, replays = graph.graph, []
    inner = graph.replay
    graph.replay = lambda *a: replays.append(1) or inner(*a)
    try:
        sessions = [model.synthesize_streaming(t, s, "english", opts) for t, s in texts]
        together = [codes(s) for s in sessions]
    finally:
        del graph.replay
    assert len(replays) == 2 and graph.graph is captured
    for a, b in zip(alone, together):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,int8", FORMS)
def test_span_counts_the_replay(variant, int8):
    """``q3.prefill`` reads ``graph`` 1 for the 10-row prompts (preset
    speaker, x-vector clone) and 0 for a voice-design prompt."""
    model = _card_model(variant, int8)
    want = {"custom_voice": 1, "voice_design": 0, "xvector_clone": 1}
    for layout, open_session in _sessions(model).items():
        with profiling.spans() as got:
            list(open_session())
        spans = [s for s in got if s.name == "q3.prefill"]
        assert [s.counters for s in spans] == [{"graph": want[layout]}], layout


@pytest.mark.gpu
def test_card_rule():
    """On the card a CPU prompt, two streams, another row count and a
    padded prompt do not fit the graph; the 10-row prompt does."""
    model = _card_model("0.6B", False)
    params, graph = model.talker_params, model.prefill_graph
    prompt, n, cache = _card_prompt(model)
    assert talker.graph_fits(graph, params, prompt, n, cache)
    cpu = nn.KVCache(cache.k.cpu(), cache.v.cpu())
    assert not talker.graph_fits(graph, params, prompt.cpu(), n, cpu)
    two = nn.init_kv_cache(model.config.talker.layer_stack(), 2, 32, prompt.dtype, prompt.device)
    assert not talker.graph_fits(graph, params, prompt.expand(2, -1, -1), n, two)
    assert not talker.graph_fits(graph, params, prompt[:, :9], 9, cache)
    assert not talker.graph_fits(graph, params, prompt, n - 1, cache)
    assert not talker.graph_fits(graph, _card_model("0.6B", True).talker_params, prompt, n, cache)
