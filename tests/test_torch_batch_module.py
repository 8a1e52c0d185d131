"""``generation.batch``, the port against the JAX package's (f32, CPU).

The five entry points of ``qwen3_tts_tpu.generation.batch`` have their
counterparts in ``qwen3_tts_tpu_torch.generation.batch``, with the same
names and argument order. On the tiny Base model of
``tests/test_torch_voice_clone.py`` and the same numpy inputs (B = 3
streams: padded ids with their own lengths, per-stream speakers, vectors,
instructs or reference-code rows, seeded PCG uniforms, frame limits of 16,
12 and 9), each layout's prefill (CustomVoice, x-vector clone, voice
design, ICL clone overlaid and sequential) must give the JAX package's
first tokens, positions, last hidden states, trailing text and pad row
(within 1e-5), and its ``generate_frames_batch`` the JAX package's frames
buffer and frame counts token for token, greedy and under seeded PCG
sampling. The JAX cache is
``[B, L, 1, S, KV, D]``, the port's ``[L, B, S, KV, D]``; the cache rows
the prefill writes agree within 1e-5 too.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.generation import batch as jbatch
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import rng
from qwen3_tts_tpu_torch.generation import batch as tbatch
from qwen3_tts_tpu_torch.models import tokens as T
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.pipeline import SynthesisOptions
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

B = 3
MAX_NEW = 16
LIMITS = [16, 12, 9]
TB = 16  # the text bucket of the padded ids
CB = 16  # the ICL reference-code rows' bucket
ATOL = 1e-5
SPEAKERS = ["vivian", "ryan", "sohee"]


@pytest.fixture(scope="module")
def models():
    return build_models()


def _inputs(kind: str, hidden: int) -> tuple[list, int]:
    """The layout's numpy inputs after (talker, tcfg, scfg), before the
    caches, and the prompt rows the caches need."""
    r = np.random.RandomState(5)
    lang = np.full(B, T.language_token_id("english"), np.int32)

    def ids(lens, width=TB):
        out = np.zeros((B, width), np.int32)
        for i, n in enumerate(lens):
            out[i, :n] = r.randint(10, 200, n)
        return out, np.asarray(lens, np.int32)

    vecs = (r.standard_normal((B, hidden)) * 0.1).astype(np.float32)
    if kind == "custom_voice":
        text, lens = ids([4, 11, 7])
        return [text, lens, np.asarray([T.speaker_info(s).token_id for s in SPEAKERS], np.int32), lang], 10
    if kind == "voice_clone":
        text, lens = ids([6, 3, 12])
        return [text, lens, vecs, lang], 10
    if kind == "voice_design":
        text, lens = ids([5, 9, 2])
        instruct, ins_lens = ids([14, 6, 10])
        return [text, lens, instruct, ins_lens, lang], TB + 9
    text, n_texts = ids([13, 8, 15])
    n_codecs = np.asarray([9, 16, 5], np.int32)
    rows = np.zeros((B, CB, hidden), np.float32)
    for i, n in enumerate(n_codecs):
        rows[i, :n] = r.standard_normal((n, hidden)) * 0.1
    return [text, n_texts, vecs, rows, n_codecs, lang], 9 + CB + (TB if kind.endswith("sequential") else 0)


def _jax_cache(tcfg, rows: int):
    stack = tcfg.layer_stack()
    shape = (B, stack.num_layers, 1, rows, stack.num_kv_heads, stack.head_dim)
    return jnn.KVCache(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])
@pytest.mark.parametrize("kind", ["custom_voice", "voice_clone", "voice_design", "voice_clone_icl",
                                  "voice_clone_icl_sequential"])
def test_batch_functions_match_jax(models, kind, temperature):
    jm, tm = models
    name = f"prefill_{kind.removesuffix('_sequential')}_batch"
    kw = {"sequential": True} if kind.endswith("sequential") else {}
    jprefill, tprefill = partial(getattr(jbatch, name), **kw), partial(getattr(tbatch, name), **kw)
    opts = dict(temperature=temperature, seed=3)
    jscfg, tscfg = JP.SynthesisOptions(**opts).sampling_config(), SynthesisOptions(**opts).sampling_config()
    inputs, prompt_rows = _inputs(kind, tm.config.talker.hidden_size)
    rows = prompt_rows + MAX_NEW + 8
    uniforms = np.stack([rng.pcg_uniform_sequence(3 + i, MAX_NEW + 1) for i in range(B)])

    jstate, jtrail, jlens, jpads = jprefill(jm.talker_params, jm.config.talker, jscfg, *map(jnp.asarray, inputs),
                                            _jax_cache(jm.config.talker, rows), jnp.asarray(uniforms), MAX_NEW)
    cache = tnn.init_kv_cache(tm.config.talker.layer_stack(), B, rows, torch.float32, torch.device("cpu"))
    tstate, ttrail, tlens, tpad = tprefill(tm.talker_params, tm.config.talker, tscfg,
                                           *map(torch.from_numpy, inputs), cache, torch.from_numpy(uniforms), MAX_NEW)
    np.testing.assert_array_equal(tstate.token.numpy(), np.asarray(jstate.token))
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    assert list(tlens) == np.asarray(jlens).tolist()
    _close(tstate.last_hidden, jstate.last_hidden, "last hidden")
    _close(ttrail, jtrail, "trailing")
    _close(tpad, np.asarray(jpads)[0], "pad")
    for got, want in ((tstate.cache.k, jstate.cache.k), (tstate.cache.v, jstate.cache.v)):  # [L, B, S, ...]
        _close(got.transpose(0, 1), np.asarray(want)[:, :, 0], "cache")

    jout = jbatch.generate_frames_batch(jm.talker_params, jm.cp_params, jm.config.talker, jm.config.code_predictor,
                                        jscfg, jstate, jtrail, jlens, jpads[0], jnp.asarray(uniforms),
                                        jnp.asarray(LIMITS, jnp.int32))
    tout = tbatch.generate_frames_batch(tm.talker_params, tm.cp_params, tm.config.talker, tm.config.code_predictor,
                                        tscfg, tstate, ttrail, tlens, tpad, torch.from_numpy(uniforms),
                                        torch.tensor(LIMITS))
    assert tout is tstate
    counts = np.asarray(jout.frame_idx)
    np.testing.assert_array_equal(tout.frame_idx.numpy(), counts)
    np.testing.assert_array_equal(tout.frames.numpy(), np.asarray(jout.frames))
    np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
    assert counts.max() > 0 and (counts <= LIMITS).all()
