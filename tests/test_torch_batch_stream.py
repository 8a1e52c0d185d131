"""Batched streaming (``synthesize_streaming_batch``), the port against the JAX package (f32, CPU).

``test_torch_batch_clone.py``'s models. Chunk by chunk, the port's
``StreamingBatchSession.next_chunks`` must give the JAX session's list: a
``None`` where the JAX package has one (a stream that is done, ever after),
an empty chunk where it has one (an ICL stream whose vocoder grid is still
inside its reference prefix), and every other chunk's samples within atol
1e-5; each stream's chunks put together must equal the port's
``synthesize_batch`` within the JAX package's bar for that pair
(``tests/test_streaming_batch.py``: atol 2e-5, the streaming vocoder and
the bucketed decode tile their matmuls differently). Cases: preset speakers
(``streaming_lookahead`` 0 and 1, which changes no sample), uneven EOS (the
codec head's EOS column scaled, as in ``test_torch_batch.py``), ICL clones
with references of 16 and 10 frames and per-stream caps, and a final chunk
cut short by ``max_length``; a session of mixed layouts is refused. Uneven
EOS and ICL streams again at ``streaming_lookahead`` 0 (the cases above run
the default 1: chunks queued ahead, some past EOS), and with the chunks
queued ahead cut short after a set number of frames (on the card the host
stops launching them once the chunk before is on the host: ``_Landed``,
here ``test_torch_lookahead.FiresAfter``), and a chunk pending after
``next_chunks`` exactly when the lookahead asks for one.
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from test_torch_batch import EOS_TEXTS, eos_models
from test_torch_batch_clone import ICL_TEXTS, icl_prompts, low_icl_floor, wide_models  # noqa: F401
from test_torch_lookahead import FiresAfter

torch.set_num_threads(1)

STREAM_TEXTS = ["First utterance", "Second one differs a bit", "Third!"]
CHUNK_ATOL = 1e-5  # against the JAX session's chunk
BATCH_ATOL = 2e-5  # against synthesize_batch (the JAX package's bar)


@pytest.fixture(scope="module")
def models():
    return wide_models()


@pytest.fixture(scope="module")
def prompts(models):
    return icl_prompts(*models)


def drain(session) -> list:
    """Every ``next_chunks`` list until None; None after that too."""
    rounds = []
    while (chunks := session.next_chunks()) is not None:
        assert len(chunks) == session.batch
        rounds.append(chunks)
        assert len(rounds) < 200, "session failed to terminate"
    assert session.is_done() and session.next_chunks() is None
    return rounds


def check_stream(jm, tm, texts, jspeakers="ryan", tspeakers="ryan", **kw) -> list:
    """The port's rounds of chunks against the JAX session's, and each
    stream's chunks against the port's ``synthesize_batch``; returns the
    port's rounds."""
    want = drain(jm.synthesize_streaming_batch(texts, jspeakers, options=JP.SynthesisOptions(**kw)))
    got = drain(tm.synthesize_streaming_batch(texts, tspeakers, options=TP.SynthesisOptions(**kw)))
    assert len(got) == len(want)
    for r, (g_round, w_round) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(g_round, w_round)):
            assert (g is None) == (w is None), f"round {r} stream {i}"
            if g is not None:
                assert g.samples.shape == w.samples.shape, f"round {r} stream {i}"
                assert len(g.samples) % SAMPLES_PER_FRAME == 0
                np.testing.assert_allclose(g.samples, w.samples, rtol=0, atol=CHUNK_ATOL)
    for i in range(len(texts)):  # once None, always None
        nones = [rnd[i] is None for rnd in got]
        assert nones == sorted(nones)
    whole = tm.synthesize_batch(texts, tspeakers, options=TP.SynthesisOptions(**kw))
    for i, audio in enumerate(whole):
        parts = [rnd[i].samples for rnd in got if rnd[i] is not None]
        streamed = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        assert streamed.shape == audio.samples.shape and len(streamed) > 0
        np.testing.assert_allclose(streamed, audio.samples, rtol=0, atol=BATCH_ATOL)
    return got


@pytest.mark.parametrize("lookahead", [0, 1])
def test_preset_stream_matches_jax(models, lookahead):
    jm, tm = models
    got = check_stream(jm, tm, STREAM_TEXTS, max_length=12, seed=42, chunk_frames=3, first_chunk_frames=2,
                       streaming_lookahead=lookahead)
    assert [len(c.samples) // SAMPLES_PER_FRAME for c in (rnd[0] for rnd in got)] == [2, 3, 3, 3, 1]


def test_uneven_eos_stream_matches_jax(models):
    """Streams that meet EOS early yield None while the others go on."""
    jm, tm = eos_models(models)
    got = check_stream(jm, tm, EOS_TEXTS, max_length=16, seed=7, chunk_frames=4)
    assert any(c is None for rnd in got for c in rnd)


def test_icl_stream_matches_jax(models, prompts, low_icl_floor):
    """ICL streams on their own grids: empty chunks while the grid is inside
    a reference prefix (16 and 10 frames), caps of 6 and 16 frames."""
    jm, tm = models
    got = check_stream(jm, tm, ICL_TEXTS, prompts[0], prompts[1], max_length=16, seed=42, chunk_frames=6,
                       first_chunk_frames=4)
    sizes = [[None if c is None else len(c.samples) // SAMPLES_PER_FRAME for c in rnd] for rnd in got]
    assert sizes[:3] == [[0, 0], [0, 0], [0, 6]] and sizes[3][0] == 6 and sizes[4][0] is None


def test_partial_final_chunk_matches_jax(models):
    """max_length 11 in chunks of 4: the last chunk holds 3 frames."""
    jm, tm = models
    got = check_stream(jm, tm, STREAM_TEXTS[:2], max_length=11, seed=3, chunk_frames=4, first_chunk_frames=None,
                       min_new_tokens=11)
    assert [len(rnd[0].samples) // SAMPLES_PER_FRAME for rnd in got] == [4, 4, 3]


def test_mixed_layouts_refused(models, prompts):
    _, tm = models
    with pytest.raises(ValueError, match="one prompt layout per session"):
        tm.synthesize_streaming_batch(["a", "b"], ["ryan", prompts[1][0]])
    with pytest.raises(ValueError, match="one prompt layout per session"):
        tm.synthesize_streaming_batch(["a", "b"], instructs=["calm", None])
    xvector = TP.VoiceClonePrompt(prompts[1][0].speaker_embedding)
    assert tm.synthesize_streaming_batch(["a", "b"], ["ryan", xvector]).batch == 2  # one layout: they mix


def test_uneven_eos_stream_without_lookahead(models):
    jm, tm = eos_models(models)
    got = check_stream(jm, tm, EOS_TEXTS, max_length=16, seed=7, chunk_frames=4, streaming_lookahead=0)
    assert any(c is None for rnd in got for c in rnd)


def test_icl_stream_without_lookahead(models, prompts, low_icl_floor):  # noqa: F811
    jm, tm = models
    check_stream(jm, tm, ICL_TEXTS, prompts[0], prompts[1], max_length=16, seed=42, chunk_frames=6,
                 first_chunk_frames=4, streaming_lookahead=0)


@pytest.mark.parametrize("after", [0, 3])
def test_uneven_eos_stream_cut_short(models, monkeypatch, after):
    jm, tm = eos_models(models)
    monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(after))
    got = check_stream(jm, tm, EOS_TEXTS, max_length=16, seed=7, chunk_frames=4, streaming_lookahead=2)
    assert any(c is None for rnd in got for c in rnd)


def test_icl_stream_cut_short(models, prompts, low_icl_floor, monkeypatch):  # noqa: F811
    jm, tm = models
    monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(2))
    check_stream(jm, tm, ICL_TEXTS, prompts[0], prompts[1], max_length=16, seed=42, chunk_frames=6,
                 first_chunk_frames=4, streaming_lookahead=1)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_chunk_pending_after_next_chunks(models, lookahead):
    _, tm = models
    opts = TP.SynthesisOptions(max_length=12, seed=42, chunk_frames=3, first_chunk_frames=2,
                               streaming_lookahead=lookahead)
    session = tm.synthesize_streaming_batch(STREAM_TEXTS[:2], options=opts)
    session.next_chunks()
    assert len(session._pending) == lookahead and session._spec_frontier == 2 + 3 * lookahead
