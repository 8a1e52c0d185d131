"""``streaming_lookahead``: chunks queued ahead, the port against the JAX package (f32, CPU).

``SynthesisOptions.streaming_lookahead`` = k makes a session queue up to k
chunks on the device beyond the one it returns (``_pending``, up to
``_spec_frontier``); a chunk queued past EOS or ``max_length`` runs frozen
frames and is dropped. No value may change a sample:

* ``StreamingSession`` (``test_torch_streaming``'s tiny model, the JAX
  package's ``tests/test_pipeline.py`` cases): chunks at lookahead 0, 1 and
  2 are bit-equal to each other and within 1e-5 of the JAX session's at the
  same lookahead, through a tail cut by ``max_length`` and through EOS in
  the middle of a chunk (chunks queued past it);
* ``next_chunk()`` leaves a chunk pending, and ``run_to_audio()`` then
  gives the rest of the utterance once: with the first chunk, within 2e-6
  of ``decode_codes`` of the frames and within 1e-5 of the JAX session's
  same calls, also when the queued chunks ran past EOS;
* the order that makes it pay: chunk k+1 is queued before the host waits
  for chunk k, and the wait is for chunk k's copy alone;
* on the card the host stops launching a queued chunk's frames once the
  chunk before it is on the host (``pipeline._Landed``), and carries it on
  at the next call. On the CPU nothing runs behind the host, so a stand-in
  (``FiresAfter``) cuts the queued chunks after a set number of frames:
  the chunks, and ``run_to_audio`` after a cut chunk, are lookahead 0's,
  and the host still waits for chunk k before chunk k+1's decode is queued.

``StreamingBatchSession``'s lookahead is held in
``test_torch_batch_stream.py`` (its models and prompts).
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from test_torch_streaming import TEXT, _jax_tiny_model, _port_model

torch.set_num_threads(1)

LOOKAHEADS = (0, 1, 2)
CHUNK_ATOL = 1e-5  # against the JAX session (test_torch_streaming's bar)
WHOLE_ATOL = 2e-6  # against decode_codes of the frames (the JAX package's bar for the pair)


@pytest.fixture(scope="module")
def models():
    jm = _jax_tiny_model()
    return jm, _port_model(jm, jm.talker_params)


@pytest.fixture(scope="module")
def eos_id(models):
    """A token that first appears at frame 7 or later of the seed-42 run:
    as the EOS id, the stream ends in the middle of a 3-frame chunk."""
    _, tm = models
    tokens = tm._custom_voice_session(TEXT, "ryan", "english", TP.SynthesisOptions(max_length=20, seed=42)) \
        .run_to_completion()[:, 0]
    return next(int(t) for i, t in enumerate(tokens) if i >= 7 and t not in tokens[:i])


def _cases(eos_id: int) -> dict:
    return {"max_length": dict(max_length=9, seed=5, chunk_frames=2, first_chunk_frames=None),
            "eos": dict(max_length=20, seed=42, chunk_frames=3, eos_token_id=eos_id)}


def _chunks(model, options) -> list[np.ndarray]:
    return [np.asarray(c.samples) for c in model.synthesize_streaming(TEXT, "ryan", "english", options)]


@pytest.mark.parametrize("case", ["max_length", "eos"])
def test_lookahead_chunks_match_jax(models, eos_id, case):
    jm, tm = models
    kw = _cases(eos_id)[case]
    runs = {}
    for k in LOOKAHEADS:
        want = _chunks(jm, JP.SynthesisOptions(streaming_lookahead=k, **kw))
        got = runs[k] = _chunks(tm, TP.SynthesisOptions(streaming_lookahead=k, **kw))
        assert [len(c) for c in got] == [len(c) for c in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=CHUNK_ATOL)
    for k in LOOKAHEADS[1:]:
        assert len(runs[k]) == len(runs[0])
        for a, b in zip(runs[0], runs[k]):
            np.testing.assert_array_equal(a, b)
    frames = sum(len(c) for c in runs[0]) // SAMPLES_PER_FRAME
    assert frames == 9 if case == "max_length" else 7 <= frames < 20


@pytest.mark.parametrize("lookahead,case", [(1, "max_length"), (2, "eos")])
def test_next_chunk_then_run_to_audio(models, eos_id, lookahead, case):
    jm, tm = models
    kw = dict(_cases(eos_id)[case], chunk_frames=3, streaming_lookahead=lookahead)
    kw.pop("first_chunk_frames", None)
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", TP.SynthesisOptions(**kw))
    first = ts.next_chunk()
    assert len(ts._pending) == lookahead and ts._spec_frontier == 3 * (1 + lookahead)  # the first chunk: 3 of 4
    rest = ts.run_to_audio()
    assert not ts._pending and ts.is_done() and ts.next_chunk() is None
    stream = np.concatenate([first.samples, rest.samples])
    frames = tm._custom_voice_session(TEXT, "ryan", "english", TP.SynthesisOptions(**kw)).run_to_completion()
    assert len(stream) == len(frames) * SAMPLES_PER_FRAME == ts.frames_emitted * SAMPLES_PER_FRAME
    np.testing.assert_allclose(stream, tm.decode_codes(frames).samples, rtol=0, atol=WHOLE_ATOL)
    js = jm.synthesize_streaming(TEXT, "ryan", "english", JP.SynthesisOptions(**kw))
    want = np.concatenate([np.asarray(js.next_chunk().samples), np.asarray(js.run_to_audio().samples)])
    assert stream.shape == want.shape
    np.testing.assert_allclose(stream, want, rtol=0, atol=CHUNK_ATOL)


class FiresAfter:
    """``pipeline._Landed``'s stand-in on the CPU: True from its query after
    the ``n``-th on, so that a chunk queued ahead is cut after ``n`` frames."""

    def __init__(self, n: int):
        self.left, self.cut = n, False

    def __call__(self) -> bool:
        self.cut = self.cut or self.left <= 0
        self.left -= 1
        return self.cut


@pytest.mark.parametrize("after", [0, 1, 4])
@pytest.mark.parametrize("lookahead,case", [(1, "eos"), (2, "max_length"), (2, "eos")])
def test_chunks_cut_short_are_unchanged(models, eos_id, monkeypatch, after, lookahead, case):
    _, tm = models
    kw = _cases(eos_id)[case]
    want = _chunks(tm, TP.SynthesisOptions(streaming_lookahead=0, **kw))
    monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(after))
    got = _chunks(tm, TP.SynthesisOptions(streaming_lookahead=lookahead, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cut_chunk_then_run_to_audio(models, eos_id, monkeypatch):
    _, tm = models
    kw = dict(_cases(eos_id)["eos"], streaming_lookahead=1)
    plain = tm.synthesize_streaming(TEXT, "ryan", "english", TP.SynthesisOptions(**kw))
    want = np.concatenate([plain.next_chunk().samples, plain.run_to_audio().samples])
    monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(1))
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", TP.SynthesisOptions(**kw))
    first = ts.next_chunk()
    assert len(ts._pending) == 1 and ts._pending[0][3] is None  # cut after one frame
    stream = np.concatenate([first.samples, ts.run_to_audio().samples])
    np.testing.assert_array_equal(stream, want)
    frames = tm._custom_voice_session(TEXT, "ryan", "english", TP.SynthesisOptions(**kw)).run_to_completion()
    np.testing.assert_allclose(stream, tm.decode_codes(frames).samples, rtol=0, atol=WHOLE_ATOL)


@pytest.mark.parametrize("after", [None, 2])
def test_chunk_queued_before_the_read(models, monkeypatch, after):
    """At lookahead 1 each ``next_chunk`` queues the following chunk, then
    waits for its own chunk's copy alone. Cut after ``after`` frames (None:
    never), the queued chunk gets its decode at the next call, after the
    wait."""
    _, tm = models
    log = []
    starts = {}
    queue = TP.StreamingSession._advance_and_decode_chunk_exact
    wait = TP._HostCopy.wait

    def queued(self, frame_limit, emitted, chunk, until=None):
        fetch = queue(self, frame_limit, emitted, chunk, until)
        if fetch is not None:
            starts[id(fetch)] = emitted
        log.append(("queue" if fetch is not None else "cut", emitted))
        return fetch

    def waited(self):
        log.append(("wait", starts[id(self)]))
        return wait(self)

    monkeypatch.setattr(TP.StreamingSession, "_advance_and_decode_chunk_exact", queued)
    monkeypatch.setattr(TP._HostCopy, "wait", waited)
    if after is not None:
        monkeypatch.setattr(TP, "_landed", lambda fetch: FiresAfter(after))
    session = tm.synthesize_streaming(TEXT, "ryan", "english", TP.SynthesisOptions(max_length=24, seed=42,
                                                                                   min_new_tokens=24))
    for _ in range(3):
        session.next_chunk()
    # 4 frames, then 10 a chunk, up to 24: the third chunk is queued with the second read, nothing after it.
    if after is None:
        assert log == [("queue", 0), ("queue", 4), ("wait", 0), ("queue", 14), ("wait", 4), ("wait", 14)]
    else:
        assert log == [("queue", 0), ("cut", 4), ("wait", 0), ("queue", 4), ("cut", 14), ("wait", 4),
                       ("queue", 14), ("wait", 14)]
