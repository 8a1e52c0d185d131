"""The port's server against the JAX package's server on twin tiny models (f32, CPU).

``test_torch_voice_clone.build_models()``: the same numpy weights through
each package's ``from_numpy`` path (the tiny vocoder drawn so that the
audio has a real scale, and both encoders). Each package's
``BatchingEngine`` gets the same requests at once (``max_batch`` the
number of requests and a wide window, so both coalesce them the same
way), and the floats they return (``req.result``, the chunks a stream
pushes) are compared:

* a solo request: each engine's result bit-equal to its own library call,
  the two within atol 1e-5, the frames token-exact;
* a coalesced batch of three: one ``synthesize_batch`` call in each, every
  stream bit-equal to its row of the port's library call and within 1e-5
  of the JAX server's, the frames token-exact (``check_batch``);
* a coalesced stream group: chunk by chunk the same lengths and within
  1e-5 of the JAX server's chunks;
* an ICL voice registered over HTTP (``POST /v1/voices``) on both servers
  from the same WAV: the prompts' codes equal and x-vectors within 1e-5 of
  max|x|; a request with each ``voice_id`` within 1e-5 of the other.
"""

import base64
import io
import json
import threading
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu import server as jsrv
from qwen3_tts_tpu_torch import encoder_fixture
from qwen3_tts_tpu_torch import server as tsrv
from qwen3_tts_tpu_torch.pipeline import SynthesisOptions
from test_torch_batch import AUDIO_ATOL, check_batch
from test_torch_voice_clone import REF_TEXT, build_models

torch.set_num_threads(1)

WIDE_MS = 10_000.0


@pytest.fixture(scope="module")
def models():
    return build_models()


def _engines(models, n: int):
    jm, tm = models
    return (jsrv.BatchingEngine(jm, max_batch=n, batch_window_ms=WIDE_MS),
            tsrv.BatchingEngine(tm, max_batch=n, batch_window_ms=WIDE_MS))


def _submit_all(engine, reqs) -> None:
    threads = [threading.Thread(target=engine.submit, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]


def _drain(req) -> list:
    chunks = []
    while (item := req.chunks.get(timeout=300)) is not None:
        assert not isinstance(item, Exception), item
        chunks.append(item)
    return chunks


def test_solo_request_matches_jax(models):
    jm, tm = models
    jeng, teng = _engines(models, 1)
    kw = dict(max_length=10, seed=5)
    jreq = jsrv._Request("Solo request here.", "ryan", "english", JP.SynthesisOptions(**kw))
    treq = tsrv._Request("Solo request here.", "ryan", "english", SynthesisOptions(**kw))
    _submit_all(jeng, [jreq])
    _submit_all(teng, [treq])
    np.testing.assert_array_equal(treq.result, tm.synthesize_with_voice(treq.text, options=treq.options).samples)
    np.testing.assert_array_equal(jreq.result, np.asarray(jm.synthesize_with_voice(jreq.text,
                                                                                   options=jreq.options).samples))
    assert treq.result.shape == jreq.result.shape
    np.testing.assert_allclose(treq.result, jreq.result, rtol=0, atol=AUDIO_ATOL)
    assert np.abs(jreq.result).max() > 1e-3
    want = jm._custom_voice_session(jreq.text, "ryan", "english", jreq.options).run_to_completion()
    got = tm._custom_voice_session(treq.text, "ryan", "english", treq.options).run_to_completion()
    np.testing.assert_array_equal(got, want)


TEXTS = ["Hi", "Second one differs", "Third!"]


def test_coalesced_batch_matches_jax(models):
    jm, tm = models
    jeng, teng = _engines(models, 3)
    calls = []
    orig = tm.synthesize_batch
    tm.synthesize_batch = lambda texts, *a, **k: calls.append(list(texts)) or orig(texts, *a, **k)
    try:
        kw = [dict(max_length=12, seed=42 + i) for i in range(3)]
        jreqs = [jsrv._Request(t, "ryan", "english", JP.SynthesisOptions(**k)) for t, k in zip(TEXTS, kw)]
        treqs = [tsrv._Request(t, "ryan", "english", SynthesisOptions(**k)) for t, k in zip(TEXTS, kw)]
        _submit_all(jeng, jreqs)
        _submit_all(teng, treqs)
    finally:
        del tm.synthesize_batch
    assert len(calls) == 1 and sorted(calls[0]) == sorted(TEXTS)
    order = [calls[0].index(t) for t in TEXTS]
    # The library: frames token-exact and audio within 1e-5 of the JAX
    # package's, in the order the engine passed the texts.
    texts = calls[0]
    seeds = [42 + TEXTS.index(t) for t in texts]
    _, audio = check_batch(jm, tm, texts, seeds=seeds, max_length=12)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        np.testing.assert_array_equal(tr.result, audio[order[i]])
        np.testing.assert_allclose(tr.result, np.asarray(jr.result), rtol=0, atol=AUDIO_ATOL)


def test_coalesced_stream_group_matches_jax(models):
    jm, tm = models
    jeng = jsrv.BatchingEngine(jm, max_batch=2, batch_window_ms=WIDE_MS, stream_window_ms=WIDE_MS)
    teng = tsrv.BatchingEngine(tm, max_batch=2, batch_window_ms=WIDE_MS, stream_window_ms=WIDE_MS)
    kw = [dict(max_length=10, seed=3, chunk_frames=3), dict(max_length=7, seed=8, chunk_frames=3)]
    texts = ["Stream one", "Stream two is longer"]
    jreqs = [jsrv._StreamRequest(t, "ryan", "english", JP.SynthesisOptions(**k)) for t, k in zip(texts, kw)]
    treqs = [tsrv._StreamRequest(t, "ryan", "english", SynthesisOptions(**k)) for t, k in zip(texts, kw)]
    for r in jreqs:
        jeng.submit_stream(r)
    for r in treqs:
        teng.submit_stream(r)
    for jr, tr in zip(jreqs, treqs):
        jchunks, tchunks = _drain(jr), _drain(tr)
        assert [len(c) for c in tchunks] == [len(c) for c in jchunks]
        assert sum(len(c) for c in tchunks) == tr.options.max_length * 1920
        for got, want in zip(tchunks, jchunks):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=AUDIO_ATOL)


def _wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767.0).astype("<i2").tobytes())
    return buf.getvalue()


def _register(engine, make_handler, wav: bytes) -> dict:
    http = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, engine.model))
    threading.Thread(target=http.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{http.server_address[1]}/v1/voices",
                                     data=json.dumps({"audio_b64": base64.b64encode(wav).decode(),
                                                      "ref_text": REF_TEXT}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())
    finally:
        http.shutdown()


def test_registered_icl_voice_matches_jax(models):
    jeng, teng = _engines(models, 1)
    wav = _wav_bytes(encoder_fixture.reference_audio(24000, seed=5, seconds=1.28), 24000)
    jout, tout = _register(jeng, jsrv.make_handler, wav), _register(teng, tsrv.make_handler, wav)
    assert jout["icl"] is tout["icl"] is True and tout["ref_seconds"] == jout["ref_seconds"]
    jp, tp = jeng.get_voice(jout["voice_id"]), teng.get_voice(tout["voice_id"])
    np.testing.assert_array_equal(tp.ref_codes, np.asarray(jp.ref_codes))
    np.testing.assert_allclose(tp.speaker_embedding, np.asarray(jp.speaker_embedding), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jp.speaker_embedding)).max())
    kw = dict(max_length=8, seed=4)
    jreq = jsrv._Request("Cloned words.", jp, "english", JP.SynthesisOptions(**kw))
    treq = tsrv._Request("Cloned words.", tp, "english", SynthesisOptions(**kw))
    _submit_all(jeng, [jreq])
    _submit_all(teng, [treq])
    assert treq.result.shape == jreq.result.shape and len(treq.result) > 0
    np.testing.assert_allclose(treq.result, np.asarray(jreq.result), rtol=0, atol=AUDIO_ATOL)
