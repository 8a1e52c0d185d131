"""The port's HTTP server (``qwen3_tts_tpu_torch/server.py``), on the CPU.

Each of ``tests/test_server.py``'s 25 tests, against the port's server on a
tiny port model (``test_pipeline``'s configs, weights drawn by the port's
own ``init_*`` from a seeded ``torch.Generator``): endpoints, WAV and
chunked streaming bytes, the engine's coalescing (options and stream
signatures, prompt layouts, ``_collect``'s FIFO deferral, stream windows,
legacy streams never coalescing), time-slicing against batch jobs, voice
registration, and ``main``'s ``--w8a8`` check. The random model's samples
are ~1e-9, so PCM16 bytes are silence: floats are compared through the
engine (``req.result``), HTTP carries headers, lengths and chunking. Where
a test asserts that requests coalesce, the engine's ``max_batch`` is the
number of requests and its window is wide (``WIDE_MS``), so the group
closes as soon as the last one arrives and a loaded machine cannot split
it. Two tests of the port's own: ``main`` resolves ``--device`` as the CLI
does, and the worker thread runs without grad.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave
from dataclasses import asdict

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import server as srv
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.codec import vocoder
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, ModelConfig, ModelType, TalkerConfig
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions, VoiceClonePrompt
from test_pipeline import TINY_CP, TINY_TALKER, TINY_VOC, FakeTokenizer

torch.set_num_threads(1)

WIDE_MS = 10_000.0  # a coalescing window no loaded machine outlasts


def tiny_model() -> Qwen3TTS:
    """A tiny CustomVoice port model on the CPU (no encoders), the same
    weights every call."""
    talker, cp = TalkerConfig(**asdict(TINY_TALKER)), CodePredictorConfig(**asdict(TINY_CP))
    voc = vocoder.VocoderConfig(**asdict(TINY_VOC))
    gen = torch.Generator().manual_seed(3)
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="0b6", talker=talker, code_predictor=cp)
    return Qwen3TTS(cfg, W.init_talker_params(gen, talker, torch.float32),
                    W.init_code_predictor_params(gen, cp, torch.float32), vocoder.init_vocoder_params(gen, voc),
                    FakeTokenizer(), vocoder_config=voc)


@pytest.fixture(scope="module")
def running_server():
    http = srv.serve(tiny_model(), host="127.0.0.1", port=0, max_batch=4, batch_window_ms=50)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{http.server_address[1]}"
    http.shutdown()


def _post(url, payload, path="/v1/synthesize"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _run_threads(fns) -> None:
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)


def test_healthz_and_model(running_server):
    with urllib.request.urlopen(running_server + "/healthz") as resp:
        assert json.loads(resp.read())["status"] == "ok"
    with urllib.request.urlopen(running_server + "/v1/model") as resp:
        info = json.loads(resp.read())
    assert info["sample_rate"] == 24000
    assert info["preset_speakers"] is True
    assert info["voice_cloning"] is False and info["voice_design"] is False


def test_synthesize_returns_wav(running_server):
    status, ctype, body = _post(running_server, {"text": "hello server", "seed": 42, "max_frames": 6})
    assert status == 200
    assert ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert len(body) == 44 + 2 * 6 * 1920  # 6 frames: EOS never fires on random weights


def test_concurrent_requests_batched():
    """Concurrent HTTP requests coalesce into one batched call and all
    succeed."""
    model = tiny_model()
    calls = []
    orig = model.synthesize_batch
    model.synthesize_batch = lambda texts, *a, **k: calls.append(tuple(texts)) or orig(texts, *a, **k)
    http = srv.serve(model, host="127.0.0.1", port=0, max_batch=3, batch_window_ms=WIDE_MS)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{http.server_address[1]}"
    results = {}
    try:
        _run_threads([lambda i=i: results.__setitem__(i, _post(base, {"text": f"utterance {i}", "seed": 42 + i,
                                                                      "max_frames": 6}))
                      for i in range(3)])
    finally:
        http.shutdown()
    assert set(results) == {0, 1, 2}
    for status, _, body in results.values():
        assert status == 200 and body[:4] == b"RIFF"
    assert len(calls) == 1 and sorted(calls[0]) == [f"utterance {i}" for i in range(3)]


def test_batched_matches_single_stream(running_server):
    """A request served inside a batch equals the same request served alone
    (transport-level: PCM16 of the tiny model is silence; the float checks
    are test_mixed_options_not_cross_batched / test_unseeded_batch_requests_differ)."""
    payload = {"text": "determinism", "seed": 7, "max_frames": 6}
    _, _, alone = _post(running_server, payload)
    results = {}
    _run_threads([lambda: results.__setitem__(0, _post(running_server, payload)),
                  lambda: results.__setitem__(1, _post(running_server, {"text": "other", "seed": 99,
                                                                       "max_frames": 6}))])
    assert results[0][2] == alone


def test_mixed_options_not_cross_batched():
    """A request with different sampling options keeps its own settings: the
    temperature=0.2 request runs in its own group (alone: the solo path)
    and gives exactly its solo audio."""
    model = tiny_model()
    calls = []
    orig_b, orig_s = model.synthesize_batch, model.synthesize_with_voice

    def spy_batch(texts, speakers="ryan", languages="english", options=None, seeds=None, instructs=None):
        calls.append(("batch", tuple(texts), options.temperature))
        return orig_b(texts, speakers, languages, options, seeds=seeds, instructs=instructs)

    def spy_single(text, speaker="ryan", language="english", options=None):
        calls.append(("single", text, options.temperature))
        return orig_s(text, speaker, language, options)

    model.synthesize_batch = spy_batch
    model.synthesize_with_voice = spy_single
    alone = orig_s("cool", options=SynthesisOptions(max_length=6, seed=5, temperature=0.2))
    engine = srv.BatchingEngine(model, max_batch=3, batch_window_ms=WIDE_MS)
    reqs = [
        srv._Request("cool", "ryan", "english", SynthesisOptions(max_length=6, seed=5, temperature=0.2)),
        srv._Request("other1", "ryan", "english", SynthesisOptions(max_length=6, seed=9)),
        srv._Request("other2", "ryan", "english", SynthesisOptions(max_length=6, seed=11)),
    ]
    _run_threads([lambda r=r: engine.submit(r) for r in reqs])
    assert all(r.error is None for r in reqs)
    assert ("single", "cool", 0.2) in calls
    batches = [sorted(texts) for kind, texts, _ in calls if kind == "batch"]
    assert batches == [["other1", "other2"]], calls
    np.testing.assert_array_equal(reqs[0].result, alone.samples)
    assert not np.array_equal(reqs[1].result, reqs[2].result)


def test_unseeded_batch_requests_differ():
    """Unseeded requests in one batch draw distinct time-entropy seeds."""
    model = tiny_model()
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=WIDE_MS)
    reqs = [srv._Request("zz", "ryan", "english", SynthesisOptions(max_length=6)) for _ in range(2)]
    _run_threads([lambda r=r: engine.submit(r) for r in reqs])
    assert all(r.error is None for r in reqs)
    assert not np.array_equal(reqs[0].result, reqs[1].result)


def test_options_signature_groups():
    """_collect partitions a window by sampling-options signature."""
    mk = lambda **kw: srv._Request("t", "ryan", "english", SynthesisOptions(**kw))  # noqa: E731
    a = srv.BatchingEngine._options_signature(mk(temperature=0.9, seed=1))
    b = srv.BatchingEngine._options_signature(mk(temperature=0.9, seed=2, max_length=64))
    c = srv.BatchingEngine._options_signature(mk(temperature=0.2))
    assert a == b  # seed/max_length do not split batches
    assert a != c  # temperature does


def test_bad_request(running_server):
    req = urllib.request.Request(running_server + "/v1/synthesize", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_streaming_endpoint_chunked_wav(running_server):
    """POST /v1/synthesize_streaming returns chunked WAV whose PCM payload
    reassembles to the non-streaming endpoint's PCM."""
    payload = {"text": "stream bytes", "seed": 42, "max_frames": 6, "chunk_frames": 3}
    _, _, batch_body = _post(running_server, payload)
    status, ctype, stream_body = _post(running_server, payload, "/v1/synthesize_streaming")
    assert status == 200 and ctype == "audio/wav"
    assert stream_body[:4] == b"RIFF" and stream_body[8:12] == b"WAVE"
    assert stream_body[44:] == batch_body[44:]
    assert len(stream_body) > 44


def test_streaming_engine_float_parity():
    """Engine-level float check: the streamed chunks concatenate to the
    non-streaming samples."""
    model = tiny_model()
    opts = SynthesisOptions(max_length=6, seed=3, chunk_frames=2)
    alone = model.synthesize_with_voice("float parity", options=opts)
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=10)
    req = srv._StreamRequest("float parity", "ryan", "english", opts)
    engine.submit_stream(req)
    stream = _drain_stream(req)
    assert len(stream) == len(alone.samples)
    np.testing.assert_allclose(stream, alone.samples, rtol=0, atol=2e-6)


def _drain_stream(req, timeout=120):
    parts = []
    while True:
        item = req.chunks.get(timeout=timeout)
        assert not isinstance(item, Exception), item
        if item is None:
            break
        parts.append(item)
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def test_concurrent_streams_share_one_batched_session():
    """Fresh streaming requests inside one window coalesce into a single
    StreamingBatchSession; each request still gets exactly its own audio,
    including its OWN max_length cap."""
    model = tiny_model()
    calls = []
    orig = model.synthesize_streaming_batch

    def spy(texts, speakers="ryan", languages="english", options=None, seeds=None, instructs=None):
        calls.append((tuple(texts), tuple(seeds), options.max_length))
        return orig(texts, speakers, languages, options, seeds=seeds)

    model.synthesize_streaming_batch = spy
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=WIDE_MS)
    opts1 = SynthesisOptions(max_length=8, seed=5, chunk_frames=2)
    opts2 = SynthesisOptions(max_length=6, seed=9, chunk_frames=2)
    r1 = srv._StreamRequest("stream one", "ryan", "english", opts1)
    r2 = srv._StreamRequest("stream two", "ryan", "english", opts2)
    engine.submit_stream(r1)
    engine.submit_stream(r2)
    s1, s2 = _drain_stream(r1), _drain_stream(r2)
    assert calls == [(("stream one", "stream two"), (5, 9), 8)]
    a1 = model.synthesize_with_voice("stream one", options=opts1)
    a2 = model.synthesize_with_voice("stream two", options=opts2)
    assert len(s1) == len(a1.samples) and len(s2) == len(a2.samples)
    np.testing.assert_allclose(s1, a1.samples, rtol=0, atol=2e-5)
    np.testing.assert_allclose(s2, a2.samples, rtol=0, atol=2e-5)


def test_mismatched_streams_not_grouped():
    """Streams with different chunk cadence cannot share a session."""
    model = tiny_model()
    batch_calls = []
    orig = model.synthesize_streaming_batch
    model.synthesize_streaming_batch = lambda *a, **k: batch_calls.append(1) or orig(*a, **k)
    engine = srv.BatchingEngine(model, max_batch=4, batch_window_ms=200)
    r1 = srv._StreamRequest("one", "ryan", "english", SynthesisOptions(max_length=4, seed=1, chunk_frames=2))
    r2 = srv._StreamRequest("two", "ryan", "english", SynthesisOptions(max_length=4, seed=2, chunk_frames=3))
    engine.submit_stream(r1)
    engine.submit_stream(r2)
    out1, out2 = _drain_stream(r1), _drain_stream(r2)
    assert not batch_calls  # ran as two solo sessions
    assert len(out1) > 0 and len(out2) > 0


def _engine_no_worker(model=None, max_batch=4, batch_window_ms=50.0, stream_window_ms=None):
    """A BatchingEngine with its fields set and NO worker thread, so that
    _collect is tested deterministically against a hand-built queue."""
    import queue as queue_mod
    from collections import deque

    e = srv.BatchingEngine.__new__(srv.BatchingEngine)
    e.model = model
    e.max_batch = max_batch
    e.batch_window_s = batch_window_ms / 1e3
    e.stream_window_s = e.batch_window_s if stream_window_ms is None else stream_window_ms / 1e3
    e.queue = queue_mod.Queue()
    e._deferred = deque()
    return e


def test_collect_defers_stream_group_from_batch_window():
    """A mid-flight _StreamGroup popped during a non-streaming batch window
    is deferred (it has no .options), not appended to the batch."""
    eng = _engine_no_worker(batch_window_ms=200)
    breq = srv._Request("batch job", "ryan", "english", SynthesisOptions(max_length=4))
    sreq = srv._StreamRequest("s", "ryan", "english", SynthesisOptions(max_length=4))
    grp = srv._StreamGroup(reqs=[sreq], frames_pushed=[0], alive=[True])
    later = srv._Request("later", "ryan", "english", SynthesisOptions(max_length=4))
    eng.queue.put(breq)
    eng.queue.put(grp)
    eng.queue.put(later)
    assert eng._collect() == [[breq]]
    # The group kept its FIFO position: it runs on the NEXT visit, before
    # "later", which arrived after it.
    assert list(eng._deferred) == [grp]
    assert eng._collect() == [[grp]]
    assert eng._collect() == [[later]]


def test_collect_defers_solo_stream_fifo():
    """An item displaced from a collection window runs immediately after the
    group (FIFO preserved), not at the queue tail."""
    eng = _engine_no_worker(batch_window_ms=200, stream_window_ms=200)
    s1 = srv._StreamRequest("a", "ryan", "english", SynthesisOptions(max_length=4, chunk_frames=2))
    b1 = srv._Request("b", "ryan", "english", SynthesisOptions(max_length=4))
    s2 = srv._StreamRequest("c", "ryan", "english", SynthesisOptions(max_length=4, chunk_frames=2))
    eng.queue.put(s1)
    eng.queue.put(b1)  # displaced from s1's stream window
    eng.queue.put(s2)
    assert eng._collect() == [[s1]]  # solo: b1 broke the coalesce loop
    assert eng._collect() == [[b1]]  # ...but b1 still runs before s2
    assert eng._collect() == [[s2]]


def test_collect_stream_window_zero_disables_coalescing():
    """stream_window_ms=0 starts fresh streams at once: no peer wait, no
    batched session."""
    eng = _engine_no_worker(stream_window_ms=0)
    s1 = srv._StreamRequest("a", "ryan", "english", SynthesisOptions(max_length=4))
    s2 = srv._StreamRequest("b", "ryan", "english", SynthesisOptions(max_length=4))
    eng.queue.put(s1)
    eng.queue.put(s2)
    t0 = time.monotonic()
    assert eng._collect() == [[s1]]
    assert time.monotonic() - t0 < 0.5  # did not wait out any window
    assert eng._collect() == [[s2]]


def test_legacy_streaming_exact_false_never_coalesces():
    """streaming_exact=False requests run solo (the batched session always
    runs the exact streaming vocoder)."""
    model = tiny_model()
    batch_calls = []
    orig = model.synthesize_streaming_batch
    model.synthesize_streaming_batch = lambda *a, **k: batch_calls.append(1) or orig(*a, **k)
    engine = srv.BatchingEngine(model, max_batch=4, batch_window_ms=200)
    opts = dict(max_length=4, chunk_frames=2, streaming_exact=False)
    r1 = srv._StreamRequest("one", "ryan", "english", SynthesisOptions(seed=1, **opts))
    r2 = srv._StreamRequest("two", "ryan", "english", SynthesisOptions(seed=2, **opts))
    engine.submit_stream(r1)
    engine.submit_stream(r2)
    out1, out2 = _drain_stream(r1), _drain_stream(r2)
    assert not batch_calls  # ran as two solo legacy sessions
    assert len(out1) > 0 and len(out2) > 0
    solo = model.synthesize_streaming("one", "ryan", "english", SynthesisOptions(seed=1, **opts))
    ref = np.concatenate([np.asarray(c.samples) for c in solo])
    np.testing.assert_allclose(out1, ref, rtol=0, atol=2e-6)


def test_mixed_traffic_batch_during_stream_group():
    """A non-streaming request arriving while a coalesced stream group is
    mid-flight completes, and the group's streams keep streaming to the end."""
    model = tiny_model()
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=WIDE_MS)
    gate = threading.Event()
    slices = [0]
    real_slice = engine._run_stream_group_slice

    def spy_slice(grp):
        slices[0] += 1
        if slices[0] == 2:
            # Hold the worker at the second group slice until the batch
            # request is queued: after this slice the queue is [batch_req, group].
            gate.wait(30)
        real_slice(grp)

    engine._run_stream_group_slice = spy_slice
    opts = SynthesisOptions(max_length=8, seed=5, chunk_frames=2)
    r1 = srv._StreamRequest("stream one", "ryan", "english", opts)
    r2 = srv._StreamRequest("stream two", "ryan", "english", SynthesisOptions(max_length=8, seed=9, chunk_frames=2))
    engine.submit_stream(r1)
    engine.submit_stream(r2)
    first1 = r1.chunks.get(timeout=120)  # the group formed and ran its first slice
    assert isinstance(first1, np.ndarray)
    breq = srv._Request("quick job", "ryan", "english", SynthesisOptions(max_length=4, seed=6))
    engine.queue.put(breq)
    gate.set()
    assert breq.done.wait(120)
    assert breq.error is None and breq.result is not None
    rest1, rest2 = _drain_stream(r1), _drain_stream(r2)
    a1 = model.synthesize_with_voice("stream one", options=opts)
    assert len(np.concatenate([first1, rest1])) == len(a1.samples)
    assert len(rest2) > 0


def test_streaming_time_slices_interleave_with_batch():
    """A streaming session yields the device between chunks: a batch request
    submitted mid-stream runs before the stream finishes."""
    model = tiny_model()
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=5)
    order = []
    gate = threading.Event()
    slices = [0]
    real_slice = engine._run_stream_slice

    def spy_slice(req):
        slices[0] += 1
        if slices[0] == 2:
            gate.wait(30)  # hold the worker until the batch job is queued
        order.append("slice")
        real_slice(req)

    engine._run_stream_slice = spy_slice
    real_syn = model.synthesize_with_voice
    model.synthesize_with_voice = lambda *a, **k: order.append("batch") or real_syn(*a, **k)
    sreq = srv._StreamRequest("long stream", "ryan", "english", SynthesisOptions(max_length=8, seed=5, chunk_frames=2))
    engine.submit_stream(sreq)
    assert isinstance(sreq.chunks.get(timeout=120), np.ndarray)
    breq = srv._Request("quick job", "ryan", "english", SynthesisOptions(max_length=4, seed=6))
    engine.queue.put(breq)  # enqueued while the stream still has slices left
    gate.set()
    assert breq.done.wait(120) and breq.error is None
    _drain_stream(sreq)
    i = order.index("batch")
    assert "slice" in order[:i], order  # the stream started first
    assert "slice" in order[i + 1:], order  # ...and resumed after the batch job


def test_main_rejects_w8a8_without_int8(capsys):
    """--w8a8 alone is an argparse error (Qwen3TTS raises ValueError for
    int8_activations without quantize_int8), not a silent bf16 server."""
    with pytest.raises(SystemExit) as exc:
        srv.main(["--model-dir", "/nonexistent", "--w8a8"])
    assert exc.value.code == 2
    assert "--w8a8 requires --int8" in capsys.readouterr().err


def _icl_prompt(seed=1, n_ref=4, n_text=2) -> VoiceClonePrompt:
    rs = np.random.RandomState(seed)
    return VoiceClonePrompt(
        speaker_embedding=rs.randn(TINY_TALKER.hidden_size).astype(np.float32),
        ref_codes=rs.randint(0, TINY_CP.vocab_size, size=(n_ref, 16)).astype(np.int32),
        ref_text_ids=[int(x) for x in rs.randint(3, 50, size=n_text)],
    )


def test_layout_signature_separation():
    """Preset and x-vector clones share the basic layout group; ICL clones
    and voice-design requests each get their own group."""
    opts = SynthesisOptions(max_length=6, seed=1)
    sig = srv.BatchingEngine._options_signature
    xv = VoiceClonePrompt(np.zeros(TINY_TALKER.hidden_size, np.float32))
    preset = sig(srv._Request("t", "ryan", "english", opts))
    xvec = sig(srv._Request("t", xv, "english", opts))
    icl = sig(srv._Request("t", _icl_prompt(), "english", opts))
    design = sig(srv._Request("t", "ryan", "english", opts, instruct="deep voice"))
    assert preset == xvec
    assert len({preset, icl, design}) == 3


def test_clone_requests_coalesce_and_match_library():
    """Concurrent ICL clone requests run as ONE synthesize_batch call with
    VoiceClonePrompt entries, and each result equals the library's output."""
    model = tiny_model()
    calls = []
    orig = model.synthesize_batch

    def spy(texts, speakers="ryan", languages="english", options=None, seeds=None, instructs=None):
        calls.append((tuple(texts), list(speakers)))
        return orig(texts, speakers, languages, options, seeds=seeds, instructs=instructs)

    model.synthesize_batch = spy
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=WIDE_MS)
    p1, p2 = _icl_prompt(1), _icl_prompt(2, n_ref=2, n_text=3)
    opts = SynthesisOptions(max_length=6, seed=5)
    reqs = [srv._Request("clone one", p1, "english", opts), srv._Request("clone two", p2, "english", opts)]
    _run_threads([lambda r=r: engine.submit(r) for r in reqs])
    assert all(r.error is None for r in reqs)
    assert len(calls) == 1 and sorted(calls[0][0]) == ["clone one", "clone two"]
    order = [calls[0][0].index(t) for t in ("clone one", "clone two")]
    assert [calls[0][1][i] for i in order] == [p1, p2]
    # The engine passes each request's OWN seed (both 5 here).
    want = orig(["clone one", "clone two"], [p1, p2], ["english"] * 2, opts, seeds=[5, 5])
    np.testing.assert_array_equal(reqs[0].result, want[0].samples)
    np.testing.assert_array_equal(reqs[1].result, want[1].samples)


def test_solo_clone_and_design_routing():
    """Singleton clone/design requests take the dedicated solo paths."""
    model = tiny_model()
    opts = SynthesisOptions(max_length=6, seed=3)
    engine = srv.BatchingEngine(model, max_batch=4, batch_window_ms=10)
    p = _icl_prompt(4)
    r1 = srv._Request("solo clone", p, "english", opts)
    engine.submit(r1)
    assert r1.error is None
    np.testing.assert_array_equal(r1.result, model.synthesize_voice_clone("solo clone", p, "english", opts).samples)
    r2 = srv._Request("solo design", "ryan", "english", opts, instruct="a calm voice")
    engine.submit(r2)
    assert r2.error is None
    want2 = model.synthesize_voice_design("solo design", "a calm voice", "english", opts)
    np.testing.assert_array_equal(r2.result, want2.samples)


def test_stream_group_clone_coalesces():
    """Concurrent ICL-clone streams coalesce into one batched session and
    each reassembled stream equals its synthesize_batch audio."""
    model = tiny_model()
    sessions = []
    orig = model.synthesize_streaming_batch

    def spy(texts, speakers="ryan", languages="english", options=None, seeds=None, instructs=None):
        sessions.append(tuple(texts))
        return orig(texts, speakers, languages, options, seeds=seeds, instructs=instructs)

    model.synthesize_streaming_batch = spy
    engine = srv.BatchingEngine(model, max_batch=2, batch_window_ms=WIDE_MS, stream_window_ms=WIDE_MS)
    p1, p2 = _icl_prompt(6, n_ref=5), _icl_prompt(7, n_ref=2)
    opts = SynthesisOptions(max_length=8, seed=11, chunk_frames=3)
    r1 = srv._StreamRequest("clone stream a", p1, "english", opts)
    r2 = srv._StreamRequest("clone stream b", p2, "english", opts)
    engine.submit_stream(r1)
    engine.submit_stream(r2)
    s1, s2 = _drain_stream(r1), _drain_stream(r2)
    assert sessions == [("clone stream a", "clone stream b")]
    want = model.synthesize_batch(["clone stream a", "clone stream b"], [p1, p2], ["english"] * 2, opts,
                                  seeds=[11, 11])
    np.testing.assert_allclose(s1, want[0].samples, atol=2e-5, rtol=0)
    np.testing.assert_allclose(s2, want[1].samples, atol=2e-5, rtol=0)


def _wav(seconds: float = 1.0) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes((np.sin(np.linspace(0, 100, int(24000 * seconds))) * 20000).astype("<i2").tobytes())
    return buf.getvalue()


def test_voice_registry_http_roundtrip():
    """POST /v1/voices registers a clone voice (encoded once); synthesize
    with voice_id and instruct route through the HTTP layer."""
    model = tiny_model()
    prompt = _icl_prompt(9)

    def fake_create(ref_audio, ref_text=None, pad_to_seconds=None):
        assert ref_audio.sample_rate == 24000
        return prompt

    model.create_voice_clone_prompt = fake_create
    http = srv.serve(model, host="127.0.0.1", port=0, max_batch=2, batch_window_ms=10)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{http.server_address[1]}"
    try:
        payload = {"audio_b64": base64.b64encode(_wav()).decode(), "ref_text": "reference words"}
        _, _, body = _post(base, payload, "/v1/voices")
        out = json.loads(body)
        assert out["icl"] is True and out["ref_seconds"] == 1.0
        vid = out["voice_id"]
        with urllib.request.urlopen(base + "/v1/voices") as resp:
            assert vid in json.loads(resp.read())["voices"]
        status, _, body = _post(base, {"text": "cloned speech", "voice_id": vid, "seed": 4, "max_frames": 6})
        assert status == 200 and body[:4] == b"RIFF"
        status, _, body = _post(base, {"text": "designed speech", "instruct": "a warm voice", "seed": 4,
                                       "max_frames": 6})
        assert status == 200 and body[:4] == b"RIFF"
        # unknown voice_id -> 400; voice_id + instruct -> 400
        for bad in ({"text": "x", "voice_id": "nope"}, {"text": "x", "voice_id": vid, "instruct": "y"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, bad)
            assert e.value.code == 400
    finally:
        http.shutdown()


def test_voice_registry_conflict_without_encoder():
    """Registration on a model without a speaker encoder is refused: 409
    (no encoder) or 400 (the empty WAV)."""
    http = srv.serve(tiny_model(), host="127.0.0.1", port=0)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    try:
        for audio, code in ((b"", 400), (_wav(0.5), 409)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"http://127.0.0.1:{http.server_address[1]}", {"audio_b64": base64.b64encode(audio).decode()},
                      "/v1/voices")
            assert e.value.code == code
    finally:
        http.shutdown()


def test_main_resolves_device_as_the_cli(monkeypatch, tmp_path):
    """``--device`` goes through ``parse_device``: ``cuda`` without a card
    raises before anything loads; ``cpu`` loads the checkpoint on the CPU
    with the flags passed through, and serves it."""
    from scripts.make_synthetic_ckpt import write_ckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.main(["--model-dir", str(tmp_path), "--device", "cuda"])
    write_ckpt(tmp_path)
    served = {}

    class Stub:
        def serve_forever(self):
            served["forever"] = True

    def fake_serve(model, host, port, max_batch, batch_window_ms, stream_window_ms):
        served.update(model=model, args=(host, port, max_batch, batch_window_ms, stream_window_ms))
        return Stub()

    monkeypatch.setattr(srv, "serve", fake_serve)
    srv.main(["--model-dir", str(tmp_path), "--device", "cpu", "--int8", "--w8a8", "--port", "0", "--max-batch", "3",
              "--batch-window-ms", "12", "--stream-window-ms", "0"])
    model = served["model"]
    assert served["forever"] and served["args"] == ("127.0.0.1", 0, 3, 12.0, 0.0)
    assert model.device == torch.device("cpu") and model.w8a8
    assert model.talker_params["layers"]["qkv_proj"]["q8"].dtype == torch.int8


def test_worker_runs_without_grad():
    """The worker thread's calls run with grad off (grad mode is
    thread-local)."""
    model = tiny_model()
    seen = []
    real = model.synthesize_with_voice

    def spy(*a, **k):
        seen.append(torch.is_grad_enabled())
        return real(*a, **k)

    model.synthesize_with_voice = spy
    engine = srv.BatchingEngine(model, max_batch=1, batch_window_ms=1)
    req = engine.submit(srv._Request("grad", "ryan", "english", SynthesisOptions(max_length=2, seed=1)))
    assert req.error is None and seen == [False]
