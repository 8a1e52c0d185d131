"""HTTP synthesis server with dynamic batching.

The port of ``qwen3_tts_tpu/server.py``: a stdlib HTTP server in front of
the pipeline on one CUDA card, with a micro-batching scheduler that
coalesces concurrent requests into one batched generation loop
(``Qwen3TTS.synthesize_batch``). Singleton requests go to the batch-1 entry
points (the whole-step kernels, growth tiers). Streaming sessions are
time-sliced at chunk granularity, so long streams round-robin with other
traffic instead of holding the device; streaming requests arriving within
the batch window coalesce into one batched streaming session
(``Qwen3TTS.synthesize_streaming_batch``). On an H100 the batched loop is
host-bound today and slower than batch 1 (``Qwen3TTS.synthesize_batch``'s
docstring gives the card's numbers), so coalesced requests wait longer
than solo ones until its frame body runs as a CUDA graph.

One worker thread makes every call on the card, on the device's default
stream (the model's kernel packs run on the stream of their first call),
under ``torch.no_grad``.

Endpoints
---------
POST /v1/synthesize   {"text": ..., "speaker": "ryan", "language": "english",
                       "seed": 42, "max_frames": 2048, ...} -> audio/wav
POST /v1/synthesize_streaming
                      same body (+ optional "chunk_frames") -> chunked
                      audio/wav: a streaming RIFF header followed by PCM16
                      audio, one HTTP chunk per generated audio chunk
                      (TTFA = first-chunk latency, not whole-utterance).
                      With the default sample-exact streaming decode the
                      reassembled PCM equals the non-streaming response.
POST /v1/voices       {"audio_b64": WAV bytes, "ref_text": optional} ->
                      {"voice_id": ...}: a clone voice, encoded once
GET  /healthz         liveness
GET  /v1/model        variant + capability report
GET  /v1/voices       registered voices

Run: python -m qwen3_tts_tpu_torch.server --model-dir CKPT [--port 8000]
     [--max-batch 8] [--batch-window-ms 30] [--int8 [--w8a8]]
     [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
import wave
from collections import deque
from dataclasses import dataclass, field, replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

logger = logging.getLogger("qwen3_tts_tpu_torch.server")


@dataclass
class _Request:
    """``speaker`` is a preset name OR a VoiceClonePrompt (x-vector / ICL
    cloning, e.g. a registered /v1/voices entry); ``instruct`` switches the
    request to voice-design."""

    text: str
    speaker: object  # str | VoiceClonePrompt
    language: str
    options: "SynthesisOptions"
    instruct: str | None = None
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: str | None = None


def _layout_kind(speaker, instruct) -> str:
    """Prompt-layout signature component (mirrors
    Qwen3TTS._split_batch_groups): requests only coalesce within one layout —
    ``basic`` (preset + x-vector clones share the 10-row prompt), ``icl``,
    or ``design``."""
    from .pipeline import VoiceClonePrompt

    if instruct is not None:
        return "design"
    if isinstance(speaker, VoiceClonePrompt) and speaker.ref_codes is not None and speaker.ref_text_ids is not None:
        return "icl"
    return "basic"


@dataclass
class _StreamRequest:
    """Streaming synthesis job: the engine worker drives the session and
    pushes each audio chunk (np.ndarray float32) into ``chunks``; ``None``
    terminates the stream; an ``Exception`` reports failure.

    Sessions are time-sliced: the worker generates ONE chunk per visit and
    re-enqueues the job, so a long stream round-robins with batch jobs and
    other streams instead of holding the device for its whole duration.
    """

    text: str
    speaker: object  # str | VoiceClonePrompt
    language: str
    options: "SynthesisOptions"
    instruct: str | None = None
    chunks: queue.Queue = field(default_factory=queue.Queue)
    # Worker-private session state (created on the first slice).
    _iter: object | None = None


@dataclass
class _StreamGroup:
    """Streaming requests coalesced into ONE batched session.

    Fresh streaming requests arriving within the stream window (with
    matching stream signatures) share a ``StreamingBatchSession``: every
    time slice advances ALL member streams by one chunk through one batched
    loop, each projection reading its weights once for all of them. The
    group time-slices and re-enqueues itself exactly like a solo stream.
    Per-request ``max_length`` is enforced host-side (the shared session
    runs to the max; each stream's surplus frames are trimmed — exact,
    since frames are emitted in order).
    """

    reqs: list[_StreamRequest]
    frames_pushed: list[int]
    alive: list[bool]
    session: object | None = None


def _seeds(reqs: list) -> list[int]:
    """Each request's seed; unseeded requests draw time entropy (distinct
    per call), matching the single-stream unseeded path."""
    return [r.options.seed if r.options.seed is not None else (time.time_ns() + i) % (1 << 63)
            for i, r in enumerate(reqs)]


class BatchingEngine:
    """Coalesces concurrent requests into batched calls on the card.

    Requests arriving within ``batch_window_ms`` of each other (same
    speaker-independent options signature) run as one batched generation;
    singleton requests fall through to the single-stream path.
    """

    def __init__(self, model, max_batch: int = 8, batch_window_ms: float = 30.0,
                 stream_window_ms: float | None = None):
        self.model = model
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        # Fresh streams wait this long for peers to coalesce into one batched
        # session. It is a deliberate TTFA tax on sparse solo traffic (a solo
        # stream's prefill starts stream_window_ms late when no peer ever
        # arrives); operators serving mostly-solo streams can set it to 0 to
        # disable coalescing entirely. Defaults to the batch window.
        self.stream_window_s = self.batch_window_s if stream_window_ms is None else stream_window_ms / 1e3
        self.queue: queue.Queue = queue.Queue()
        # Items popped while collecting a group but belonging to a different
        # group run FIRST on the next _collect visit (before anything still in
        # the queue), preserving their FIFO position instead of sending them
        # to the tail behind later arrivals.
        self._deferred: deque = deque()
        # Registered clone voices: voice_id -> VoiceClonePrompt. Reference
        # audio is encoded ONCE at registration (x-vector + optional ICL
        # codes); synthesis requests then pass "voice_id" and coalesce like
        # any other traffic.
        self.voices: dict[str, object] = {}
        self._voices_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def register_voice(self, ref_audio, ref_text: str | None = None) -> str:
        """Encode reference audio into a reusable VoiceClonePrompt; returns
        its voice_id."""
        import uuid

        with torch.no_grad():
            prompt = self.model.create_voice_clone_prompt(ref_audio, ref_text)
        voice_id = uuid.uuid4().hex[:12]
        with self._voices_lock:
            self.voices[voice_id] = prompt
        return voice_id

    def get_voice(self, voice_id: str):
        with self._voices_lock:
            return self.voices.get(voice_id)

    def submit(self, req: _Request, timeout: float = 300.0) -> _Request:
        self.queue.put(req)
        if not req.done.wait(timeout):
            req.error = "synthesis timeout"
        return req

    @staticmethod
    def _options_signature(r: _Request) -> tuple:
        """Fields that must match for requests to share one batched loop.

        Everything except seed (per-stream) and max_length (the batch takes
        the max; per-stream EOS and frame limits are exact) — plus the
        prompt-layout kind: clone (ICL) and voice-design requests coalesce
        with their own kind only, never with preset/x-vector traffic (one
        loop per layout; ICL sampling overrides must not leak onto non-ICL
        streams).
        """
        o = r.options
        return (
            _layout_kind(r.speaker, r.instruct),
            o.temperature,
            o.top_k,
            o.top_p,
            o.repetition_penalty,
            o.eos_token_id,
            o.min_new_tokens,
            o.icl_sequential,
        )

    def submit_stream(self, req: _StreamRequest) -> _StreamRequest:
        """Enqueue a streaming job; chunks arrive on ``req.chunks``."""
        self.queue.put(req)
        return req

    @staticmethod
    def _stream_signature(r: _StreamRequest) -> tuple:
        """Fields that must match for streams to share one batched session:
        the sampling signature plus the chunk cadence (all streams in a
        group advance together)."""
        o = r.options
        return BatchingEngine._options_signature(r) + (
            o.chunk_frames,
            o.first_chunk_frames,
            o.streaming_exact,
            o.streaming_lookahead,
        )

    def _collect(self) -> list[list]:
        """Gather up to max_batch requests within the window, grouped by
        options signature so no request runs with another's sampling params."""
        first = self._deferred.popleft() if self._deferred else self.queue.get()
        # A re-enqueued stream group runs one slice per visit.
        if isinstance(first, _StreamGroup):
            return [[first]]
        # Streaming jobs: a FRESH request waits out the stream window for
        # peers to coalesce into one batched session (costs at most
        # stream_window_ms of TTFA when traffic is sparse — see __init__).
        # Mid-flight (re-enqueued) solo streams run one chunk per visit
        # (_run_stream_slice). Legacy (streaming_exact=False) requests never
        # coalesce: the batched session always runs the exact streaming
        # vocoder, so grouping a legacy request would change its audio
        # depending on whether a peer happened to arrive in the window.
        if isinstance(first, _StreamRequest):
            if (
                first._iter is not None
                or self.max_batch < 2
                or self.stream_window_s <= 0
                or not first.options.streaming_exact
            ):
                return [[first]]
            group = [first]
            sig = self._stream_signature(first)
            deadline = time.monotonic() + self.stream_window_s
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if isinstance(nxt, _StreamRequest) and nxt._iter is None and self._stream_signature(nxt) == sig:
                    group.append(nxt)
                else:
                    # Belongs to a different group: runs immediately after
                    # this one (FIFO position preserved via _deferred).
                    self._deferred.append(nxt)
                    break
            if len(group) == 1:
                return [[first]]
            return [[_StreamGroup(reqs=group, frames_pushed=[0] * len(group), alive=[True] * len(group))]]
        batch = [first]
        deadline = time.monotonic() + self.batch_window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if isinstance(nxt, (_StreamRequest, _StreamGroup)):
                # A stream job (solo or a re-enqueued mid-flight group) must
                # not join a non-streaming batch — it has no batch options
                # signature. It runs immediately after this batch (FIFO
                # position preserved via _deferred).
                self._deferred.append(nxt)
                break
            batch.append(nxt)
        groups: dict[tuple, list[_Request]] = {}
        for r in batch:
            groups.setdefault(self._options_signature(r), []).append(r)
        return list(groups.values())

    def _run(self):
        # Grad mode is thread-local: the entry points' decorators alone do
        # not cover this thread's own tensor work.
        with torch.no_grad():
            while True:
                for batch in self._collect():
                    self._run_one(batch)

    def _run_one(self, batch: list) -> None:
        if len(batch) == 1 and isinstance(batch[0], _StreamGroup):
            self._run_stream_group_slice(batch[0])
            return
        if len(batch) == 1 and isinstance(batch[0], _StreamRequest):
            self._run_stream_slice(batch[0])
            return
        try:
            if len(batch) == 1:
                r = batch[0]
                r.result = self._synthesize_solo(r).samples
            else:
                # Shared frame budget: the batched loop uses one bucket.
                max_len = max(r.options.max_length for r in batch)
                audios = self.model.synthesize_batch(
                    [r.text for r in batch],
                    [r.speaker for r in batch],
                    [r.language for r in batch],
                    replace(batch[0].options, max_length=max_len),
                    seeds=_seeds(batch),
                    instructs=[r.instruct for r in batch],
                )
                for r, audio in zip(batch, audios):
                    r.result = audio.samples
        except Exception as e:  # noqa: BLE001 — report to the caller
            logger.exception("synthesis failed")
            for r in batch:
                r.error = str(e)
        finally:
            for r in batch:
                r.done.set()

    def _synthesize_solo(self, r: _Request):
        """Singleton request on the single-stream path (whole-step kernels,
        growth tiers) — batching machinery never touches it."""
        kind = _layout_kind(r.speaker, r.instruct)
        if kind == "design":
            return self.model.synthesize_voice_design(r.text, r.instruct, r.language, r.options)
        if not isinstance(r.speaker, str):
            return self.model.synthesize_voice_clone(r.text, r.speaker, r.language, r.options)
        return self.model.synthesize_with_voice(r.text, r.speaker, r.language, r.options)

    def _open_solo_stream(self, req: _StreamRequest):
        kind = _layout_kind(req.speaker, req.instruct)
        if kind == "design":
            return self.model.synthesize_voice_design_streaming(req.text, req.instruct, req.language, req.options)
        if not isinstance(req.speaker, str):
            return self.model.synthesize_voice_clone_streaming(req.text, req.speaker, req.language, req.options)
        return self.model.synthesize_streaming(req.text, req.speaker, req.language, req.options)

    def _run_stream_slice(self, req: _StreamRequest) -> None:
        """Advance one streaming session by ONE chunk, then yield the device.

        The first slice pays prefill + the first chunk (TTFA unchanged vs a
        run-to-completion scheduler); afterwards the job re-enqueues at the
        queue tail, so concurrent streams and batch jobs interleave at chunk
        granularity instead of serializing behind whole sessions.
        """
        try:
            if req._iter is None:
                req._iter = iter(self._open_solo_stream(req))
            chunk = next(req._iter, None)
        except Exception as e:  # noqa: BLE001 — forward to the HTTP handler
            logger.exception("streaming synthesis failed")
            req.chunks.put(e)
            return
        if chunk is None:
            req.chunks.put(None)
            return
        req.chunks.put(np.asarray(chunk.samples))
        self.queue.put(req)

    def _run_stream_group_slice(self, grp: _StreamGroup) -> None:
        """Advance a batched streaming session by ONE chunk for all members.

        The first slice builds the ``StreamingBatchSession`` (batched prefill
        + first chunks = the group's TTFA); afterwards the group re-enqueues
        like a solo stream, so it round-robins with other traffic at chunk
        granularity. Each member's chunk is fanned out to its own HTTP
        response queue; members that hit EOS (or their own ``max_length``)
        are closed with ``None`` while the rest keep streaming.
        """
        from .models import tokens as T

        def close(i: int, item) -> None:
            if grp.alive[i]:
                grp.reqs[i].chunks.put(item)
                grp.alive[i] = False

        try:
            if grp.session is None:
                max_len = max(r.options.max_length for r in grp.reqs)
                grp.session = self.model.synthesize_streaming_batch(
                    [r.text for r in grp.reqs],
                    [r.speaker for r in grp.reqs],
                    [r.language for r in grp.reqs],
                    replace(grp.reqs[0].options, max_length=max_len),
                    seeds=_seeds(grp.reqs),
                    instructs=[r.instruct for r in grp.reqs],
                )
            chunks = grp.session.next_chunks()
        except Exception as e:  # noqa: BLE001 — forward to every live member
            logger.exception("batched streaming synthesis failed")
            for i in range(len(grp.reqs)):
                close(i, e)
            return
        if chunks is None:
            for i in range(len(grp.reqs)):
                close(i, None)
            return
        for i, (r, c) in enumerate(zip(grp.reqs, chunks)):
            if not grp.alive[i]:
                continue
            if c is not None:
                # Enforce THIS request's max_length (the shared session runs
                # to the group max; frames arrive in order, so the trim is
                # exact).
                room = r.options.max_length - grp.frames_pushed[i]
                take = min(len(c.samples) // T.SAMPLES_PER_FRAME, max(room, 0))
                if take > 0:
                    r.chunks.put(np.asarray(c.samples[: take * T.SAMPLES_PER_FRAME]))
                    grp.frames_pushed[i] += take
                if grp.frames_pushed[i] < r.options.max_length:
                    continue
            close(i, None)
        if any(grp.alive):
            self.queue.put(grp)


def _wav_stream_header(rate: int = 24000) -> bytes:
    """RIFF/WAVE header with unknown-length placeholders (0xFFFFFFFF) for
    chunked streaming — players and decoders read PCM to EOF."""
    import struct

    return (
        b"RIFF"
        + struct.pack("<I", 0xFFFFFFFF)
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
        + b"data"
        + struct.pack("<I", 0xFFFFFFFF)
    )


def _wav_bytes(samples: np.ndarray, rate: int = 24000) -> bytes:
    buf = io.BytesIO()
    pcm = (np.clip(samples, -1, 1) * 32767.0).astype(np.int16)
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def make_handler(engine: BatchingEngine, model):
    from .pipeline import SynthesisOptions

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked transfer

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s " + fmt, self.client_address[0], *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/voices":
                with engine._voices_lock:
                    voices = {vid: {"icl": p.ref_codes is not None} for vid, p in engine.voices.items()}
                self._json(200, {"voices": voices})
            elif self.path == "/v1/model":
                self._json(
                    200,
                    {
                        "variant": model.config.label,
                        "preset_speakers": model.supports_preset_speakers(),
                        "voice_cloning": model.supports_voice_cloning(),
                        "voice_design": model.supports_voice_design(),
                        "sample_rate": 24000,
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def _parse_synthesis_payload(self):
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            options = SynthesisOptions(
                max_length=int(payload.get("max_frames", 2048)),
                temperature=float(payload.get("temperature", 0.9)),
                top_k=int(payload.get("top_k", 50)),
                top_p=float(payload.get("top_p", 0.9)),
                repetition_penalty=float(payload.get("repetition_penalty", 1.05)),
                seed=payload.get("seed"),
                chunk_frames=int(payload.get("chunk_frames", 10)),
            )
            return payload, options

        def _resolve_voice(self, payload):
            """(speaker, instruct) from the payload: ``voice_id`` selects a
            registered clone voice, ``instruct`` switches to voice-design;
            plain ``speaker`` names a preset. Mutually exclusive."""
            voice_id = payload.get("voice_id")
            instruct = payload.get("instruct")
            if voice_id is not None and instruct is not None:
                raise ValueError("voice_id and instruct are mutually exclusive")
            if voice_id is not None:
                prompt = engine.get_voice(str(voice_id))
                if prompt is None:
                    raise KeyError(f"unknown voice_id {voice_id!r}")
                return prompt, None
            return str(payload.get("speaker", "ryan")), (str(instruct) if instruct is not None else None)

        def do_POST(self):
            if self.path == "/v1/synthesize":
                return self._post_synthesize()
            if self.path == "/v1/synthesize_streaming":
                return self._post_synthesize_streaming()
            if self.path == "/v1/voices":
                return self._post_voice()
            self._json(404, {"error": "not found"})

        def _post_voice(self):
            """Register a clone voice: {"audio_b64": <WAV bytes>, "ref_text":
            optional transcript (enables ICL cloning)} -> {"voice_id": ...}.
            The reference audio is encoded once; synthesis requests pass
            ``voice_id`` and coalesce with other clone traffic."""
            import base64

            from .audio.io import load_wav

            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                wav_bytes = base64.b64decode(payload["audio_b64"])
                ref_audio = load_wav(io.BytesIO(wav_bytes))
                ref_text = payload.get("ref_text")
            except (KeyError, ValueError, json.JSONDecodeError, EOFError, wave.Error) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                voice_id = engine.register_voice(ref_audio, str(ref_text) if ref_text is not None else None)
            except RuntimeError as e:  # no speaker/speech encoder loaded
                self._json(409, {"error": str(e)})
                return
            prompt = engine.get_voice(voice_id)
            self._json(200, {"voice_id": voice_id, "icl": prompt.ref_codes is not None,
                             "ref_seconds": ref_audio.duration})

        def _post_synthesize(self):
            try:
                payload, options = self._parse_synthesis_payload()
                speaker, instruct = self._resolve_voice(payload)
                req = _Request(
                    text=str(payload.get("text", "")),
                    speaker=speaker,
                    language=str(payload.get("language", "english")),
                    options=options,
                    instruct=instruct,
                )
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            engine.submit(req)
            if req.error:
                self._json(500, {"error": req.error})
                return
            wav = _wav_bytes(req.result)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            self.wfile.write(wav)

        def _write_http_chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _post_synthesize_streaming(self):
            """Chunked-transfer WAV: header + one PCM16 chunk per audio
            chunk as it comes off the card. With sample-exact streaming
            (SynthesisOptions default) the reassembled PCM is identical to
            the non-streaming endpoint's."""
            try:
                payload, options = self._parse_synthesis_payload()
                speaker, instruct = self._resolve_voice(payload)
                req = _StreamRequest(
                    text=str(payload.get("text", "")),
                    speaker=speaker,
                    language=str(payload.get("language", "english")),
                    options=options,
                    instruct=instruct,
                )
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            engine.submit_stream(req)
            first = req.chunks.get(timeout=300.0)
            if isinstance(first, Exception):
                self._json(500, {"error": str(first)})
                return

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._write_http_chunk(_wav_stream_header())
            chunk = first
            while chunk is not None:
                if isinstance(chunk, Exception):
                    break  # mid-stream failure: truncate the stream
                pcm = (np.clip(chunk, -1, 1) * 32767.0).astype("<i2")
                if len(pcm):  # a 0-length HTTP chunk would terminate the body
                    self._write_http_chunk(pcm.tobytes())
                chunk = req.chunks.get(timeout=300.0)
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def serve(model, host: str = "127.0.0.1", port: int = 8000, max_batch: int = 8, batch_window_ms: float = 30.0,
          stream_window_ms: float | None = None) -> ThreadingHTTPServer:
    """An HTTP server in front of ``model``, not yet started: call its
    ``serve_forever`` (``server_address[1]`` is the port; 0 picks a free
    one). The engine's worker thread starts here."""
    engine = BatchingEngine(model, max_batch, batch_window_ms, stream_window_ms)
    return ThreadingHTTPServer((host, port), make_handler(engine, model))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qwen3-tts-torch-server")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=30.0)
    ap.add_argument("--stream-window-ms", type=float, default=None,
                    help="How long a fresh streaming request waits for peers "
                         "to coalesce into one batched session (default: the "
                         "batch window). 0 disables stream coalescing and "
                         "removes the wait from solo-stream TTFA.")
    ap.add_argument("--w8a8", action="store_true",
                    help="With --int8: quantize activations per token and "
                         "run int8 x int8 products in BATCHED programs "
                         "(lossy; validate quality per checkpoint — solo "
                         "decode keeps weight-only int8)")
    ap.add_argument("--int8", action="store_true",
                    help="Weight-only int8: the W8A16 matmul and the int8 "
                         "whole-step kernels for single-stream requests; "
                         "batched requests take the W8A16 matmul at the "
                         "batch's rows")
    ap.add_argument("--device", default="cuda",
                    help="auto | cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.w8a8 and not args.int8:
        # The library's contract: Qwen3TTS raises ValueError for
        # int8_activations without quantize_int8; silently serving bf16
        # would mask the misconfiguration.
        ap.error("--w8a8 requires --int8")

    from .pipeline import Qwen3TTS
    from .utils.device import parse_device

    device = parse_device(args.device)
    logging.basicConfig(level=logging.INFO)
    model = Qwen3TTS.from_pretrained(args.model_dir, quantize_int8=args.int8, device=device,
                                     int8_activations=args.w8a8)
    logger.info("loaded %s on %s; serving on %s:%d", model.config.label, device, args.host, args.port)
    if args.w8a8:
        logger.info("w8a8 on: BATCHED programs quantize activations (int8 x int8); "
                    "coalesced output is not bit-identical to solo decode")
    server = serve(model, args.host, args.port, args.max_batch, args.batch_window_ms, args.stream_window_ms)
    server.serve_forever()


if __name__ == "__main__":
    main()
