"""End-to-end synthesis times on the card, for comparing two checkouts.

    python3 qwen3_tts_tpu_torch/synthesis_timing.py [--root DIR] [--tag NAME] [--repeats R] [--cells C,...]

Builds the 1.7B CustomVoice model of the checkout at ``--root`` (default:
the one that holds this file) from random weights (seed 0) in bf16, then
the int8 model quantized from the same trees, as ``chip_smoke.py`` builds
them, and times each one's ``synthesize_with_voice`` and
``synthesize_with_timing`` on ``chip_smoke.py``'s utterance (a fixed
13-token prompt, 125 frames forced, seed 42): one warm call of each, then
``--repeats`` rounds of one call of each. Prints one JSON object a timed
call: its wall time (the call, audio on the host), RTF and, for the staged
call, its stages (ms a frame of generation). Run it on two checkouts in one
machine session (parent, change, change, parent) to compare them on one
card. ``--cells`` picks the models (default ``bf16,int8``); the cell
``int8-cp-i2816`` is the same 1.7B int8 model with a code predictor of
intermediate 2816 (not a multiple of its hidden 1024, so the JAX gates send
it to the "layer_steps" route: kernels 5 + 6, 70 calls each a frame), whose
staged calls also give the route's per-step calls' time by CUDA events
(``step_ms_per_frame``: every ``run_fused_decode_step`` of the call, summed,
over the frames). The batch cells (``chip_smoke.py`` phase ``batch``'s
runs): ``batch8-bf16`` and ``batch8-int8`` time ``synthesize_batch`` of
``BATCH_TEXTS`` (8 texts of different lengths, one token a word) at B = 1,
4 and 8 (prefill, the batched loop's ms a frame, decode, aggregate and
per-stream RTF, frames a second, peak memory); ``stream-batch8-bf16``
times ``synthesize_streaming_batch`` of the 8 texts (4 frames, then 10 a
chunk: each stream's TTFA, each round's time). ``profile-batch8-bf16``
runs ``PROFILE_FRAMES`` frames of the B = 8 bf16 batched loop under
``torch.profiler`` (``profile_batch``: device kernels a frame, the device's
busy share of the loop's wall time, the host ops that cost the most); run
it in a process of its own, as the profiler's later sessions in one
process may record no device activity. ``server-mixed-bf16`` serves the
bf16 model over HTTP (``server.serve`` on 127.0.0.1, a free port, in a
thread of this process) and times ``mixed_load`` (``chip_smoke.py`` phase
``server``'s step 4): one long solo stream, and ``SERVER_REQUESTS`` short
requests posted at once after its first audio; each request's latency,
p50 / p95, the stream's TTFA and its gaps between chunks.
``stream-bf16`` pulls ``synthesize_streaming`` of the utterance chunk by
chunk (4 frames, then 10 a chunk) at ``streaming_lookahead`` 0 and 1, in
turns (0, 1, 1, 0), with a consumer that holds each chunk 0 or
``STREAM_CONSUMER_MS`` ms before it asks for the next (a player, a socket):
TTFA, the time the consumer waits for each later chunk, the wall time.
``loop-sweep-bf16`` sets ``generation.core.DONE_READ_EVERY`` (N) to each
of ``LOOP_SWEEP``, forward then backward: the staged ms a frame, the
streamed TTFA at lookahead 0 and 1, and the frozen iterations that a loop
call runs past EOS (the utterance with its EOS id set to a token that first
appears at frame ``SWEEP_EOS_FROM`` or later). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import torch

FRAMES = 125
TEXT = "The quick brown fox jumps over the lazy dog near the river bank today."


class BenchTokenizer:
    """Fixed 13-token prompt (``chip_smoke.py``'s)."""

    def encode(self, text):
        return [200 + (i * 37) % 1000 for i in range(13)]


# Eight texts of different lengths (5 to 19 words: tokens, under WordTokenizer).
BATCH_TEXTS = (
    "Good morning, and welcome aboard.",
    "Please keep your seat belt fastened while seated.",
    "The library closes at nine tonight.",
    "Our next stop is the central station, change here for the airport line.",
    "Thank you for calling; every one of our agents is busy right now, please hold.",
    "It will rain later.",
    "Turn left at the second light, then follow the river for about two miles.",
    "Your order has shipped and should arrive on Thursday.",
)
BATCH_SIZES = (1, 4, 8)
PROFILE_FRAMES = 8
# The server's requests: SERVER_FRAMES frames (max_frames) each, and a
# SERVER_STREAM_FRAMES-frame stream under the mixed load.
SERVER_FRAMES = 32
SERVER_REQUESTS = 8
SERVER_STREAM_FRAMES = 96
WAV_HEADER_BYTES = 44
STREAM_CONSUMER_MS = 20
LOOP_SWEEP = (1, 2, 3, 4, 6, 8, 12)
SWEEP_EOS_FROM = 40


class WordTokenizer:
    """One token a word, so that the batch's texts differ in length."""

    def encode(self, text):
        return [200 + (sum(map(ord, w)) * 37) % 1000 for w in text.split()]


def batch_options():
    """The batch cells' options: ``FRAMES`` frames forced, seed 42 (stream i
    seed 42 + i), temperature 0.9."""
    from qwen3_tts_tpu_torch.pipeline import SynthesisOptions

    return SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9)


def time_batch(model, b: int) -> tuple[list, dict]:
    """One timed ``synthesize_batch_with_timing`` of the first ``b`` of
    ``BATCH_TEXTS`` (peak memory reset just before it); returns (audio, the
    numbers): wall, prefill, the batched loop's ms a frame, decode, RTF per
    stream (wall / one stream's seconds of audio) and aggregate (wall / all
    B streams' seconds), frames a second over the loop, peak allocated."""
    from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio, timing = model.synthesize_batch_with_timing(list(BATCH_TEXTS[:b]), options=batch_options())
    wall = time.perf_counter() - t0
    seconds = [len(a.samples) / OUTPUT_SAMPLE_RATE for a in audio]
    return audio, {
        "b": b, "wall_ms": wall * 1e3, "prefill_ms": timing.prefill_ms,
        "ms_per_frame": timing.generation_ms / timing.generation_frames, "frames": timing.generation_frames,
        "decode_ms": timing.decode_ms, "rtf_per_stream": wall / max(seconds), "rtf_aggregate": wall / sum(seconds),
        "frames_per_s": b * timing.generation_frames / (timing.generation_ms / 1e3),
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
    }


def time_stream_batch(model, b: int) -> tuple[list, dict]:
    """One timed ``synthesize_streaming_batch`` of the first ``b`` texts
    (4 frames, then 10 a chunk), pulled round by round; returns (each
    stream's chunks, the numbers): each stream's TTFA (the call until its
    first samples are on the host), each round's time, wall, aggregate RTF."""
    from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = model.synthesize_streaming_batch(list(BATCH_TEXTS[:b]), options=batch_options())
    chunks, at, ttfa = [[] for _ in range(b)], [], [None] * b
    for rnd in session:
        now = time.perf_counter()
        at.append(now)
        for i, c in enumerate(rnd):
            if c is not None and len(c.samples):
                chunks[i].append(c.samples)
                if ttfa[i] is None:
                    ttfa[i] = (now - t0) * 1e3
    wall = at[-1] - t0
    seconds = sum(sum(len(c) for c in cs) for cs in chunks) / OUTPUT_SAMPLE_RATE
    return chunks, {"b": b, "ttfa_ms": ttfa, "round_ms": [(y - x) * 1e3 for x, y in zip([t0] + at, at)],
                    "wall_ms": wall * 1e3, "rtf_aggregate": wall / seconds}


def profile_batch(model, b: int, frames: int = PROFILE_FRAMES) -> dict:
    """``frames`` frames of the batched loop of the first ``b`` texts (one
    warm run, one unprofiled run, then one under ``torch.profiler``). Returns
    ms a frame unprofiled and profiled; device kernels and copies a frame;
    the device's busy time a frame (the union of its activity's spans) and
    its share of the profiled loop's wall time (None where the profiler
    records no device activity); and the 10 host ops with the most CPU time
    of their own, with their calls and ms a frame."""
    from torch.profiler import ProfilerActivity, profile

    opts = replace(batch_options(), max_length=frames, min_new_tokens=frames)
    texts, speakers, instructs = list(BATCH_TEXTS[:b]), ["ryan"] * b, [None] * b

    def group():
        kind = model._split_batch_groups(speakers, instructs)[0][0]
        g = model._prepare_batch_group(kind, texts, speakers, ["english"] * b, instructs, opts, [42 + i for i in range(b)])
        torch.cuda.synchronize()
        return g

    def loop(g) -> float:
        t0 = time.perf_counter()
        model._generate_batch_group(g)  # ends in a device-to-host copy of the frames
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    loop(group())
    plain_ms = loop(group())
    g = group()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = loop(g)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in device)
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total, reverse=True)[:10]
    return {
        "b": b, "frames": frames, "ms_per_frame": plain_ms / frames, "profiled_ms_per_frame": wall_ms / frames,
        "kernels_per_frame": (len(device) - copies) / frames if device else None,
        "copies_per_frame": copies / frames if device else None,
        "device_busy_ms_per_frame": busy_us / 1e3 / frames if device else None,
        "busy_share": busy_us / 1e3 / wall_ms if device else None,
        "host_top": [[a.key, a.count / frames, a.self_cpu_time_total / 1e3 / frames] for a in host],
    }


def server_payload(i: int, frames: int = SERVER_FRAMES, **extra) -> dict:
    """Request i: the i-th of ``BATCH_TEXTS`` (cycled), seed 42 + i,
    ``frames`` frames at most."""
    return {"text": BATCH_TEXTS[i % len(BATCH_TEXTS)], "seed": 42 + i, "max_frames": frames, **extra}


def http_post(base: tuple, payload: dict, path: str = "/v1/synthesize") -> dict:
    """POST ``payload`` to the server at ``base`` (host, port); returns the
    status, the body's length and the latency (the request until the whole
    body is read), with its start and end on ``time.perf_counter``."""
    conn = http.client.HTTPConnection(*base, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(payload), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        t1 = time.perf_counter()
    finally:
        conn.close()
    return {"status": resp.status, "bytes": len(body), "ms": (t1 - t0) * 1e3, "start": t0, "end": t1}


def http_stream(base: tuple, payload: dict, first_audio: threading.Event | None = None) -> dict:
    """POST ``payload`` to ``/v1/synthesize_streaming`` and read the chunked
    body as it arrives: TTFA (the request until the first PCM bytes past the
    WAV header), the arrival time of each read that brought audio (on
    ``time.perf_counter``), the body's length and the whole latency.
    ``first_audio`` is set when the first audio arrives."""
    conn = http.client.HTTPConnection(*base, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/synthesize_streaming", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        got, arrivals = 0, []
        while data := resp.read1(1 << 20):
            got += len(data)
            if got > WAV_HEADER_BYTES:
                arrivals.append(time.perf_counter())
                if first_audio is not None:
                    first_audio.set()
        t1 = time.perf_counter()
    finally:
        conn.close()
    ttfa = (arrivals[0] - t0) * 1e3 if arrivals else None
    return {"status": resp.status, "bytes": got, "ms": (t1 - t0) * 1e3, "ttfa_ms": ttfa, "arrivals": arrivals,
            "gaps_ms": [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])], "start": t0, "end": t1}


def concurrently(fn, items: list) -> list:
    """``fn(item)`` for every item, each in a thread of its own, all started
    together; the results in the items' order."""
    out = [None] * len(items)

    def run(i):
        out[i] = fn(items[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(t.is_alive() for t in threads) or any(r is None for r in out):
        raise RuntimeError("a request did not complete")
    return out


def p50_p95(ms: list) -> tuple[float, float]:
    import numpy as np

    return float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def mixed_load(base: tuple, n: int = SERVER_REQUESTS, frames: int = SERVER_FRAMES,
               stream_frames: int = SERVER_STREAM_FRAMES) -> dict:
    """One long solo stream (``stream_frames`` frames, 4 then 10 a chunk),
    and ``n`` short requests (``frames`` frames each) posted at once as soon
    as the stream's first audio arrives. Returns every response, the short
    requests' latencies with p50 / p95, the stream's TTFA and chunk gaps,
    and how many of its chunks arrived before the first short response and
    after the last one."""
    first = threading.Event()
    stream: dict = {}

    def run_stream():
        stream.update(http_stream(base, server_payload(n, stream_frames), first))

    th = threading.Thread(target=run_stream)
    th.start()
    if not first.wait(600):
        raise RuntimeError("the stream's first audio did not arrive")
    short = concurrently(lambda i: http_post(base, server_payload(i, frames)), list(range(n)))
    th.join(900)
    if th.is_alive() or not stream:
        raise RuntimeError("the stream did not complete")
    ms = [r["ms"] for r in short]
    p50, p95 = p50_p95(ms)
    first_done, last_done = min(r["end"] for r in short), max(r["end"] for r in short)
    return {"short": short, "stream": stream, "ms": ms, "p50_ms": p50, "p95_ms": p95,
            "stream_ttfa_ms": stream["ttfa_ms"], "stream_gaps_ms": stream["gaps_ms"],
            "stream_chunks_before": sum(t < first_done for t in stream["arrivals"]),
            "stream_chunks_after": sum(t > last_done for t in stream["arrivals"])}


def server_mixed_lines(model, tag: str, repeats: int):
    """``mixed_load`` on ``model`` behind ``server.serve`` (default windows,
    max batch ``SERVER_REQUESTS``): one warm run, then ``repeats``; one JSON
    object a run."""
    from qwen3_tts_tpu_torch import server

    http = server.serve(model, "127.0.0.1", 0, max_batch=SERVER_REQUESTS)
    th = threading.Thread(target=http.serve_forever, daemon=True)
    th.start()
    try:
        mixed_load(http.server_address)
        for i in range(repeats):
            r = mixed_load(http.server_address)
            yield {"tag": tag, "form": "bf16", "call": "server_mixed", "round": i,
                   **{k: v for k, v in r.items() if k not in ("short", "stream")},
                   "statuses": [x["status"] for x in r["short"]] + [r["stream"]["status"]]}
    finally:
        http.shutdown()
        http.server_close()


class StepSpans:
    """CUDA events around every ``fused_layer.run_fused_decode_step`` call
    while it is entered (the code predictor calls it through the module)."""

    def __init__(self):
        from qwen3_tts_tpu_torch.ops import fused_layer

        self.module, self.spans = fused_layer, []
        self.routed = fused_layer.run_fused_decode_step

    def __enter__(self):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = self.routed(*args, **kwargs)
            end.record()
            self.spans.append((start, end))
            return y

        self.module.run_fused_decode_step = timed
        return self

    def __exit__(self, *exc):
        self.module.run_fused_decode_step = self.routed

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.spans)


def timed_calls(model, form: str, tag: str, repeats: int, calls_of: tuple = ("synthesize_with_voice",
                                                                              "synthesize_with_timing")):
    """One JSON line a timed call of ``model``."""
    from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE
    from qwen3_tts_tpu_torch.pipeline import SynthesisOptions

    opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9)
    calls = {
        "synthesize_with_voice": lambda: (model.synthesize_with_voice(TEXT, "ryan", "english", opts), None),
        "synthesize_with_timing": lambda: model.synthesize_with_timing(TEXT, "ryan", "english", opts),
    }
    calls = {name: calls[name] for name in calls_of}
    for call in calls.values():
        call()
    for i in range(repeats):
        for name, call in calls.items():
            torch.cuda.synchronize()
            with StepSpans() as steps:
                t0 = time.perf_counter()
                audio, timing = call()
                wall = time.perf_counter() - t0
            line = {"tag": tag, "form": form, "call": name, "round": i, "wall_ms": wall * 1e3,
                    "rtf": wall / (len(audio.samples) / OUTPUT_SAMPLE_RATE)}
            if timing is not None:
                line.update(prefill_ms=timing.prefill_ms, ms_per_frame=timing.generation_ms / timing.generation_frames,
                            decode_ms=timing.decode_ms)
                if steps.spans:
                    line.update(step_calls=len(steps.spans), step_ms_per_frame=steps.ms() / timing.generation_frames)
            yield line


def main_options(**kw):
    """The utterance's options: ``FRAMES`` frames forced, seed 42."""
    from qwen3_tts_tpu_torch.pipeline import SynthesisOptions

    return SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9, **kw)


def time_stream(model, lookahead: int, consumer_ms: float = 0.0) -> dict:
    """One ``synthesize_streaming`` of the utterance at ``lookahead``, each
    chunk held ``consumer_ms`` before the next is asked for."""
    opts = main_options(streaming_lookahead=lookahead)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at = []
    for _ in model.synthesize_streaming(TEXT, "ryan", "english", opts):
        at.append(time.perf_counter())
        time.sleep(consumer_ms / 1e3)
    waits = sorted((b - a) * 1e3 - consumer_ms for a, b in zip(at, at[1:]))
    return {"lookahead": lookahead, "consumer_ms": consumer_ms, "chunks": len(at), "ttfa_ms": (at[0] - t0) * 1e3,
            "wait_ms_median": waits[len(waits) // 2], "wait_ms_max": waits[-1], "wall_ms": (at[-1] - t0) * 1e3}


def stream_lines(model, tag: str, repeats: int):
    """The ``stream-bf16`` cell: one warm stream at each lookahead, then
    ``repeats`` rounds of (0, 1, 1, 0) at each consumer time."""
    for k in (0, 1):
        time_stream(model, k)
    for i in range(repeats):
        for consumer_ms in (0, STREAM_CONSUMER_MS):
            for k in (0, 1, 1, 0):
                yield {"tag": tag, "form": "bf16", "call": "synthesize_streaming", "round": i,
                       **time_stream(model, k, consumer_ms)}


def loop_sweep_lines(model, tag: str, repeats: int):
    """The ``loop-sweep-bf16`` cell: one JSON object an N a turn."""
    from qwen3_tts_tpu_torch.generation import core

    tokens = model._custom_voice_session(TEXT, "ryan", "english", main_options()).run_to_completion()[:, 0]
    at = next(i for i in range(SWEEP_EOS_FROM, len(tokens)) if tokens[i] not in tokens[:i])
    eos_opts = replace(main_options(), min_new_tokens=2, eos_token_id=int(tokens[at]))
    chosen = core.DONE_READ_EVERY
    try:
        for i in range(repeats):
            for n in LOOP_SWEEP + LOOP_SWEEP[::-1]:
                core.DONE_READ_EVERY = n
                _, timing = model.synthesize_with_timing(TEXT, "ryan", "english", main_options())
                ttfa = [time_stream(model, k)["ttfa_ms"] for k in (0, 1)]
                session = model._custom_voice_session(TEXT, "ryan", "english", eos_opts)
                session._advance(FRAMES)
                yield {"tag": tag, "form": "bf16", "call": "loop_sweep", "round": i, "done_read_every": n,
                       "ms_per_frame": timing.generation_ms / timing.generation_frames, "ttfa_ms_lookahead0": ttfa[0],
                       "ttfa_ms_lookahead1": ttfa[1], "eos_at": at, "frames": session.frames_generated,
                       "past_eos": session.state.steps - session.frames_generated}
    finally:
        core.DONE_READ_EVERY = chosen


def batch_lines(model, form: str, tag: str, repeats: int, batch: bool, stream: bool):
    """The batch cells of ``model`` (a ``WordTokenizer`` set): one warm call,
    then ``repeats`` rounds of ``synthesize_batch`` at each of
    ``BATCH_SIZES`` (``batch``) and of the B = 8 streaming session
    (``stream``); one JSON object a timed call."""
    if batch:
        time_batch(model, BATCH_SIZES[-1])
        for i in range(repeats):
            for b in BATCH_SIZES:
                yield {"tag": tag, "form": form, "call": "synthesize_batch", "round": i, **time_batch(model, b)[1]}
    if stream:
        time_stream_batch(model, BATCH_SIZES[-1])
        for i in range(repeats):
            yield {"tag": tag, "form": form, "call": "synthesize_streaming_batch", "round": i,
                   **time_stream_batch(model, BATCH_SIZES[-1])[1]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose qwen3_tts_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name printed on every line (default: --root)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cells", default="bf16,int8", help="comma-separated: bf16, int8, int8-cp-i2816, batch8-bf16, "
                                                         "batch8-int8, stream-batch8-bf16, profile-batch8-bf16, "
                                                         "server-mixed-bf16, stream-bf16, loop-sweep-bf16")
    args = ap.parse_args()
    cells = args.cells.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("synthesis_timing: no CUDA device")
    sys.path[0] = str(args.root.resolve())  # in place of this file's directory
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.pipeline import Qwen3TTS

    tag = args.tag or str(args.root)
    build.build()
    dev = torch.device("cuda", 0)
    base = config_for_variant("1.7B", "custom_voice")
    bf16_cells = {"bf16", "batch8-bf16", "stream-batch8-bf16", "profile-batch8-bf16", "server-mixed-bf16",
                  "stream-bf16", "loop-sweep-bf16"}
    int8_cells = {"int8", "batch8-int8"}
    if set(cells) & (bf16_cells | int8_cells):
        model = Qwen3TTS.from_random(base, seed=0, device=dev)
        model.tokenizer = BenchTokenizer()
        if "bf16" in cells:
            for line in timed_calls(model, "bf16", tag, args.repeats):
                print(json.dumps(line), flush=True)
        if "stream-bf16" in cells:
            for line in stream_lines(model, tag, args.repeats):
                print(json.dumps(line), flush=True)
        if "loop-sweep-bf16" in cells:
            for line in loop_sweep_lines(model, tag, args.repeats):
                print(json.dumps(line), flush=True)
        model.tokenizer = WordTokenizer()
        if "profile-batch8-bf16" in cells:
            line = {"tag": tag, "form": "bf16", "call": "profile_batch", **profile_batch(model, BATCH_SIZES[-1])}
            print(json.dumps(line), flush=True)
        for line in batch_lines(model, "bf16", tag, args.repeats, "batch8-bf16" in cells,
                                "stream-batch8-bf16" in cells):
            print(json.dumps(line), flush=True)
        if "server-mixed-bf16" in cells:
            for line in server_mixed_lines(model, tag, args.repeats):
                print(json.dumps(line), flush=True)
        m8 = Qwen3TTS(model.config, model.talker_params, model.cp_params, model.vocoder_params, BenchTokenizer(),
                      quantize_int8=True)
        del model
        torch.cuda.empty_cache()
        if "int8" in cells:
            for line in timed_calls(m8, "int8", tag, args.repeats):
                print(json.dumps(line), flush=True)
        m8.tokenizer = WordTokenizer()
        for line in batch_lines(m8, "int8", tag, args.repeats, "batch8-int8" in cells, False):
            print(json.dumps(line), flush=True)
        del m8
        torch.cuda.empty_cache()
    if "int8-cp-i2816" in cells:
        cfg = replace(base, code_predictor=replace(base.code_predictor, intermediate_size=2816))
        model = Qwen3TTS.from_random(cfg, seed=0, device=dev, quantize_int8=True)
        model.tokenizer = BenchTokenizer()
        for line in timed_calls(model, "int8-cp-i2816", tag, args.repeats, ("synthesize_with_timing",)):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
