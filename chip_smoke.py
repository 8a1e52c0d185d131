"""Smoke run of the PyTorch/CUDA port on one card: build, check, time, run.

Usage (from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit; phase ``tp`` spreads its meshes over every card there is):

    python3 chip_smoke.py

Phases, each printing a line (any failure exits nonzero before the last):
  1. card: name and power limit (nvidia-smi);
  2. build: every CUDA kernel from qwen3_tts_tpu_torch/csrc (one nvcc per
     source, all at once, into qwen3_tts_tpu_torch/_build/);
  3. kernel 1 (code-predictor frame, one persistent launch) against its
     plain version at the 1.7B code-predictor shapes on 32 random frames:
     f32 codes identical; bf16 (the main path's dtype) first codes equal in
     >= 28 of 32 frames and >= 50% of all codes equal; then the same 1.7B
     code predictor quantized to int8 (weight-only, bf16 activations), held
     to the bf16 bars; every form gives the same bits twice, and is timed
     per call from Python (host included) and by its device span (20
     frames in a CUDA graph); the device kernels one call launches, read
     with torch.profiler, must be 1; then the seeded 1.7B f32 code predictor
     of ``qwen3_tts_tpu_torch/cp_fixture.py`` must give the JAX package's
     codes (the committed fixture) token for token;
  4. kernel 2 (vocoder residual unit, a 3xTF32 implicit GEMM) against its
     plain version at C = 384/192/96 and dilations 1/3/9 over the time
     lengths of a 128-frame decode: within atol = 1e-5 * max|x|, the same
     bits twice, a prefix bit-identical; timed per call from Python and by
     its device span (CUDA graph), beside the plain version and the library
     yardstick (cuDNN's dilated conv plus one matmul, no snakes), and the 9
     calls' device span in one graph; then its stream entry
     (``residual_unit_stream``) over a streaming session's first chunks (4
     and 10 frames) and ``synthesize_with_voice``'s (64 and 64): the chunks
     bit-equal to one batch call (a difference is held to 1e-5 * max|x|),
     each against the plain version within 1e-5 * max|x|, each chunk size
     timed beside the plain version, the library yardstick and the 3xTF32
     bound; then the seeded full-width vocoder of
     ``qwen3_tts_tpu_torch/vocoder_fixture.py`` through ``decode_bucketed``
     on the card (kernel 2 launched 9 times) must give the JAX package's
     audio (the committed fixture) within 1e-5 and 1e-4 of max|audio|;
     then the two encoders of voice cloning at full width (the speaker
     encoder at enc_dim 2048, Mimi at its default config) on the seeded
     weights and 3 s references of ``qwen3_tts_tpu_torch/encoder_fixture.py``
     (24 kHz, and 16 kHz resampled on the host), in f32: x-vectors within
     1e-5 of max|x| and codes equal to the JAX package's (the committed
     fixture), each forward timed by CUDA events;
  5. kernel 3 (talker step, one persistent launch) against its plain
     version on the 1.7B talker in its three forms, each through the tree's
     pack, with caches of 160 and 2080 rows and 16 random (x, pos) each
     with pos near the top: quantized to int8 and plain bf16 (the int8 and
     bf16 main paths' forms; bf16 caches): the codec-head argmax equal in
     >= 14 of 16, hidden within HIDDEN_TOL of the plain version's scale,
     the written row within ROW_TOL, every other row bit-unchanged, each
     step the same bits twice; plain f32: argmax 16 of 16, hidden and
     written rows within F32_STEP_TOL, and the same against the eager
     layer path on the unfused talker (``talker.decode_step``); the kernel
     timed per call from Python and by its device span (20 steps in a CUDA
     graph), its device kernels per call (torch.profiler) must be 1, and
     its per-phase trace printed; plain version and layer path timed; then
     the seeded 1.7B-width f32 talker of
     ``qwen3_tts_tpu_torch/talker_fixture.py`` must give the JAX package's
     codec-head argmaxes (the committed fixture);
  6. kernel 4 (W8A16 matmul) against its plain version at the main path's
     shapes (prefill m = 10, codec head m = 1), m = 32, 64 and 1024, and
     the per-step code predictor's: within one bf16 ulp of the plain
     output's scale, the same bits twice; its device span (CUDA graph,
     weights cold in L2) and its time per call (host included), beside a
     bf16 matmul on the dequantized weight timed both ways; then its row
     invariance (``kernel4_row_invariance``): at the 1.7B talker's and code
     predictor's five shapes each, in bf16 and f32 x, the first m rows of a
     [1024, K] x at every m of ``INVARIANT_ROWS`` bit-equal to the same
     rows at m = 1024;
  7. kernels 5 and 6 (int8 attention and MLP sub-layer steps, one
     persistent launch a call) against their plain versions through a
     ``FusedStepPack`` of 5 layers (each trial the next layer) at the 1.7B
     code predictor's widths (17 cache rows, 16 random (x, pos),
     intermediate 2816 in bf16 and f32, the stock 3072 in bf16, residual)
     and at the 1.7B talker's 4-chip tensor-parallel shard (4 / 2 heads,
     intermediate 1536, 2080 cache rows, pos near the top, no residual):
     output and written row within STEP_TOL of the plain version's scale,
     every other row bit-unchanged (rows above pos hold NaN, which must not
     be read), every call the same bits twice; timed per call from Python
     and by the device span (20 calls in a CUDA graph, cycling through the 5
     layers); the device kernels one call of each launches (torch.profiler,
     in a process of its own) must be 1; then the seeded 1.7B code
     predictor at intermediate 2816 of ``qwen3_tts_tpu_torch/cp_fixture.py``
     in f32, kernels 5 + 6 per layer, must give the JAX package's outputs
     (the committed fixture) within STEP7_F32_TOL;
  8. kernel 7 (int8 code-predictor decode step, one persistent launch)
     against its plain version on the 1.7B int8 code predictor, through the
     tree's pack, bf16 and f32 (STEP_TRIALS random (x, pos)), with the same
     checks, the f32 bar beside a bf16-residual step it must reject, each
     step the same bits twice; timed per call from Python and by its device
     span (20 steps in a CUDA graph), its device kernels per call
     (torch.profiler, in a process of its own) must be 1, and its per-phase
     trace printed; then the seeded 1.7B int8 code-predictor layers of
     ``qwen3_tts_tpu_torch/cp_fixture.py`` in f32 must give the JAX
     package's step outputs (the committed fixture) within STEP7_F32_TOL;
     then kernel 7 at head_dim 256 (8 q / 4 KV heads, int8) in bf16 and
     f32 under the same bars, timed;
  9. the per-step path at full width: the 1.7B int8 code predictor on 32
     random frames through ``_predict_acoustic_codes_fused``, kernel 7 per
     step and kernels 5 + 6 per layer, each held to the same route on the
     plain versions by kernel 1's int8 bars, beside kernel 1's codes and
     time; then phase ``jacobi`` (``jacobi_phase``): the seeded 1.7B f32
     code predictor with ``decode_mode="jacobi"``, frame by frame and as
     one batch of 4, must give the JAX fixture's codes with kernel 1 never
     launched; the 1.7B bf16 and int8 and the 0.6B bf16 code predictors'
     Jacobi against kernel 1 on 32 random frames under kernel 1's bf16
     bars, the first 8 frames the same bits twice, the passes per frame,
     one pass's time per call and device span (a CUDA graph) and the
     break-even pass count (kernel 1's frame time over one pass's); kernel 4 at the no-cache
     stack's four shapes at 16 and 128 rows against its plain version (one
     bf16 ulp), timed beside ``torch.matmul``; then phase ``tiers``: the
     unfused 1.7B talker's layer-path ``decode_step`` on a 2624-row cache,
     ``decode_tiering`` on against off at 16 positions over every window
     (f32: argmax 16 of 16, hidden within F32_STEP_TOL; bf16 phase 5's
     bars), each window's step timed both ways, and three equal MRoPE
     streams bit-equal to plain positions on the card;
 10. end to end: a small f32 model on the card (kernel 3 on plain f32
     weights and kernel 1, each once a frame) against the same weights on
     the CPU's layer path (identical frames, close audio); a small model in
     int8 on
     the card against the CPU over 6 frames (first 2 frames equal, >= 90%
     of codes); two small int8 models whose code predictor the JAX gates
     send to the per-step path (kernels 5 + 6; kernel 7), under the same
     bars, launching their route's kernels and never kernel 1; then
     the 1.7B CustomVoice main path (``Qwen3TTS.from_random(
     config_for_variant("1.7B", "custom_voice"))``, the fixed 13-token
     prompt, 125 frames, seed 42, temperature 0.9): one warm run, then one
     timed run with the kernels' launch counts reset just before it, in
     which kernels 1 and 3 must launch once a frame (125 times; the talker
     fused on the card), kernel 2 9 times (its calls timed by CUDA events,
     which split decode into kernel 2's share and the rest), and the
     int8-path kernels must not; the timed run's audio
     must equal the warm run's bit for bit (same seed, deterministic
     kernels); then a 16-frame utterance with ``decode_mode="jacobi"`` on
     the same trees beside the sequential one (``jacobi_utterance``:
     ms/frame, RTF, passes per frame; kernel 1 never, kernel 3 once a
     frame, kernel 2 9 times, in int8 kernel 4 at 16 rows 20 times a pass)
     and, in bf16, the B = 8 batch loop with Jacobi beside the sequential
     batch (aggregate frames/s, each stream against its B = 1 run); then the same in int8 (``quantize_int8=True``
     on the same synthetic trees, as bench.py builds its int8 model), where
     all four int8-path kernels must launch; then two 1.7B int8 models whose
     code predictor takes the per-step path (vocab 2047: kernel 7;
     intermediate 2816: kernels 5 + 6 through the ``FusedStepPack`` the
     model holds, 70 launches of each a frame; each route's per-step calls
     timed by CUDA events), the same way. After each of the bf16 and
     int8 staged runs, the same utterance streamed
     (``synthesize_streaming``: 4 frames, then 10 a chunk; TTFA, chunk
     times, RTF) and through ``synthesize_with_voice``
     (``run_to_audio``, 64-frame chunks; wall time, RTF), each with the
     launch counts reset just before it: kernel 2's stream entry 9 times a
     chunk and its batch entry never, kernels 1 and 3 once a frame, the
     streamed frames those of a staged session, the audio within
     STREAM_SPREAD_FACTOR times the staged decode's own spread between
     buckets 64 and 256 (read in the run) of the staged decode; and in
     bf16 a 300-frame session whose buffers grow once (288 -> 544 cache
     rows) token for token against one that holds 544 rows from the start;
     then, after each of the bf16 and int8 models, the same trees as a Base
     checkpoint with the phase-4 encoders and as a VoiceDesign checkpoint
     (``clone_and_design``): ``create_voice_clone_prompt`` on the fixture's
     24 kHz reference, an x-vector clone (10 prompt rows), an ICL clone
     overlaid (73 rows) and sequential (105 rows), each whole and streamed,
     and a voice-design synthesis (41 rows): prompt rows, prefill ms,
     ms/frame, RTF; TTFA and chunk times streamed; launches with the counts
     reset just before each (kernels 1 and 3 once a frame, kernel 2's stream
     entry 9 times a vocoder call, the prefix's pieces included, kernel 4
     in int8); the frames of the whole runs equal the staged sessions',
     their audio and the streams' within ``STREAM_SPREAD_FACTOR`` x the
     staged decode's spread; in bf16 one fused talker step past kernel 3's
     gate (2656 cache rows) on the layer path against kernel 3 at 2624, and
     kernel 2's stream entry on the ICL prefix's pieces (2, 4, 32 frames;
     9 x 4 and 2), timed, then each unit against the plain version on the
     same inputs within 1e-5 * max|x| and its carry equal, and each piece's
     audio within 1e-5 of max|audio| of a stream on the plain units; in int8 kernel 4
     at the clone and design prompts' rows (m = 41, 73, 105) beside
     ``torch.matmul`` on the dequantized weight;
     then, after each of the bf16 and int8 models, phase ``batch``
     (``batch_main``): ``synthesize_batch`` of ``synthesis_timing.BATCH_TEXTS``
     (8 texts of different lengths, 125 frames forced, stream i seed 42 + i)
     at B = 1, 4 and 8, one warm call, then each timed with the launch counts
     reset just before it: prefill, the batched loop's ms/frame beside the
     staged batch-1 cell's, decode, aggregate and per-stream RTF, frames a
     second, peak memory; kernels 1 and 3 never launched (the batched loop
     is the layer path), kernel 2's batch entry 9 times (one decode for all
     streams), and in int8 kernel 4 at exactly the rows of
     ``kernel4_batch_rows`` (B in the loop, 2·B in the code predictor's
     prefill, 10·B in the talker's), none sent to the plain form by its
     gate; each stream's codes at B = 1 and 4 against its codes at B = 8
     (``batch_sizes_agree``: bit-equal in int8, reported in bf16); in bf16
     also the B = 8 codes against each stream's solo run
     (kernels 1 and 3; the share equal printed, not a gate), a bf16
     witness at full depth (``bf16_witness``: greedy CustomVoice and
     voice-design batches against each stream's B = 1 run through the same
     batched loop; the talker's hidden states within ``HIDDEN_TOL`` of
     their scale until the first differing code, and there both runs' top-2
     margins beside their logits' difference), 8 frames of the B = 8 loop
     under torch.profiler in a process of its own (``batch_profile``:
     device kernels a frame, the device's busy share, the costliest host
     ops), ``synthesize_streaming_batch`` at B = 8 (4 frames, then 10: each
     stream's TTFA and each round's time; kernel 2's stream entry 9 times a
     round; each stream's chunks within ``STREAM_SPREAD_FACTOR`` x the
     staged decode's bucket spread of its ``synthesize_batch`` audio), and
     kernel 2 across streams (``kernel2_batch``: the 9 units of the B = 8
     decode against their plain versions at [8, T, C], each stream alone
     bit-equal to its rows, timed with the bound; stream 0's own decode
     against its rows within the streaming batch's bar, 2 x the staged
     decode's bucket spread: the convolutions around the units run at
     another batch, which moves them as another bucket does); then kernel 4
     (phase ``kernel4-batch``) at every shape the B = 8 int8 batch gave it
     (the talker's and the code predictor's projections and heads at m = 8,
     the code predictor's prefill at 16, the talker's at 80), on the
     batch's own first input and weight of each shape; then phase
     ``server`` (``server_phase``, after the bf16 batch): the bf16 model
     (``st.WordTokenizer``, requests of ``st.SERVER_FRAMES`` frames) behind
     ``server.serve`` on 127.0.0.1 in threads, one server with the default
     windows and one with ``SERVER_WIDE_MS`` windows for the coalescing
     steps, each line with the card's name and power limit: (1) one solo
     request, its float result through the engine bit-equal to
     ``synthesize_with_voice`` of the same options, kernels 1 and 3 once a
     frame, kernel 2's stream entry 9 times a 64-frame chunk; HTTP latency
     beside the library call's; (2) 8 requests at once: one
     ``synthesize_batch`` of 8, each float result bit-equal to its row of
     the same call run directly; latencies, p50 / p95 and aggregate
     frames/s against the same 8 one after another; (3) 8 streaming
     requests at once: one ``StreamingBatchSession``, each stream's chunks
     within ``STREAM_SPREAD_FACTOR`` x the decode's bucket spread of its
     ``synthesize_batch`` audio; TTFA and HTTP chunk gaps; (4) mixed load
     (``st.mixed_load``): a long solo stream with 8 short requests posted
     at its first audio, every response complete, the stream time-sliced
     around them; p50 / p95 and the stream's TTFA and gaps; (6)
     ``TransferAudit`` over a staged batch-1 run and a B = 8 batch (the
     host reads, a record); and after the int8 batch (``server_w8a8``),
     step (5) on the int8 tree built with ``int8_activations=True``: a solo
     request launches kernel 4 and takes no w8a8 call; a coalesced batch of
     8 launches kernel 4 never and takes the w8a8 route, its audio finite
     and of its frames' length; the same batch run directly on it and on
     the weight-only int8 model (ms/frame, share of codes equal, not a
     gate), and ``w8a8_matmul`` on the card bit-equal to the CPU at every
     shape the batch gives it, on its own first input of each; then phase
     ``loop`` (``loop_phase``, after the bf16 server and after the int8
     batch), each line with the card's name and power limit: the
     staged run and a stream (32 frames; kernels 1 and 3, kernel 2's stream
     entry), a B = 8 batch and streaming batch (16 frames; kernel 2, kernel
     2's stream entry, kernel 4 in int8) with every frame between two of the
     loops' looks under ``torch.cuda.set_sync_debug_mode("error")``
     (``sync_free_loops``: a synchronising call fails the run); the host
     reads (``TransferAudit``) of a batch-1 loop call of 32 and 125 frames
     and a B = 8 call of 16, each within ceil(frames / N) + 2, and of a
     whole staged utterance; the frozen frames past EOS of a staged run
     whose EOS id is a token first drawn at frame 40 (at most 2N - 1, the
     frames before EOS those of the staged session, none after); the
     streamed utterance at ``streaming_lookahead`` 0 and 1 in turns (TTFA,
     gaps; every chunk bit-equal across the two); the staged batch-1
     ms/frame and phase ``batch``'s B = 8 frames/s beside them (the sweep
     of N is ``synthesis_timing.py --cells loop-sweep-bf16``);
 11. loading and the command line (phase ``ckpt``): a seeded 1.7B
     CustomVoice checkpoint in the HF layout (all 28 talker layers, bf16,
     the full-width vocoder f32; ``qwen3_tts_tpu_torch/ckpt_fixture.py``,
     drawn on the card by a ``torch.Generator``) with a byte-level
     ``vocab.json`` / ``merges.txt``, written to a temporary directory and
     timed; the safetensors reader on the card bit-equal to the tensors
     written (read time and rate, the file warm in the page cache);
     ``Qwen3TTS.from_pretrained`` timed, and every tree of the model it
     builds bit-equal to the port's key maps applied to the tensors in
     memory; then the CLI (``qwen3_tts_tpu_torch.cli.main``, in process)
     three times on it, 125 frames forced, seed 42: the default mode, then
     ``--streaming``, then ``--int8``, each with ``--dump-codes`` and the
     launch counts set to 0 as ``from_pretrained`` returns: the codes (the
     dumped file; under ``--streaming``, which dumps none, the session's
     frames) equal to the same model's ``synthesize_streaming(...).
     run_to_completion()``, kernels 1 and 3 once a frame, kernel 2's batch
     entry 9 times (its stream entry 9 times a chunk under
     ``--streaming``), kernel 4 under ``--int8`` only, kernels 5, 6 and 7
     never; the CLI's RTF printed; then, in the same directory, phase
     ``validation`` (``validation_phase``: the port's validation chain,
     ``qwen3_tts_tpu_torch/validation``): the quant report at full depth
     (worst-layer weight SNR, logit KL and flip rates for int8 and for w8a8,
     the promote decision; the int8 run launches kernels 1 and 3 once a step
     and kernel 4, the w8a8 run only ``w8a8_matmul``), the parity matrix at
     4 frames on this machine's dp = 2 x tp = 2 mesh (distinct cards where
     there are four, else ranks sharing ``cuda:0``: every cell passes but
     the int8 and w8a8 cross-placement ones, which are reported; kernels 5
     and 6 in the int8 mesh cells) and on the drill's tiny checkpoint
     (every cell passes), the quality gate on the CLI's WAV (the drill's gates), the
     audit (no read site outside the loop contract, the dynamic reads within
     ``loop_read_bound``), the w8a8 product at K = 2050, N = 3074 bit-equal
     to the CPU's ``torch._int_mm``, and the trace report of the CLI run
     with ``--profile`` in a process of its own (kernels 1, 2 and 3 among
     the top kernels, their ms a frame); the directory deleted;
 12. the 1.7B-width utterance (phase ``utterance``): the seeded checkpoint
     of ``ckpt_fixture.write_utterance_checkpoint`` (2 talker layers, drawn
     from numpy) loaded by ``from_pretrained`` in f32 on the card (kernels
     1 and 3 in their f32 forms, kernel 2 in 3xTF32), 24 frames forced,
     greedy and under seeded PCG sampling: frames token-exact and the audio
     within 1e-5 of max|audio| of the JAX package's (the committed fixture
     ``testdata/utterance_1p7b.npz``), the fixture's least top-2 margins
     printed beside the result; then, on the same model, phase ``batch``'s
     f32 checks: ``synthesize_batch`` of ``ckpt_fixture.BATCH_TEXTS``
     (greedy and PCG, 16 frames) against the JAX package's (the committed
     ``testdata/batch_1p7b.npz``: frames token-exact, each stream's audio
     within 1e-5 of its max|audio|; kernels 1 and 3 never, kernel 2 9
     times), and per-stream positions (a voice-design batch of 3 whose
     instructs differ in length, an ICL batch of 2 whose references differ,
     with the phase-4 encoders: each stream token-exact to its own B = 1
     run through the batched path, the least top-2 margins printed);
 13. multi-GPU serving (phase ``tp``), printing the card count, each mesh's
     devices and the collective it takes (NCCL between distinct cards, a
     local sum where the ranks share ``cuda:0``, as on a one-card machine):
     (a) phase ``utterance``'s checkpoint through ``from_pretrained(dtype=
     f32, mesh=make_mesh(devices, tp=4))``, greedy and PCG, token-exact to
     ``testdata/utterance_1p7b.npz`` with audio within 1e-5 of max|audio|
     (the talker on the tensor-parallel layer path, kernel 3 never); (c)
     the same f32 model sharded at dp = 3 x tp = 2 (``shard``),
     ``synthesize_batch`` of ``ckpt_fixture.BATCH_TEXTS`` (a stream a
     replica) held to ``testdata/batch_1p7b.npz`` as phase ``batch``'s; (b)
     the full-depth 1.7B int8 model at tp = 4 and 2, bf16 and f32, 32
     staged frames with the counts set to 0 just before: kernels 5 and 6 28
     x tp times a step each (``tp_decode_step``), kernel 3 never, kernel 1
     once a frame; 16 tp steps at random (x, pos) near the top of a
     2080-row cache, each kernel-5 / 6 call in them against its plain
     version (STEP_TOL, gated in bf16), the bf16 step within HIDDEN_TOL /
     ROW_TOL of the same route on the plain versions, the f32 step against
     the unsharded kernel-3 step by that step's own spread under a 2^-22
     change of the int8 scales (``tp_step_trials``); the frames' share of codes equal to the
     unsharded model's and the first differing frame's top-2 margin
     (reported); ms/frame beside the unsharded model's, the step's time by
     host clock and by CUDA events, one all-reduce's time, peak memory per
     device; (d) the same int8 trees in bf16 at dp = 2 x tp = 1, a batch of
     8 (4 a replica) for 16 frames (``tp_dp_batch``): the rounds alternate
     between the replicas, kernel 4 launches in each replica's frames on
     its own device, the lock-step loop's host reads within ceil(16 / N) +
     2, its frames bit-equal to the same replicas run one after another
     and every code equal to the unsharded B = 8 batch's, and first every
     op of replica 0's prefill and first frame, at dp = 2 and for the first
     streams alone at B = 1 and 4 (phase ``batch``'s caches), bit-equal to
     the same rows of the unsharded batch's
     (``replica0_records``, ``first_divergence``: the first op that
     differs and every op that differs from equal inputs are printed);
     ms/frame of the lock-step loop, of the replicas one after another and
     of the unsharded B = 8 batch, in this process;
 14. the script's wall time, a JSON line of the kernels (each with its
     launches on its main path, its time, its plain version's, the card's
     bound for the same work and, where one PyTorch call computes the same
     function, that call's time), then the JSON result as the last line.
"""

from __future__ import annotations

import contextlib
import difflib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import qwen3_tts_tpu_torch  # noqa: E402,F401  (sets the TF32 switches)
from qwen3_tts_tpu_torch import build, ckpt_fixture, cli, cp_fixture, encoder_fixture, talker_fixture  # noqa: E402
from qwen3_tts_tpu_torch import server, vocoder_fixture  # noqa: E402
from qwen3_tts_tpu_torch.audio.io import AudioBuffer  # noqa: E402
from qwen3_tts_tpu_torch.audio.resample import resample_to_24k  # noqa: E402
from qwen3_tts_tpu_torch.generation import batch as gbatch  # noqa: E402
from qwen3_tts_tpu_torch.generation import core, prefill  # noqa: E402
from qwen3_tts_tpu_torch import kernel_timing as kt  # noqa: E402
from qwen3_tts_tpu_torch import synthesis_timing as st  # noqa: E402
from qwen3_tts_tpu_torch.models import code_predictor as cp  # noqa: E402
from qwen3_tts_tpu_torch.models import speaker, talker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import blocks, fused_blocks  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import encoder as mimi_encoder  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import vocoder  # noqa: E402
from qwen3_tts_tpu_torch.models.codec.encoder import Encoder12Hz  # noqa: E402
from qwen3_tts_tpu_torch.models.config import (  # noqa: E402
    CodePredictorConfig,
    ModelConfig,
    ModelType,
    TalkerConfig,
    config_for_variant,
)
from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE, SAMPLES_PER_FRAME  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer, nn, quant, sampling  # noqa: E402
from qwen3_tts_tpu_torch.parallel import collectives, sharding  # noqa: E402
from qwen3_tts_tpu_torch.models.speaker import SpeakerEncoder  # noqa: E402
from qwen3_tts_tpu_torch.pipeline import (  # noqa: E402
    DECODE_BUCKET, Qwen3TTS, SynthesisOptions, VoiceClonePrompt, prefix_piece_sizes)
from qwen3_tts_tpu_torch.profiling import count_host_transfers  # noqa: E402
from qwen3_tts_tpu_torch.utils.bucketing import next_bucket  # noqa: E402
from qwen3_tts_tpu_torch.validation import (  # noqa: E402
    audit, launch_counts, launches_since, parity_matrix, quality, quant_report, trace_report)
from qwen3_tts_tpu_torch.validation.audit import loop_read_bound  # noqa: E402

DEV = torch.device("cuda", 0)
# The four projections (K, N) at 1.7B, qkv, o, gate|up, down: the code predictor's and the talker's.
CP_PROJ_SHAPES = ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024))
TALKER_PROJ_SHAPES = ((2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048))
FRAMES = 125
CP_FRAMES = 32
BF16_MIN_FIRST_EQUAL = 28  # of CP_FRAMES
BF16_MIN_SHARE_EQUAL = 0.5
TALKER_TRIALS = 16
TALKER_MIN_ARGMAX_EQUAL = 14  # of TALKER_TRIALS
# Kernel 3 against its plain version after 28 bf16 layers: sums in another
# order move bf16 roundings by an ulp here and there, and each layer
# carries them on. Bars relative to max|plain| of the compared tensor.
HIDDEN_TOL = 0.05
ROW_TOL = 0.05
# Kernel 3 on plain f32 weights after 28 layers, against its plain version
# and the eager layer path: the same rounding points, only f32 sums in
# another order (matmul inputs stay f32 on plain weights).
F32_STEP_TOL = 1e-4
# Kernels 5-7 against their plain versions, relative to max|plain| of the
# compared tensor. The int8 matmuls round their inputs to bf16 in f32
# programs too, so a sum in another order can flip an input's rounding by a
# bf16 ulp (2^-8) where a value sits near a rounding boundary (f32, one
# sub-layer: 1e-3); in bf16 any element may round one ulp the other way,
# which moves the rest of the step by a few ulps.
STEP_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
# Kernel 7 in f32 through 5 layers: the plain step itself moves ~4e-4 under
# a 2^-22 change of every scale, and such flips compound over the 5 layers
# (the kernel has read up to 3.0e-3 here); a step whose residual stream is
# rounded to bf16 reads at least 5.6e-3 (``bf16_residual_step``, which must
# fail the bar).
STEP7_F32_TOL = 4e-3
STEP_TRIALS = 16
# The 1.7B talker's per-chip shard on 4 chips (tp_decode_step's kernels 5 / 6).
TP4 = dict(hidden=2048, heads=4, kv_heads=2, head_dim=128, inter=1536, rows=2080)
# The 1.7B code predictor's intermediate on the main path that takes kernels
# 5 + 6 (not a multiple of the hidden 1024: the JAX package holds no pack).
LAYER_STEPS_INTER = 2816
# The card's published peaks (H100 SXM data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
KERNEL_ROWS = []
# A streaming session's chunks (frames): its first, then its steady size
# (SynthesisOptions' first_chunk_frames, chunk_frames).
STREAM_CHUNKS = (4, 10)
# ``synthesize_with_voice``'s chunks (``run_to_audio``: DECODE_BUCKET frames).
VOICE_CHUNKS = (DECODE_BUCKET, DECODE_BUCKET)
# The streamed audio against the staged decode of the same frames: at most
# this multiple of the staged decode's own spread between two bucket sizes
# (64 and 256 frames), read in the same run. Both differences come from the
# same source, matmuls over another number of rows (cuBLAS picks another
# tiling, so f32 sums run in another order), and the random vocoder's
# signal, which exceeds 1 before its clamp, scales them.
STREAM_SPREAD_FACTOR = 2.0
# Rows of kernel 2's units a frame at C = 384 / 192 / 96 (the vocoder's
# upsampling before each of its last three blocks).
UNIT_ROWS_PER_FRAME = {384: 160, 192: 640, 96: 1920}
TEXT = "The quick brown fox jumps over the lazy dog near the river bank today."
# A session that grows its buffers once (256 -> 512 frames).
GROWN_FRAMES = 300


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (dicts and lists of tensors)."""
    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
    return total


def bound(n_bytes: float, ops: float, kind: str = "bf16") -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality (NaN rows included)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(bits), b.view(bits))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()


def print_card() -> None:
    print(card_line(), flush=True)


def cp_params(cfg: CodePredictorConfig, dtype: torch.dtype, seed: int) -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return W.fuse_model_params(W.init_code_predictor_params(gen, cfg, dtype))


def cp_compare(params: dict, cfg: CodePredictorConfig, xs: list, pack: fused_layer.CpFramePack) -> dict:
    """Kernel 1 (through the tree's ``pack``) against its plain version on
    the same frames, twice (the same bits); timed per call from Python and
    by its device span (``kt.time_frame``)."""
    got = torch.stack([fused_layer.cp_frame(params, cfg, h, s, pack) for h, s in xs])
    again = torch.stack([fused_layer.cp_frame(params, cfg, h, s, pack) for h, s in xs])
    want = torch.stack([fused_layer.cp_frame_plain(params, cfg, h, s) for h, s in xs])
    torch.cuda.synchronize()
    h0, s0 = xs[0]
    return {
        "equal": (got == want).float().mean().item(),
        "first_equal": int((got[:, 0] == want[:, 0]).sum().item()),
        "err": (got.long() - want.long()).abs().max().item(),
        "same_bits": torch.equal(got, again),
        **kt.time_frame(fused_layer, params, cfg, h0, s0),
        "plain_ms": time_ms(lambda: fused_layer.cp_frame_plain(params, cfg, h0, s0), iters=5),
    }


def cp_frame_bound(params: dict, cfg: CodePredictorConfig, dtype: torch.dtype) -> dict:
    """Kernel 1, one frame: every weight read once (layer projections, norms,
    heads, mtp projection), the 14 embedding rows the codes pick, the two
    input rows and the 15 codes written; operations: the 16 positions
    through every layer projection and the mtp projection, and 15 heads.
    Beside it, ``reread_floor_ms``: the bytes the kernel cannot avoid on
    this card, where the layers do not stay in the 50 MB L2 between the 15
    dependent passes (the two prefill rows share one): the layers, their
    norms and the mtp projection 15 times, the rest once."""
    layers, heads, mtp = params["layers"], params["lm_heads"], params.get("mtp_proj")
    g, e, item = cfg.num_acoustic, cfg.embed_dim, torch.finfo(dtype).bits // 8
    n_bytes = nbytes(layers, heads, params["norm"], mtp) + (g + 1) * e * item + g * 4
    per_pass = nbytes(layers, mtp)

    def n(w):
        return (w["q8"] if quant.is_quantized(w) else w).numel()

    proj = sum(n(layers[p]) for p in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"))
    mtp_n = 0 if mtp is None else mtp["w"].numel()
    return dict(bound(n_bytes, 2 * (16 * (proj + mtp_n) + n(heads))),
                reread_floor_ms=(n_bytes + (g - 1) * per_pass) / HBM_BYTES_PER_S * 1e3)


def cp_device_kernels(
    params: dict, cfg: CodePredictorConfig, h: torch.Tensor, s: torch.Tensor, pack: fused_layer.CpFramePack
) -> list | None:
    """The device kernels one warm ``cp_frame`` call launches, by name, as
    torch.profiler records them (None where it records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fused_layer.cp_frame(params, cfg, h, s, pack)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_layer.cp_frame(params, cfg, h, s, pack)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def kernel1_fixture() -> None:
    """The seeded 1.7B f32 code predictor (``cp_fixture``) on the card: kernel
    1 in f32 (no TF32: CUDA-core FMAs) must give the codes the JAX package
    gives on the CPU, token for token."""
    cfg = cp_fixture.config()
    params = W.fuse_model_params(W.from_numpy_tree(cp_fixture.numpy_params(cfg), DEV))
    fixture = cp_fixture.load()
    pack = fused_layer.CpFramePack(params, cfg, torch.float32, DEV)
    before = fused_layer.cp_frame.launches
    got = [fused_layer.cp_frame(params, cfg, torch.from_numpy(h).to(DEV), torch.from_numpy(s).to(DEV), pack).tolist()
           for h, s in cp_fixture.numpy_inputs(cfg)]
    launched = fused_layer.cp_frame.launches - before
    equal = sum(a == b for g, w in zip(got, fixture["codes"]) for a, b in zip(g, w))
    total = sum(len(w) for w in fixture["codes"])
    phase("kernel1", f"seeded 1.7B f32 code predictor, {len(got)} frames: {equal}/{total} codes equal to the JAX "
          f"package's (fixture {cp_fixture.FIXTURE.name}, smallest top-2 gap "
          f"{min(map(min, fixture['top2_gap'])):.3e}); {launched} launches")
    check(got == fixture["codes"] and launched == len(got),
          f"kernel 1 f32 differs from the JAX package's codes at 1.7B: {got} vs {fixture['codes']}")


def check_bf16_bars(r: dict, what: str) -> None:
    # bf16 results depend on summation order: once one code differs, the rest
    # of the frame follows another path. A right kernel agrees on the first
    # code of nearly every frame and on most codes; a wrong one on about none.
    check(r["first_equal"] >= BF16_MIN_FIRST_EQUAL,
          f"{what}: first codes equal in {r['first_equal']}/{CP_FRAMES} frames (< {BF16_MIN_FIRST_EQUAL})")
    check(r["equal"] >= BF16_MIN_SHARE_EQUAL,
          f"{what}: share of equal codes {r['equal']:.4f} < {BF16_MIN_SHARE_EQUAL}")


def kernel1() -> None:
    cfg = config_for_variant("1.7B", "custom_voice").code_predictor
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    e = cfg.embed_dim
    inputs = [
        (torch.randn((1, 1, e), generator=gen, device=DEV),
         torch.randn((1, 1, e), generator=gen, device=DEV) * 0.02)
        for _ in range(CP_FRAMES)
    ]
    bf16_inputs = [(h.to(torch.bfloat16), s.to(torch.bfloat16)) for h, s in inputs]
    result = {}
    for name, params, xs in (
        ("float32", cp_params(cfg, torch.float32, seed=2), inputs),
        ("bfloat16", cp_params(cfg, torch.bfloat16, seed=2), bf16_inputs),
        ("int8", quant.quantize_code_predictor_params(cp_params(cfg, torch.bfloat16, seed=2)), bf16_inputs),
    ):
        pack = fused_layer.CpFramePack(params, cfg, xs[0][0].dtype, DEV)
        r = result[name] = cp_compare(params, cfg, xs, pack)
        r.update(cp_frame_bound(params, cfg, xs[0][0].dtype))
        r["device_kernels"] = cp_device_kernels(params, cfg, *xs[0], pack)
        phase("kernel1", f"{name}: {CP_FRAMES} frames x {cfg.num_acoustic} codes, share equal "
              f"{r['equal']:.4f}, first codes equal {r['first_equal']}/{CP_FRAMES}, max |code diff| {r['err']}, "
              f"same bits twice {r['same_bits']}; kernel {r['ms']:.4f} ms/frame per call (host included), "
              f"device span {r['device_ms']:.4f} ms/frame, plain {r['plain_ms']:.4f} ms/frame; bound "
              f"{r['bound_ms']:.4f} ms, re-read floor {r['reread_floor_ms']:.4f} ms; device kernels per call "
              + (f"{len(r['device_kernels'])} {sorted(set(r['device_kernels']))}" if r["device_kernels"]
                 else "not measured (the profiler recorded no device activity)"))
        check(r["same_bits"], f"kernel 1 {name}: two runs of the same frames differ")
        check(r["device_kernels"] is None or len(r["device_kernels"]) == 1,
              f"kernel 1 {name}: one call launched {r['device_kernels']} on the device, not one kernel")
        del params, pack
    check(result["float32"]["equal"] == 1.0,
          f"kernel 1 f32 codes differ from the plain version ({result['float32']['equal']:.4f} equal)")
    check_bf16_bars(result["bfloat16"], "kernel 1 bf16")
    check_bf16_bars(result["int8"], "kernel 1 int8")
    kernel1_fixture()
    for name, dtype, r in (("cp_frame", "bfloat16", result["bfloat16"]), ("cp_frame_int8", "int8", result["int8"])):
        row = {
            "name": name, "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/cp_frame.cu",
            "replaces": "qwen3_tts_tpu/ops/fused_layer.py:670",
            "launches": 0, "path": "bf16" if dtype == "bfloat16" else "int8", "dtype": dtype,
            "max_abs_err": float(r["err"]), "share_equal": r["equal"],
            "first_codes_equal": f"{r['first_equal']}/{CP_FRAMES}",
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        }
        if name == "cp_frame":
            row["f32_max_abs_err"] = float(result["float32"]["err"])
            row["f32_ms"], row["f32_device_ms"] = result["float32"]["ms"], result["float32"]["device_ms"]
        KERNEL_ROWS.append(row)


def kernel2() -> None:
    """Kernel 2 at the 9 residual-unit shapes of a 128-frame decode bucket
    (``kernel_timing.RU_SHAPES``): within 1e-5 * max|x| of the plain version,
    the same bits twice, a prefix run bit-identical; timed per call from
    Python, by its device span (calls in a CUDA graph), beside the plain
    version and the library yardstick (cuDNN's dilated conv plus one matmul,
    no snakes; never called by the port); then the 9 calls' device span in
    one graph."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    worst = 0.0
    work_bytes = work_ops = 0
    calls = []
    for c, t in kt.RU_SHAPES:
        for dil in kt.RU_DILATIONS:
            p = kt.unit_params(gen, c)
            x = torch.randn((1, t, c), generator=gen, device=DEV)
            got = fused_blocks.residual_unit(x, p, dil)
            again = fused_blocks.residual_unit(x, p, dil)
            want = fused_blocks.residual_unit_plain(x, p, dil)
            t_short = t - 1000 - 17  # not a multiple of the kernel's tile
            short = fused_blocks.residual_unit(x[:, :t_short].contiguous(), p, dil)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-5 * x.abs().max().item()
            prefix_equal = torch.equal(short, got[:, :t_short])
            repeat_equal = same_bits(got, again)
            fn = lambda x=x, p=p, dil=dil: fused_blocks.residual_unit(x, p, dil)  # noqa: E731
            r = {"ms": time_ms(fn, iters=5), "device_ms": kt.graph_ms([fn], 5),
                 "plain_ms": time_ms(lambda: fused_blocks.residual_unit_plain(x, p, dil), iters=5),
                 "library_ms": time_ms(kt.library_unit(x, p, dil), iters=5)}
            plan = fused_blocks.residual_unit_plan(c, dil)
            phase("kernel2", f"C={c} T={t} dilation={dil} (tile {plan.tm} rows, chunk {plan.kc} x {plan.stages}): "
                  f"max|err| {err:.3e} (atol {tol:.3e}), same bits twice {repeat_equal}, prefix bit-exact "
                  f"{prefix_equal}, kernel {r['ms']:.4f} ms per call / {r['device_ms']:.4f} device span, plain "
                  f"{r['plain_ms']:.4f}, library (conv1d + matmul, no snakes) {r['library_ms']:.4f}")
            check(err <= tol, f"kernel 2 C={c} dilation={dil}: max|err| {err:.3e} > {tol:.3e}")
            check(prefix_equal, f"kernel 2 C={c} dilation={dil}: prefix run differs from the long run")
            check(repeat_equal, f"kernel 2 C={c} dilation={dil}: two runs differ")
            for key in totals:
                totals[key] += r[key]
            worst = max(worst, err)
            calls.append(fn)
            # x read, y written, the weights; the k7 and 1x1 convolutions' MACs (f32).
            work_bytes += 2 * nbytes(x) + nbytes(p)
            work_ops += 2 * t * c * c * 8
    span9 = kt.graph_ms(calls, len(calls)) * len(calls)
    fma_bound = bound(work_bytes, work_ops, "f32")
    tc_bound = bound(work_bytes, 3 * work_ops, "tf32")
    phase("kernel2", f"all 9 units of a 128-frame decode: device span of the 9 in one graph {span9:.4f} ms; per call "
          f"{totals['ms']:.4f}, device spans {totals['device_ms']:.4f}, plain {totals['plain_ms']:.4f}, library "
          f"{totals['library_ms']:.4f}; bounds: 3xTF32 {tc_bound['bound_ms']:.4f} ms, f32 FMA "
          f"{fma_bound['bound_ms']:.4f} ms ({work_ops / 1e9:.1f} GFLOP)")
    KERNEL_ROWS.append({
        "name": "residual_unit", "route": "cuda",
        "source": "qwen3_tts_tpu_torch/csrc/residual_unit.cu",
        "replaces": "qwen3_tts_tpu/models/codec/fused_blocks.py:69",
        "launches": 0, "path": "bf16", "max_abs_err": worst, "ms": totals["ms"], "device_ms": span9,
        "plain_ms": totals["plain_ms"], **tc_bound, "f32_fma_bound_ms": fma_bound["bound_ms"],
        "library_ms": totals["library_ms"],
    })


def vocoder_fixture_check() -> None:
    """The seeded full-width vocoder (``qwen3_tts_tpu_torch/vocoder_fixture.py``)
    on the card through ``decode_bucketed``: kernel 2 for its 9 residual
    units with C <= 512, launched 9 times (counts set to 0 just before, read
    just after); the audio must be the JAX package's (the committed fixture)
    within 1e-5 and 1e-4 of max|audio|."""
    cfg = vocoder_fixture.config()
    params = W.from_numpy_tree(vocoder_fixture.numpy_params(cfg), DEV)
    codes = vocoder_fixture.numpy_codes(cfg)
    want = vocoder_fixture.load()
    for k in COUNTERS.values():
        k.launches = 0
    got = vocoder.decode_bucketed(params, cfg, codes)
    launches = fused_blocks.residual_unit.launches
    err = float(np.abs(got - want).max())
    bar = min(1e-5, 1e-4 * float(np.abs(want).max()))
    phase("decode", f"seeded full-width vocoder, {codes.shape[-1]} frames (bucket 64) on the card: max|audio - JAX "
          f"fixture| {err:.3e} (bar {bar:.3e}), max|audio| {float(np.abs(got).max()):.4f}, kernel 2 launches "
          f"{launches}")
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"decode: audio shape {got.shape}, or non-finite")
    check(err <= bar, f"decode: the card's audio is {err:.3e} from the JAX fixture (bar {bar:.3e})")
    check(launches == 9, f"decode: kernel 2 launched {launches} times, want 9")
    del params


def talker_device_kernels(layers: dict, stack, x, ck, cv, pos: int, pack) -> list | None:
    """The device kernels one warm ``talker_step`` call launches, by name, as
    torch.profiler records them (None where it records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fused_layer.talker_step(layers, x, stack, ck, cv, pos, pack)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_layer.talker_step(layers, x, stack, ck, cv, pos, pack)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def talker_trials(params: dict, tcfg: TalkerConfig, dtype: torch.dtype, gen: torch.Generator, rows: int,
                  pack: fused_layer.TalkerStepPack, unfused: dict | None = None) -> dict:
    """Kernel 3 (through the tree's ``pack``) against its plain version on
    ``params`` (the fused talker, int8 or plain) with caches of ``rows``
    rows in ``dtype``, on TALKER_TRIALS random (x, pos), pos near the top,
    each step twice (the same bits); with ``unfused`` (the same talker's
    unfused tree) also against the eager layer path (``talker.decode_step``,
    what the JAX main path computes): the normed hidden, the written rows
    and the codec-head argmax. At the last pos: kernel timed per call from
    Python and by its device span (``kt.time_step``: 20 steps in a CUDA
    graph), its device kernels per call (torch.profiler) and its per-phase
    trace; the plain version and (with ``unfused``) the layer path timed."""
    stack = tcfg.layer_stack()
    layers = params["layers"]
    n_layers, kvh, hd = stack.num_layers, stack.num_kv_heads, stack.head_dim
    kvd = kvh * hd

    def head(h):
        normed = nn.rms_norm(h, params["norm"], tcfg.rms_norm_eps)
        return normed, int(torch.argmax(quant.mm_plain(normed, params["codec_head"])))

    ck0 = torch.randn((n_layers, rows, kvd), generator=gen, device=DEV).to(dtype)
    cv0 = torch.randn((n_layers, rows, kvd), generator=gen, device=DEV).to(dtype)
    r = {"argmax": 0, "h_err": 0.0, "row_err": 0.0, "abs": 0.0, "untouched": True, "same_bits": True,
         "eager_argmax": 0, "eager_err": 0.0, "eager_row_err": 0.0}
    for trial in range(TALKER_TRIALS):
        pos = rows - 1 - 3 * trial
        x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=DEV).to(dtype)
        ck, cv, ckp, cvp = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
        got = fused_layer.talker_step(layers, x, stack, ck, cv, pos, pack)
        again = fused_layer.talker_step(layers, x, stack, ck0.clone(), cv0.clone(), pos, pack)
        want = fused_layer.talker_step_plain(layers, x, stack, ckp, cvp, pos)
        torch.cuda.synchronize()
        r["same_bits"] &= same_bits(got, again)
        (h_got, a_got), (_, a_want) = head(got), head(want)
        r["argmax"] += a_got == a_want
        r["h_err"] = max(r["h_err"], rel_err(got, want))
        r["abs"] = max(r["abs"], (got.float() - want.float()).abs().max().item())
        for c, c0, cp_ in ((ck, ck0, ckp), (cv, cv0, cvp)):
            r["row_err"] = max(r["row_err"], rel_err(c[:, pos], cp_[:, pos]))
            others = torch.arange(rows, device=DEV) != pos
            r["untouched"] &= same_bits(c[:, others], c0[:, others])
        if unfused is not None:
            cache = nn.KVCache(ck0.clone().view(n_layers, 1, rows, kvh, hd), cv0.clone().view(n_layers, 1, rows, kvh, hd))
            h_eager, logits = talker.decode_step(unfused, tcfg, x, pos, cache)
            r["eager_argmax"] += a_got == int(torch.argmax(logits))
            r["eager_err"] = max(r["eager_err"], rel_err(h_got, h_eager))
            for c, ce in ((ck, cache.k), (cv, cache.v)):
                r["eager_row_err"] = max(r["eager_row_err"], rel_err(c[:, pos], ce[:, 0, pos].reshape(n_layers, kvd)))
    r.update(kt.time_step(fused_layer, layers, stack, x, ck, cv, pos))
    r["device_kernels"] = talker_device_kernels(layers, stack, x, ck, cv, pos, pack)
    traced, stamps = fused_layer.talker_step(layers, x, stack, ck0.clone(), cv0.clone(), pos, pack, trace=True)
    r["traced_same_bits"] = same_bits(traced, fused_layer.talker_step(layers, x, stack, ck0.clone(), cv0.clone(),
                                                                      pos, pack))
    r["phases"] = fused_layer.talker_step_trace_phases(stamps, stack)
    r["plain_ms"] = time_ms(lambda: fused_layer.talker_step_plain(layers, x, stack, ckp, cvp, pos), iters=3)
    if unfused is not None:
        r["eager_ms"] = time_ms(lambda: talker.decode_step(unfused, tcfg, x, pos, cache), iters=3)
    # The weights once, x and y, the pos live rows of K and V read and row
    # pos written in every layer; the projections' and attention's MACs.
    proj = sum((w["q8"] if quant.is_quantized(w) else w).numel()
               for w in (layers[p] for p in ("qkv_proj", "o_proj", "gateup_proj", "down_proj")))
    cache_bytes = n_layers * (pos + 1) * 2 * kvd * ck0.element_size()
    r.update(bound(nbytes(layers) + 2 * nbytes(x) + cache_bytes,
                   2 * proj + n_layers * 4 * (pos + 1) * stack.num_heads * stack.head_dim))
    del ck0, cv0, ck, cv, ckp, cvp
    return r


def kernel3() -> None:
    """Kernel 3 in both forms against its plain version at 1.7B: int8 (the
    int8 path's), plain bf16 (the bf16 main path's) and plain f32, which is
    also held to the eager layer path on the unfused talker."""
    tcfg = config_for_variant("1.7B", "custom_voice").talker
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    forms = (
        ("int8", torch.bfloat16, lambda t: quant.quantize_talker_params(W.fuse_model_params(t))),
        ("bf16", torch.bfloat16, W.fuse_model_params),
        ("f32", torch.float32, W.fuse_model_params),
    )
    res = {}
    for form, dtype, make in forms:
        unfused = W.init_talker_params(gen, tcfg, torch.float32 if form == "f32" else torch.bfloat16)
        params = make(unfused)
        if form == "int8":
            unfused = None
        pack = fused_layer.TalkerStepPack(params["layers"], tcfg.layer_stack(), dtype, DEV)
        for rows in (160, 2080):  # 160 rows: the 125-frame main path's cache
            r = res[form, rows] = talker_trials(params, tcfg, dtype, gen, rows, pack, unfused)
            argmax_min, h_tol, row_tol = (TALKER_TRIALS, F32_STEP_TOL, F32_STEP_TOL) if form == "f32" else (
                TALKER_MIN_ARGMAX_EQUAL, HIDDEN_TOL, ROW_TOL)
            eager = "" if unfused is None else (
                f"; eager layer path: argmax equal {r['eager_argmax']}/{TALKER_TRIALS}, normed hidden "
                f"{r['eager_err']:.4e}, written rows {r['eager_row_err']:.4e}, {r['eager_ms']:.4f} ms")
            kernels = r["device_kernels"]
            phase("kernel3", f"1.7B {form} talker step, {rows}-row cache, {TALKER_TRIALS} trials: logits argmax equal "
                  f"{r['argmax']}/{TALKER_TRIALS} (bar {argmax_min}), hidden max|err|/max|plain| {r['h_err']:.4e} "
                  f"(bar {h_tol}), written row {r['row_err']:.4e} (bar {row_tol}), other rows bit-unchanged "
                  f"{r['untouched']}, same bits twice {r['same_bits']}; kernel {r['ms']:.4f} ms per call (host "
                  f"included), device span {r['device_ms']:.4f} ms (20 steps in a CUDA graph), plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); device kernels per call "
                  + (f"{len(kernels)} {sorted(set(kernels))}" if kernels
                     else "not measured (the profiler recorded no device activity)")
                  + f"; trace (us, one step, same bits {r['traced_same_bits']}): {trace_line(r['phases'])}"
                  + eager)
            what = f"kernel 3 {form} S={rows}"
            check(r["same_bits"] and r["traced_same_bits"], f"{what}: two calls on the same inputs differ")
            check(kernels is None or len(kernels) == 1, f"{what}: one call launched {kernels} on the device")
            check(r["argmax"] >= argmax_min, f"{what}: argmax equal in {r['argmax']}/{TALKER_TRIALS} (< {argmax_min})")
            check(r["h_err"] <= h_tol, f"{what}: hidden error {r['h_err']:.4e} > {h_tol}")
            check(r["row_err"] <= row_tol, f"{what}: written cache row error {r['row_err']:.4e} > {row_tol}")
            check(r["untouched"], f"{what}: a cache row other than pos changed")
            if form == "f32":
                check(r["eager_argmax"] == TALKER_TRIALS,
                      f"{what}: argmax equal to the layer path's in {r['eager_argmax']}/{TALKER_TRIALS}")
                check(r["eager_err"] <= F32_STEP_TOL and r["eager_row_err"] <= F32_STEP_TOL,
                      f"{what}: layer path error {r['eager_err']:.4e} / {r['eager_row_err']:.4e} > {F32_STEP_TOL}")
        del params, unfused, pack
        torch.cuda.empty_cache()
    kernel3_fixture()
    for form, name in (("bf16", "talker_step"), ("int8", "talker_step_int8")):
        row = {"name": name, "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
               "replaces": "qwen3_tts_tpu/ops/fused_layer.py:1261", "launches": 0, "path": form,
               "dtype": "bfloat16", "max_abs_err": max(res[form, n]["abs"] for n in (160, 2080)), "library_ms": None}
        for rows, suffix in ((160, ""), (2080, "_2080")):
            r = res[form, rows]
            row.update({f"ms{suffix}": r["ms"], f"device_ms{suffix}": r["device_ms"], f"plain_ms{suffix}": r["plain_ms"],
                        f"bound_ms{suffix}": r["bound_ms"],
                        f"argmax_equal{suffix}": f"{r['argmax']}/{TALKER_TRIALS}", f"hidden_rel_err{suffix}": r["h_err"]})
            if form == "bf16":
                f32 = res["f32", rows]
                row.update({f"eager_ms{suffix}": r["eager_ms"], f"ms_f32{suffix}": f32["ms"],
                            f"device_ms_f32{suffix}": f32["device_ms"],
                            f"plain_ms_f32{suffix}": f32["plain_ms"], f"eager_ms_f32{suffix}": f32["eager_ms"],
                            f"f32_rel_err{suffix}": f32["h_err"], f"f32_eager_rel_err{suffix}": f32["eager_err"]})
        row["bound_by"] = res[form, 160]["bound_by"]
        KERNEL_ROWS.append(row)


def kernel3_fixture() -> None:
    """The seeded 1.7B-width f32 talker of ``talker_fixture`` (2 layers) on the
    card: kernel 3 in f32 (CUDA-core FMAs) over its decode steps must give
    the codec-head argmaxes the JAX package gives on the CPU."""
    tcfg = talker_fixture.config()
    params = W.fuse_model_params(W.from_numpy_tree(talker_fixture.numpy_params(tcfg), DEV))
    stack = tcfg.layer_stack()
    k0, v0, xs = talker_fixture.numpy_inputs(tcfg)
    kvd = stack.num_kv_heads * stack.head_dim
    ck = torch.from_numpy(k0).to(DEV).reshape(stack.num_layers, talker_fixture.ROWS, kvd)
    cv = torch.from_numpy(v0).to(DEV).reshape(stack.num_layers, talker_fixture.ROWS, kvd)
    pack = fused_layer.TalkerStepPack(params["layers"], stack, torch.float32, DEV)
    fixture = talker_fixture.load()
    before = fused_layer.talker_step.launches
    got = []
    for i, x in enumerate(xs):
        h = fused_layer.talker_step(params["layers"], torch.from_numpy(x).to(DEV), stack, ck, cv,
                                    talker_fixture.START + i, pack)
        normed = nn.rms_norm(h, params["norm"], tcfg.rms_norm_eps)
        got.append(int(torch.argmax(quant.mm_plain(normed, params["codec_head"]))))
    launched = fused_layer.talker_step.launches - before
    phase("kernel3", f"seeded 1.7B-width f32 talker ({talker_fixture.LAYERS} layers), {len(got)} steps: codec-head "
          f"argmax {got}, the JAX package's {fixture['codes']} (fixture {talker_fixture.FIXTURE.name}, smallest "
          f"top-2 gap {min(fixture['top2_gap']):.3e}); {launched} launches")
    check(got == fixture["codes"] and launched == len(got),
          f"kernel 3 f32 differs from the JAX package's argmaxes at 1.7B widths: {got} vs {fixture['codes']}")


def kernel4() -> None:
    """The W8A16 matmul against its plain version at ``kt.SHAPES``: the main
    path's (talker prefill, 10 rows; codec head, 1 row every frame), a
    longer prompt's prefill (m = 32, 64), m = 1024 (the GEMM tier), and the
    per-step code predictor's (1.7B, intermediate 2816 as on its main path
    and the stock 3072): the 2-row prefill's projections and the 1-row lm
    heads, each at m = 2 and m = 1. Each shape is timed by
    ``kt.time_shape``: per call from Python as the path pays it (host
    included; ``ms``, ``library_ms``, as in earlier runs) and its device
    span (``device_ms``, ``library_device_ms``: a CUDA graph, weights cold
    in L2 as on the path, where the talker step's 1.4 GB pass between two
    calls)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(6)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    row = {"name": "int8_matmul", "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/int8_matmul.cu",
           "replaces": "qwen3_tts_tpu/ops/quant.py:168", "launches": 0, "path": "int8", "max_abs_err": 0.0,
           "shapes": []}
    for m, k, n in kt.SHAPES:
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=DEV) * 0.02)
        before = quant.int8_matmul.launches
        got = quant.int8_matmul(x, w["q8"], w["scale"])
        again = quant.int8_matmul(x, w["q8"], w["scale"])
        want = quant.int8_matmul_plain(x, w["q8"], w["scale"])
        torch.cuda.synchronize()
        check(quant.int8_matmul.launches == before + 2, f"kernel 4 did not launch at m={m} K={k} N={n}")
        check(same_bits(got, again), f"kernel 4 m={m} K={k} N={n}: two calls gave different bits")
        err = (got.float() - want.float()).abs().max().item()
        tol = want.float().abs().max().item() * 2.0**-7  # one bf16 ulp at the output's scale
        # The library yardstick in time_shape: one bf16 matmul on the weight
        # dequantized ahead of time (timed here only; the port never calls it).
        times = {**kt.time_shape(quant, x, w),
                 "plain_ms": time_ms(lambda: quant.int8_matmul_plain(x, w["q8"], w["scale"]), iters=20)}
        b = bound(nbytes(x, w) + m * n * x.element_size(), 2 * m * k * n)
        plan = quant.int8_matmul_plan(m, k, n, sms)
        phase("kernel4", f"m={m} K={k} N={n} (tier {plan.tier}, {plan.splits} K splits): max|err| {err:.4e} "
              f"(bar {tol:.4e}); per call as the path pays it (host included): kernel {times['ms']:.4f} ms, "
              f"library (dequantized bf16 matmul) {times['library_ms']:.4f} ms, plain {times['plain_ms']:.4f} "
              f"ms; device span: kernel {times['device_ms']:.4f} ms, library {times['library_device_ms']:.4f} "
              f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(err <= tol, f"kernel 4 m={m} K={k} N={n}: max|err| {err:.4e} > {tol:.4e}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"].append({"m": m, "k": k, "n": n, "tier": plan.tier, "splits": plan.splits,
                              "max_abs_err": err, **times, **b})
        if (m, k, n) == (1, 2048, 3072):  # the codec head, every frame
            row.update(**times, **b)
    row["row_invariance"] = kernel4_row_invariance()
    KERNEL_ROWS.append(row)


# Phase kernel4's row invariance: the rows a projection meets on the paths
# (decode at B <= 16, a B = 1 prefill 10, a dp = 2 replica's 40, voice design
# 41, ICL 73 and 105, the B = 8 prefill 80, the Jacobi batch 128), the tier
# switch (16, 17) and the largest call (1024); the 1.7B talker's qkv, o,
# gate|up, down and codec head, the code predictor's qkv, o, gate|up, down
# and lm heads.
INVARIANT_ROWS = (1, 4, 8, 10, 16, 17, 40, 41, 73, 80, 105, 128, 1024)
INVARIANT_SHAPES = (*TALKER_PROJ_SHAPES, (2048, 3072), *CP_PROJ_SHAPES, (1024, 2048))


def kernel4_row_invariance() -> dict:
    """Kernel 4 sums each output element in one order whatever m is: for
    every (K, N) of ``INVARIANT_SHAPES`` in bf16 and f32 x, the first m
    rows of a seeded [1024, K] x at each m of ``INVARIANT_ROWS`` give, row
    for row, the bits of the same rows at m = 1024."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    checked, rows = 0, 0
    for k, n in INVARIANT_SHAPES:
        w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=DEV) * 0.02)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((quant.KERNEL_MAX_ROWS, k), generator=gen, device=DEV).to(dtype)
            before = quant.int8_matmul.launches
            whole = quant.int8_matmul(x, w["q8"], w["scale"])
            for m in INVARIANT_ROWS:
                got = quant.int8_matmul(x[:m], w["q8"], w["scale"])
                plans = quant.int8_matmul_plan(m, k, n, sms), quant.int8_matmul_plan(quant.KERNEL_MAX_ROWS, k, n, sms)
                check(same_bits(got, whole[:m]), f"kernel 4 K={k} N={n} {dtype}: the first {m} rows differ from "
                                                 f"the same rows at m={quant.KERNEL_MAX_ROWS} (plans {plans})")
                rows += m
            check(quant.int8_matmul.launches == before + 1 + len(INVARIANT_ROWS),
                  f"kernel 4 K={k} N={n} {dtype}: launches")
            checked += 1
    phase("kernel4", f"row invariance: {checked} (shape, x dtype) cases, {rows} rows at m {list(INVARIANT_ROWS)}, "
                     f"each bit-equal to its row at m={quant.KERNEL_MAX_ROWS}")
    return {"cases": checked, "rows": rows, "m": list(INVARIANT_ROWS)}


def step_layers(gen: torch.Generator, dims: dict, dtype: torch.dtype, n_layers: int = 1) -> dict:
    """``n_layers`` int8 decoder layers (weights fused and quantized; norms
    off 1, in ``dtype``) at ``dims``, stacked."""
    stacked = W.init_layer_stack(
        gen, n_layers, dims["hidden"], dims["inter"], dims["heads"], dims["kv_heads"], dims["head_dim"], dtype
    )
    layers = quant.quantize_layer_stack(W.fuse_layer_params(stacked))
    for name in ("input_ln", "post_ln", "q_norm", "k_norm"):
        layers[name] = (1 + 0.1 * torch.randn(layers[name].shape, generator=gen, device=DEV)).to(dtype)
    return layers


def dims_stack(dims: dict, n_layers: int) -> nn.LayerStackConfig:
    """The layer-stack config of ``dims`` (eps 1e-6, as the checks pass it)."""
    return nn.LayerStackConfig(hidden_size=dims["hidden"], intermediate_size=dims["inter"], num_layers=n_layers,
                               num_heads=dims["heads"], num_kv_heads=dims["kv_heads"], head_dim=dims["head_dim"])


def live_cache(gen: torch.Generator, shape: tuple, pos: int, dtype: torch.dtype) -> torch.Tensor:
    """A random cache [..., S, KV*D] whose rows above ``pos`` hold NaN."""
    c = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    c[..., pos + 1 :, :] = float("nan")
    return c


def attention_bound(layer: dict, dims: dict, pos: int, item: int) -> dict:
    """Kernel 5: x, y, the layer's weights and norms, the RoPE row, the pos
    live K and V rows read and row pos written; the projections' and the
    attention's MACs."""
    qd, kvd = dims["heads"] * dims["head_dim"], dims["kv_heads"] * dims["head_dim"]
    weights = nbytes(*(layer[k] for k in ("input_ln", "qkv_proj", "q_norm", "k_norm", "o_proj")))
    n_bytes = weights + 2 * dims["hidden"] * item + dims["head_dim"] * 4 + (pos + 1) * 2 * kvd * item
    ops = 2 * (layer["qkv_proj"]["q8"].numel() + layer["o_proj"]["q8"].numel()) + 4 * (pos + 1) * qd
    return bound(n_bytes, ops)


def mlp_bound(layer: dict, dims: dict, item: int) -> dict:
    """Kernel 6: x, y, the layer's MLP weights and norm; their MACs."""
    n_bytes = nbytes(layer["post_ln"], layer["gateup_proj"], layer["down_proj"]) + 2 * dims["hidden"] * item
    return bound(n_bytes, 2 * (layer["gateup_proj"]["q8"].numel() + layer["down_proj"]["q8"].numel()))


# Layers of a kernel-5/6 check: each trial steps the next one (every layer
# index of the pack), and the timings cycle through them so that each
# call's weights arrive cold, as on the route (kernel_timing.FUSED_STEP_LAYERS).
STEP_LAYERS = kt.FUSED_STEP_LAYERS


def step_case(dims: dict, dtype: torch.dtype, residual: bool, positions: list, seed: int) -> dict:
    """Kernels 5 and 6 through one ``FusedStepPack`` of STEP_LAYERS random
    layers against their plain versions at ``dims``, for each pos (a fresh x
    and cache each, the layers in turn), each call twice (the same bits);
    timed at the last pos: per call from Python and by the device span (20
    calls in a CUDA graph cycling through the layers, ``kt.fused_step_times``).
    Returns errors, times and bounds."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    layers = step_layers(gen, dims, dtype, STEP_LAYERS)
    stack = dims_stack(dims, STEP_LAYERS)
    rows, kvd = dims["rows"], dims["kv_heads"] * dims["head_dim"]
    cos_t, sin_t = fused_layer.rope_tables(dims["head_dim"], 1e6, rows, DEV)
    pack = fused_layer.FusedStepPack(layers, stack, dtype, DEV, max_seq=rows)
    attn = (dims["heads"], dims["kv_heads"], dims["head_dim"], 1e-6, residual)
    r = {"attn_err": 0.0, "row_err": 0.0, "mlp_err": 0.0, "attn_abs": 0.0, "mlp_abs": 0.0, "untouched": True,
         "same_bits": True, "mlp_same_bits": True}
    for i, pos in enumerate(positions):
        l = i % STEP_LAYERS
        layer = nn.layer_params_at(layers, l)
        x = torch.randn((1, dims["hidden"]), generator=gen, device=DEV).to(dtype)
        ck0, cv0 = live_cache(gen, (rows, kvd), pos, dtype), live_cache(gen, (rows, kvd), pos, dtype)
        ck, cv, ckp, cvp = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
        got = fused_layer.fused_attention_step(x, layer, cos_t, sin_t, ck, cv, pos, *attn, pack=pack, layer_index=l)
        again = fused_layer.fused_attention_step(x, layer, cos_t, sin_t, ck0.clone(), cv0.clone(), pos, *attn,
                                                 pack=pack, layer_index=l)
        want = fused_layer.fused_attention_step_plain(x, layer, cos_t, sin_t, ckp, cvp, pos, *attn)
        got6 = fused_layer.fused_mlp_step(x, layer, dims["inter"], 1e-6, residual, pack=pack, layer_index=l)
        again6 = fused_layer.fused_mlp_step(x, layer, dims["inter"], 1e-6, residual, pack=pack, layer_index=l)
        want6 = fused_layer.fused_mlp_step_plain(x, layer, dims["inter"], 1e-6, residual)
        torch.cuda.synchronize()
        r["same_bits"] &= same_bits(got, again)
        r["mlp_same_bits"] &= same_bits(got6, again6)
        r["attn_err"] = max(r["attn_err"], rel_err(got, want))
        r["attn_abs"] = max(r["attn_abs"], (got.float() - want.float()).abs().max().item())
        r["mlp_err"] = max(r["mlp_err"], rel_err(got6, want6))
        r["mlp_abs"] = max(r["mlp_abs"], (got6.float() - want6.float()).abs().max().item())
        for c, c0, cp_ in ((ck, ck0, ckp), (cv, cv0, cvp)):
            r["row_err"] = max(r["row_err"], rel_err(c[pos], cp_[pos]))
            others = torch.arange(rows, device=DEV) != pos
            r["untouched"] &= same_bits(c[others], c0[others])
    item = x.element_size()
    ck5 = torch.randn((STEP_LAYERS, rows, kvd), generator=gen, device=DEV).to(dtype)
    cv5 = torch.randn((STEP_LAYERS, rows, kvd), generator=gen, device=DEV).to(dtype)
    times = kt.fused_step_times(fused_layer, nn, layers, stack, x, ck5, cv5, pos, cos_t, sin_t, residual)
    r["ms"], r["device_ms"] = times["attention_ms"], times["attention_device_ms"]
    r["mlp_ms"], r["mlp_device_ms"] = times["mlp_ms"], times["mlp_device_ms"]
    r["plain_ms"] = time_ms(
        lambda: fused_layer.fused_attention_step_plain(x, layer, cos_t, sin_t, ckp, cvp, pos, *attn), iters=10)
    r["mlp_plain_ms"] = time_ms(
        lambda: fused_layer.fused_mlp_step_plain(x, layer, dims["inter"], 1e-6, residual), iters=10)
    r["bound"], r["mlp_bound"] = attention_bound(layer, dims, pos, item), mlp_bound(layer, dims, item)
    return r


def fused_step_device_kernels(sublayer: str) -> list | None:
    """The device kernels one warm bf16 call of kernel 5 (``sublayer``
    "attention") or 6 ("mlp") launches at the 1.7B code predictor's widths,
    by name, as torch.profiler records them in a process of its own
    (``kernel_timing.py --kernel fused_step --kernels``); None where it
    records none."""
    script = Path(__file__).resolve().parent / "qwen3_tts_tpu_torch" / "kernel_timing.py"
    out = subprocess.run([sys.executable, str(script), "--kernel", "fused_step", "--kernels", "--sublayer", sublayer,
                          "--forms", "bfloat16", "--repeats", "1"], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return json.loads(next(line for line in out.splitlines() if line.startswith("{")))["device_kernels"]


def kernels5_6_fixture() -> float:
    """The seeded 1.7B int8 code-predictor layers at intermediate 2816 of
    ``cp_fixture`` on the card: kernels 5 + 6 in f32 through a
    ``FusedStepPack`` (``run_fused_decode_step``'s per-layer route) at each
    of the fixture's positions must give the JAX package's outputs (the
    committed fixture) within STEP7_F32_TOL of their largest value, one
    launch of each kernel a layer. Returns the largest error."""
    cfg = cp_fixture.fused_step_config()
    stack = cfg.layer_stack()
    layers = _on(cp_fixture.step_layers(cfg), DEV)
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, cp_fixture.STEP_ROWS, DEV)
    pack = fused_layer.FusedStepPack(layers, stack, torch.float32, DEV)
    fixture = torch.from_numpy(cp_fixture.load_fused_step()).to(DEV)
    counters = (fused_layer.fused_attention_step, fused_layer.fused_mlp_step)
    before = [k.launches for k in counters]
    errs = []
    for (pos, x, k, v), want in zip(cp_fixture.step_inputs(cfg), fixture):
        ck, cv = torch.from_numpy(k).to(DEV), torch.from_numpy(v).to(DEV)
        got = fused_layer.run_fused_decode_step(layers, torch.from_numpy(x).to(DEV), stack, ck, cv, pos, cos_t, sin_t,
                                                False, step_pack=pack)
        errs.append(rel_err(got.reshape(-1), want))
    launched = [k.launches - b for k, b in zip(counters, before)]
    phase("kernel5", f"seeded 1.7B int8 code predictor, intermediate {cfg.intermediate_size} ({stack.num_layers} "
          f"layers), f32, kernels 5 + 6 through a FusedStepPack, pos {list(cp_fixture.STEP_POSITIONS)}: "
          f"max|err|/max|JAX| {', '.join(f'{e:.4e}' for e in errs)} against the JAX package's outputs (fixture "
          f"{cp_fixture.FUSED_STEP_FIXTURE.name}; bar {STEP7_F32_TOL}); launches {launched}")
    check(max(errs) <= STEP7_F32_TOL and launched == [len(errs) * stack.num_layers] * 2,
          f"kernels 5 + 6 in f32 differ from the JAX package's outputs at 1.7B widths: {errs} > {STEP7_F32_TOL} "
          f"(launches {launched})")
    return max(errs)


def kernels5_6() -> None:
    """Kernels 5 and 6 at the widths of the 1.7B code predictor whose main
    path launches them (``per_step_main_paths``: intermediate 2816; 17
    rows, residual; bf16 as there, and f32), at the stock intermediate 3072
    (``per_step_path``), and at the 4-chip talker shard (2080 rows, pos near
    the top, no residual), each through a ``FusedStepPack``: the bars, the
    same bits twice, the device span and the time per call; the device
    kernels one call of each launches (torch.profiler, in a process of its
    own); then the f32 kernels against the JAX package's outputs
    (``kernels5_6_fixture``)."""
    cpd = replace(config_for_variant("1.7B", "custom_voice").code_predictor, intermediate_size=LAYER_STEPS_INTER)
    cp_dims = dict(hidden=cpd.hidden_size, heads=cpd.num_attention_heads, kv_heads=cpd.num_key_value_heads,
                   head_dim=cpd.head_dim, inter=cpd.intermediate_size, rows=fused_layer.CP_MAX_SEQ)
    stock_dims = dict(cp_dims, inter=config_for_variant("1.7B", "custom_voice").code_predictor.intermediate_size)
    rng = np.random.default_rng(7)
    cp_pos = [int(p) for p in rng.integers(2, fused_layer.CP_MAX_SEQ, size=STEP_TRIALS)]
    tp_pos = [TP4["rows"] - 1 - 3 * i for i in range(STEP_TRIALS)]
    cases = [
        ("cp-bf16", cp_dims, torch.bfloat16, True, cp_pos),
        ("cp-f32", cp_dims, torch.float32, True, cp_pos),
        ("cp-stock-bf16", stock_dims, torch.bfloat16, True, cp_pos),
        ("tp4-bf16", TP4, torch.bfloat16, False, tp_pos),
    ]
    kernels = {sub: fused_step_device_kernels(sub) for sub in ("attention", "mlp")}
    res = {}
    for i, (name, dims, dtype, residual, positions) in enumerate(cases):
        r = res[name] = step_case(dims, dtype, residual, positions, seed=10 + i)
        tol = STEP_TOL[dtype]
        phase("kernel5", f"{name} (H {dims['hidden']}, {dims['heads']}/{dims['kv_heads']} heads, {dims['rows']} "
              f"rows, residual {residual}), {len(positions)} trials through a FusedStepPack of {STEP_LAYERS} "
              f"layers: output max|err|/max|plain| {r['attn_err']:.4e}, written row {r['row_err']:.4e} (bar {tol}), "
              f"other rows bit-unchanged {r['untouched']}, same bits twice {r['same_bits']}; device span "
              f"{r['device_ms']:.4f} ms (20 calls in a CUDA graph), per call {r['ms']:.4f} ms (host included), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound']['bound_ms']:.4f} ms ({r['bound']['bound_by']})")
        phase("kernel6", f"{name} (I {dims['inter']}): output max|err|/max|plain| {r['mlp_err']:.4e} (bar {tol}), "
              f"same bits twice {r['mlp_same_bits']}; device span {r['mlp_device_ms']:.4f} ms, per call "
              f"{r['mlp_ms']:.4f} ms, plain {r['mlp_plain_ms']:.4f} ms, bound {r['mlp_bound']['bound_ms']:.4f} ms "
              f"({r['mlp_bound']['bound_by']})")
        check(r["attn_err"] <= tol, f"kernel 5 {name}: output error {r['attn_err']:.4e} > {tol}")
        check(r["row_err"] <= tol, f"kernel 5 {name}: written cache row error {r['row_err']:.4e} > {tol}")
        check(r["untouched"], f"kernel 5 {name}: a cache row other than pos changed")
        check(r["same_bits"], f"kernel 5 {name}: two calls on the same inputs differ")
        check(r["mlp_err"] <= tol, f"kernel 6 {name}: output error {r['mlp_err']:.4e} > {tol}")
        check(r["mlp_same_bits"], f"kernel 6 {name}: two calls on the same inputs differ")
    for sub, names in kernels.items():
        phase("kernel5" if sub == "attention" else "kernel6", f"device kernels per call ({sub}, bf16, torch.profiler "
              "in a process of its own): " + (f"{len(names)} {sorted(set(names))}" if names
                                              else "not measured (the profiler recorded no device activity)"))
        check(names is None or len(names) == 1, f"kernels 5/6 {sub}: one call launched {names} on the device")
    fixture_err = kernels5_6_fixture()
    main, f32, stock, tp = res["cp-bf16"], res["cp-f32"], res["cp-stock-bf16"], res["tp4-bf16"]
    common = {"route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/fused_step.cu", "launches": 0,
              "path": f"int8_cp_inter_{LAYER_STEPS_INTER}", "dtype": "bfloat16", "library_ms": None,
              "intermediate": LAYER_STEPS_INTER, "f32_fixture_rel_err": fixture_err}
    KERNEL_ROWS.append({
        "name": "fused_attention_step", "replaces": "qwen3_tts_tpu/ops/fused_layer.py:56", **common,
        "max_abs_err": main["attn_abs"], "rel_err": main["attn_err"], "row_rel_err": main["row_err"],
        "ms": main["ms"], "device_ms": main["device_ms"], "plain_ms": main["plain_ms"], **main["bound"],
        "device_kernels": kernels["attention"],
        "f32_rel_err": f32["attn_err"], "ms_f32": f32["ms"], "device_ms_f32": f32["device_ms"],
        "plain_ms_f32": f32["plain_ms"],
        "tp4_rel_err": tp["attn_err"], "ms_tp4": tp["ms"], "device_ms_tp4": tp["device_ms"],
        "plain_ms_tp4": tp["plain_ms"], "bound_ms_tp4": tp["bound"]["bound_ms"],
    })
    KERNEL_ROWS.append({
        "name": "fused_mlp_step", "replaces": "qwen3_tts_tpu/ops/fused_layer.py:151", **common,
        "max_abs_err": main["mlp_abs"], "rel_err": main["mlp_err"],
        "ms": main["mlp_ms"], "device_ms": main["mlp_device_ms"], "plain_ms": main["mlp_plain_ms"],
        **main["mlp_bound"], "device_kernels": kernels["mlp"],
        "f32_rel_err": f32["mlp_err"], "ms_f32": f32["mlp_ms"], "device_ms_f32": f32["mlp_device_ms"],
        "plain_ms_f32": f32["mlp_plain_ms"],
        "i3072_rel_err": stock["mlp_err"], "ms_i3072": stock["mlp_ms"], "device_ms_i3072": stock["mlp_device_ms"],
        "plain_ms_i3072": stock["mlp_plain_ms"], "bound_ms_i3072": stock["mlp_bound"]["bound_ms"],
        "tp4_rel_err": tp["mlp_err"], "ms_tp4": tp["mlp_ms"], "device_ms_tp4": tp["mlp_device_ms"],
        "plain_ms_tp4": tp["mlp_plain_ms"], "bound_ms_tp4": tp["mlp_bound"]["bound_ms"],
    })


def bf16_residual_step(layers: dict, x, stack, ck, cv, pos: int, cos_t, sin_t) -> torch.Tensor:
    """Kernel 7's plain f32 step with its residual stream rounded to bf16
    after every sub-layer: a faulty step that the f32 bar must reject."""
    bf16, H = torch.bfloat16, stack.hidden_size
    cos_row, sin_row = cos_t[pos : pos + 1].to(bf16), sin_t[pos : pos + 1].to(bf16)
    h = x.reshape(1, H)
    for l in range(ck.shape[0]):
        layer = nn.layer_params_at(layers, l)
        h = fused_layer._attention_plain(h, layer, cos_row, sin_row, ck[l], cv[l], pos, stack.num_heads,
                                         stack.num_kv_heads, stack.head_dim, stack.rms_norm_eps, True, H)
        h = h.to(bf16).float()
        h = fused_layer._mlp_plain(h, layer, stack.intermediate_size, stack.rms_norm_eps, True, H)
        h = h.to(bf16).float()
    return h.reshape(1, 1, H)


def trace_line(ph: dict) -> str:
    """A step's per-phase trace (``talker_step_trace_phases``), in µs."""
    return f"span {ph['span']:.1f}: " + ", ".join(
        f"{k} {ph[k]['work']:.1f} (stage {ph[k]['stage']:.1f}, tiles {ph[k]['tiles']:.1f}, epilogue "
        f"{ph[k]['epilogue']:.1f}, barrier {ph[k]['barrier']:.1f})" for k in ("qkv", "attention", "o", "gate_up", "down"))


def cp_step_device_kernels(form: str) -> list | None:
    """The device kernels one warm kernel-7 call launches with ``form``
    activations, by name, as torch.profiler records them in a process of
    its own (``kernel_timing.py --kernel cp_step --kernels``: in this
    process the profiler's later sessions record no device activity); None
    where it records none."""
    script = Path(__file__).resolve().parent / "qwen3_tts_tpu_torch" / "kernel_timing.py"
    out = subprocess.run([sys.executable, str(script), "--kernel", "cp_step", "--kernels", "--forms", form,
                          "--repeats", "1"], capture_output=True, text=True, check=True, timeout=300).stdout
    return json.loads(next(line for line in out.splitlines() if line.startswith("{")))["device_kernels"]


def step7_trials(layers: dict, stack, pack, dtype: torch.dtype, cos_t, sin_t, faulty: bool = False) -> dict:
    """Kernel 7 through ``pack`` against its plain version at STEP_TRIALS
    random (x, pos) on 17-row caches, each step twice: the largest output
    and written-row errors relative to the plain version's scale, whether
    every other row stayed bit-unchanged and both calls gave the same bits;
    with ``faulty``, the least error of a step whose residual stream is
    rounded to bf16. ``last`` holds the last trial's inputs and caches."""
    rows, kvd, n_layers = fused_layer.CP_MAX_SEQ, stack.num_kv_heads * stack.head_dim, stack.num_layers
    positions = [int(p) for p in np.random.default_rng(9).integers(2, rows, size=STEP_TRIALS)]
    gen = torch.Generator(device=DEV).manual_seed(8)
    r = {"err": 0.0, "abs": 0.0, "row_err": 0.0, "untouched": True, "faulty_err": math.inf, "same_bits": True}
    for pos in positions:
        x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=DEV).to(dtype)
        ck0 = live_cache(gen, (n_layers, rows, kvd), pos, dtype)
        cv0 = live_cache(gen, (n_layers, rows, kvd), pos, dtype)
        ck, cv, ckp, cvp = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
        got = fused_layer.streamed_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t, pack)
        again = fused_layer.streamed_decode_step(layers, x, stack, ck0.clone(), cv0.clone(), pos, cos_t, sin_t, pack)
        want = fused_layer.streamed_decode_step_plain(layers, x, stack, ckp, cvp, pos, cos_t, sin_t)
        if faulty:
            bad = bf16_residual_step(layers, x, stack, ck0.clone(), cv0.clone(), pos, cos_t, sin_t)
            r["faulty_err"] = min(r["faulty_err"], rel_err(bad, want))
        torch.cuda.synchronize()
        r["same_bits"] &= same_bits(got, again)
        r["err"] = max(r["err"], rel_err(got, want))
        r["abs"] = max(r["abs"], (got.float() - want.float()).abs().max().item())
        for c, c0, cp_ in ((ck, ck0, ckp), (cv, cv0, cvp)):
            r["row_err"] = max(r["row_err"], rel_err(c[:, pos], cp_[:, pos]))
            others = torch.arange(rows, device=DEV) != pos
            r["untouched"] &= same_bits(c[:, others], c0[:, others])
    r["last"] = (x, ck, cv, ck0, cv0, ckp, cvp, pos)
    return r


def kernel7() -> None:
    """Kernel 7 (one persistent launch a step, through the tree's
    ``CpStepPack``) against its plain version on the 1.7B int8 code
    predictor (5 layers, 17 rows): bf16 activations (the main path's), and
    f32 beside a faulty step (``bf16_residual_step``) that its bar must
    reject; every step twice (the same bits). At the last pos: timed per
    call from Python and by its device span (20 steps in a CUDA graph), its
    device kernels per call (torch.profiler, ``cp_step_device_kernels``)
    and its per-phase trace. Then the f32 kernel against the JAX package's
    outputs (``kernel7_fixture``)."""
    cfg = config_for_variant("1.7B", "custom_voice").code_predictor
    stack = cfg.layer_stack()
    rows, n_layers = fused_layer.CP_MAX_SEQ, stack.num_layers
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, rows, DEV)
    res = {}
    for dtype, tol in ((torch.bfloat16, STEP_TOL[torch.bfloat16]), (torch.float32, STEP7_F32_TOL)):
        layers = quant.quantize_code_predictor_params(cp_params(cfg, dtype, seed=2))["layers"]
        pack = fused_layer.CpStepPack(layers, stack, dtype, DEV)
        r = res[dtype] = step7_trials(layers, stack, pack, dtype, cos_t, sin_t, faulty=dtype == torch.float32)
        x, ck, cv, ck0, cv0, ckp, cvp, pos = r.pop("last")
        kvd = ck.shape[-1]
        r.update(kt.time_cp_step(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t))
        r["device_kernels"] = cp_step_device_kernels("bfloat16" if dtype == torch.bfloat16 else "float32")
        traced, stamps = fused_layer.streamed_decode_step(layers, x, stack, ck0.clone(), cv0.clone(), pos, cos_t,
                                                          sin_t, pack, trace=True)
        r["traced_same_bits"] = same_bits(traced, fused_layer.streamed_decode_step(
            layers, x, stack, ck0.clone(), cv0.clone(), pos, cos_t, sin_t, pack))
        r["phases"] = fused_layer.talker_step_trace_phases(stamps, stack)
        r["plain_ms"] = time_ms(
            lambda: fused_layer.streamed_decode_step_plain(layers, x, stack, ckp, cvp, pos, cos_t, sin_t), iters=10)
        proj = sum(layers[p]["q8"].numel() for p in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"))
        item = x.element_size()
        # The weights once, x and y, the RoPE row, the live K and V rows.
        r.update(bound(nbytes(layers) + 2 * nbytes(x) + stack.head_dim * 4 + n_layers * (pos + 1) * 2 * kvd * item,
                       2 * proj + n_layers * 4 * (pos + 1) * stack.num_heads * stack.head_dim))
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        faulty_msg = "" if dtype == torch.bfloat16 else (
            f", a step with a bf16 residual stream {r['faulty_err']:.4e} at the least (must exceed the bar)")
        kernels = r["device_kernels"]
        phase("kernel7", f"1.7B int8 code-predictor step, {name}, {STEP_TRIALS} trials: output max|err|/max|plain| "
              f"{r['err']:.4e}, written rows {r['row_err']:.4e} (bar {tol}){faulty_msg}, other rows bit-unchanged "
              f"{r['untouched']}, same bits twice {r['same_bits']}; kernel {r['ms']:.4f} ms per call (host "
              f"included), device span {r['device_ms']:.4f} ms (20 steps in a CUDA graph), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); device kernels per call "
              + (f"{len(kernels)} {sorted(set(kernels))}" if kernels
                 else "not measured (the profiler recorded no device activity)")
              + f"; trace (us, one step, same bits {r['traced_same_bits']}): {trace_line(r['phases'])}")
        check(r["same_bits"] and r["traced_same_bits"], f"kernel 7 {name}: two calls on the same inputs differ")
        check(kernels is None or len(kernels) == 1, f"kernel 7 {name}: one call launched {kernels} on the device")
        check(r["err"] <= tol, f"kernel 7 {name}: output error {r['err']:.4e} > {tol}")
        check(r["row_err"] <= tol, f"kernel 7 {name}: written cache rows error {r['row_err']:.4e} > {tol}")
        check(r["untouched"], f"kernel 7 {name}: a cache row other than pos changed")
        check(r["faulty_err"] > tol, f"kernel 7 {name}: the bar {tol} does not reject a bf16 residual stream "
                                     f"({r['faulty_err']:.4e})")
        del layers, pack
    fixture_err = kernel7_fixture()
    r, f32 = res[torch.bfloat16], res[torch.float32]
    KERNEL_ROWS.append({
        "name": "streamed_decode_step", "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
        "replaces": "qwen3_tts_tpu/ops/fused_layer.py:412", "launches": 0, "path": "int8_cp_vocab_2047",
        "dtype": "bfloat16", "max_abs_err": r["abs"], "rel_err": r["err"], "row_rel_err": r["row_err"],
        "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "f32_rel_err": f32["err"], "f32_row_rel_err": f32["row_err"],
        "f32_bf16_residual_rel_err": f32["faulty_err"], "f32_fixture_rel_err": fixture_err, "ms_f32": f32["ms"],
        "device_ms_f32": f32["device_ms"], "plain_ms_f32": f32["plain_ms"],
    })


def kernel7_wide_head() -> None:
    """Kernel 7 at head_dim 256: the 1.7B int8 code predictor with 8 q heads
    of 256 over 4 KV heads and vocab 2047 (the JAX gates send it to the
    per-step route), through its ``CpStepPack``, against its plain version
    (``step7_trials``) in bf16 and f32 under phase 8's bars, and timed by
    its device span (20 steps in a CUDA graph) at the last trial's pos."""
    base = config_for_variant("1.7B", "custom_voice").code_predictor
    cfg = replace(base, vocab_size=2047, head_dim=256, num_attention_heads=8, num_key_value_heads=4)
    stack = cfg.layer_stack()
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, fused_layer.CP_MAX_SEQ, DEV)
    for dtype, tol in ((torch.bfloat16, STEP_TOL[torch.bfloat16]), (torch.float32, STEP7_F32_TOL)):
        full = quant.quantize_code_predictor_params(cp_params(cfg, dtype, seed=2))
        layers, route = full["layers"], cp.cp_route(full, cfg)
        pack = fused_layer.CpStepPack(layers, stack, dtype, DEV)
        r = step7_trials(layers, stack, pack, dtype, cos_t, sin_t)
        x, ck, cv, _, _, ckp, cvp, pos = r.pop("last")
        r.update(kt.time_cp_step(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t))
        r["plain_ms"] = time_ms(
            lambda: fused_layer.streamed_decode_step_plain(layers, x, stack, ckp, cvp, pos, cos_t, sin_t), iters=10)
        proj = sum(layers[p]["q8"].numel() for p in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"))
        kvd = stack.num_kv_heads * stack.head_dim
        r.update(bound(nbytes(layers) + 2 * nbytes(x) + stack.head_dim * 4
                       + stack.num_layers * (pos + 1) * 2 * kvd * x.element_size(),
                       2 * proj + stack.num_layers * 4 * (pos + 1) * stack.num_heads * stack.head_dim))
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        phase("kernel7", f"head_dim 256 (8 q / 4 KV heads, route {route}), int8, {name}, {STEP_TRIALS} trials: "
              f"output max|err|/max|plain| {r['err']:.4e}, written rows {r['row_err']:.4e} (bar {tol}), other rows "
              f"bit-unchanged {r['untouched']}, same bits twice {r['same_bits']}; device span {r['device_ms']:.4f} "
              f"ms (20 steps in a CUDA graph), per call {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        check(route == "streamed_step", f"kernel 7 head 256: code-predictor route {route}, want streamed_step")
        check(r["same_bits"], f"kernel 7 head 256 {name}: two calls on the same inputs differ")
        check(r["err"] <= tol, f"kernel 7 head 256 {name}: output error {r['err']:.4e} > {tol}")
        check(r["row_err"] <= tol, f"kernel 7 head 256 {name}: written cache rows error {r['row_err']:.4e} > {tol}")
        check(r["untouched"], f"kernel 7 head 256 {name}: a cache row other than pos changed")
        del full, layers, pack


def kernel7_fixture() -> float:
    """The seeded 1.7B int8 code-predictor layers of ``cp_fixture`` on the
    card: kernel 7 in f32 at each of the fixture's positions must give the
    JAX package's outputs (the committed fixture) within STEP7_F32_TOL of
    their largest value, each in one launch. Returns the largest error."""
    cfg = cp_fixture.config()
    stack = cfg.layer_stack()
    layers = _on(cp_fixture.step_layers(cfg), DEV)
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, cp_fixture.STEP_ROWS, DEV)
    pack = fused_layer.CpStepPack(layers, stack, torch.float32, DEV)
    fixture = torch.from_numpy(cp_fixture.load_step()).to(DEV)
    before = fused_layer.streamed_decode_step.launches
    errs = []
    for (pos, x, k, v), want in zip(cp_fixture.step_inputs(cfg), fixture):
        ck, cv = torch.from_numpy(k).to(DEV), torch.from_numpy(v).to(DEV)
        got = fused_layer.streamed_decode_step(layers, torch.from_numpy(x).to(DEV), stack, ck, cv, pos, cos_t, sin_t,
                                               pack)
        errs.append(rel_err(got.reshape(-1), want))
    launched = fused_layer.streamed_decode_step.launches - before
    phase("kernel7", f"seeded 1.7B int8 code predictor ({stack.num_layers} layers), f32, pos "
          f"{list(cp_fixture.STEP_POSITIONS)}: max|err|/max|JAX| {', '.join(f'{e:.4e}' for e in errs)} against "
          f"the JAX package's outputs (fixture {cp_fixture.STEP_FIXTURE.name}; bar {STEP7_F32_TOL}); "
          f"{launched} launches")
    check(max(errs) <= STEP7_F32_TOL and launched == len(errs),
          f"kernel 7 f32 differs from the JAX package's outputs at 1.7B widths: {errs} > {STEP7_F32_TOL}")
    return max(errs)


def _plain_streamed_step(layers, x, cfg, ck, cv, pos, cos_t, sin_t, pack=None):
    """Kernel 7's plain version with the kernel's signature (the pack unused)."""
    return fused_layer.streamed_decode_step_plain(layers, x, cfg, ck, cv, pos, cos_t, sin_t)


def _plain_attention_step(*args, residual=True, pack=None, layer_index=0):
    """Kernel 5's plain version with the kernel's signature (the pack unused)."""
    return fused_layer.fused_attention_step_plain(*args, residual=residual)


def _plain_mlp_step(*args, residual=True, pack=None, layer_index=0):
    """Kernel 6's plain version with the kernel's signature (the pack unused)."""
    return fused_layer.fused_mlp_step_plain(*args, residual=residual)


STEP_WRAPPERS = (
    (fused_layer, "streamed_decode_step", _plain_streamed_step),
    (fused_layer, "fused_attention_step", _plain_attention_step),
    (fused_layer, "fused_mlp_step", _plain_mlp_step),
    (quant, "int8_matmul", quant.int8_matmul_plain),
)


@contextlib.contextmanager
def plain_kernels():
    """The per-step path on the card with every kernel's plain version in
    place of its wrapper (the route's reference)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in STEP_WRAPPERS]
    try:
        for mod, name, plain in STEP_WRAPPERS:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def per_step_path() -> None:
    """The per-step int8 code predictor at full width (1.7B), 32 random
    frames, on each route (through its pack): kernel 7, and kernels 5 + 6;
    each against the same route on the plain versions by kernel 1's int8
    bars, beside kernel 1's codes and time."""
    cfg = config_for_variant("1.7B", "custom_voice").code_predictor
    params = quant.quantize_code_predictor_params(cp_params(cfg, torch.bfloat16, seed=2))
    gen = torch.Generator(device=DEV).manual_seed(1)
    e = cfg.embed_dim
    xs = [(torch.randn((1, 1, e), generator=gen, device=DEV).to(torch.bfloat16),
           (torch.randn((1, 1, e), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)) for _ in range(CP_FRAMES)]
    h0, s0 = xs[0]
    pack = fused_layer.CpFramePack(params, cfg, torch.bfloat16, DEV)
    frame = torch.stack([fused_layer.cp_frame(params, cfg, h, s, pack) for h, s in xs])
    frame_ms = time_ms(lambda: fused_layer.cp_frame(params, cfg, h0, s0, pack), iters=20)
    packs = {True: fused_layer.CpStepPack(params["layers"], cfg.layer_stack(), torch.bfloat16, DEV),
             False: fused_layer.FusedStepPack(params["layers"], cfg.layer_stack(), torch.bfloat16, DEV)}
    for streamed, name, kernels in ((True, "streamed_step", ("streamed_decode_step",)),
                                    (False, "layer_steps", ("fused_attention_step", "fused_mlp_step"))):
        def run(h, s, streamed=streamed):
            return cp._predict_acoustic_codes_fused(params, cfg, h, s, streamed, packs[streamed])

        for k in COUNTERS.values():
            k.launches = 0
        got = torch.stack([run(h, s) for h, s in xs])
        torch.cuda.synchronize()
        launches = {k: COUNTERS[k].launches for k in ("cp_frame", *kernels)}
        with plain_kernels():
            want = torch.stack([run(h, s) for h, s in xs])
            plain_ms = time_ms(lambda: run(h0, s0), iters=3)
        ms = time_ms(lambda: run(h0, s0), iters=10)
        r = {"equal": (got == want).float().mean().item(), "first_equal": int((got[:, 0] == want[:, 0]).sum())}
        to_frame = (got == frame).float().mean().item()
        phase("per-step", f"1.7B int8 code predictor, route {name}: {CP_FRAMES} frames, share of codes equal to "
              f"the plain route {r['equal']:.4f}, first codes equal {r['first_equal']}/{CP_FRAMES}, share equal to "
              f"kernel 1's codes {to_frame:.4f}; {ms:.4f} ms/frame (plain route {plain_ms:.4f}, kernel 1 "
              f"{frame_ms:.4f}); launches {launches}")
        check_bf16_bars(r, f"per-step route {name}")
        steps = CP_FRAMES * (cfg.num_acoustic - 1)
        want_launches = steps if streamed else steps * cfg.num_hidden_layers
        check(launches["cp_frame"] == 0 and all(launches[k] == want_launches for k in kernels),
              f"per-step route {name}: launches {launches}, want {want_launches} of {kernels} and no cp_frame")


# Jacobi code prediction (phase ``jacobi``): the passes timed in a row, and
# the B = 8 batch's frames.
JACOBI_TIMED_PASSES = 20
# The Jacobi utterance's and batch's frames (cut from 32 and 16 to keep the
# whole run within its time with phase ``validation``).
JACOBI_UTTERANCE_FRAMES = 16
JACOBI_BATCH_FRAMES = 8
JACOBI_REPEATED_FRAMES = 8  # frames run a second time for the same bits
JACOBI_WITNESS_B = 8  # frames at once in ``batch_rows_witness``: the B of ``jacobi_batch``


def jacobi_cfg(cfg: CodePredictorConfig) -> CodePredictorConfig:
    return replace(cfg, decode_mode="jacobi")


def jacobi_model(model: Qwen3TTS) -> Qwen3TTS:
    """``model``'s trees (already fused, or quantized) under a code-predictor
    config with ``decode_mode="jacobi"``: no kernel-1 or step pack."""
    cfg = replace(model.config, code_predictor=jacobi_cfg(model.config.code_predictor))
    m = Qwen3TTS(cfg, model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer,
                 vocoder_config=model.vocoder_config)
    check(m.cp_frame_pack is None and m.cp_step_pack is None, "a Jacobi model holds a code-predictor kernel pack")
    return m


def jacobi_frames(params: dict, cfg: CodePredictorConfig, xs: list) -> tuple[torch.Tensor, list]:
    """Each frame's Jacobi codes and passes (the counter read around it)."""
    codes, passes = [], []
    for h, s in xs:
        before = cp.predict_acoustic_codes_jacobi.iterations
        codes.append(cp.predict_acoustic_codes(params, cfg, h, s))
        passes.append(cp.predict_acoustic_codes_jacobi.iterations - before)
    return torch.stack(codes), passes


def jacobi_pass_times(params: dict, cfg: CodePredictorConfig, h: torch.Tensor, s: torch.Tensor) -> dict:
    """One Jacobi pass (``cp.jacobi_logits`` and its argmax, on the frame's
    own codes): per call from Python (CUDA events around
    ``JACOBI_TIMED_PASSES`` passes, host included) and its device span (the
    same passes captured in a CUDA graph)."""
    prefix = fused_layer.mtp_project(params, torch.cat([h, s], dim=1))
    codes = cp.predict_acoustic_codes(params, cfg, h, s).long()[None]

    def one_pass():
        return torch.argmax(cp.jacobi_logits(params, cfg, prefix, codes), dim=-1)

    return {"pass_ms": kt.call_ms(one_pass, JACOBI_TIMED_PASSES),
            "pass_device_ms": kt.graph_ms([one_pass], JACOBI_TIMED_PASSES)}


def batch_rows_witness(params: dict, cfg: CodePredictorConfig, dtype: torch.dtype, label: str) -> dict:
    """Whether ``JACOBI_WITNESS_B`` frames at once compute what each frame
    computes alone: the Jacobi codes of random frames batched against one at
    a time, one no-cache pass's hidden state (B·16 rows against 16 a frame),
    and each of its first layer's products alone on random inputs (the four
    projections by ``torch.matmul``, the attention by ``nn.gqa_attention``)
    and the 15 heads' product, as frames with the same bits. In f32 the codes must be equal; in bf16 it
    is a report: it shows which product rounds a batch's rows otherwise."""
    b, rows = JACOBI_WITNESS_B, cfg.num_acoustic + 1
    gen = torch.Generator(device=DEV).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    def frames_same_bits(fn, *args) -> int:
        whole = fn(*args)
        return sum(torch.equal(whole[i:i + 1], fn(*(t[i:i + 1] for t in args))) for i in range(b))

    h, s = rand(b, 1, cfg.embed_dim), rand(b, 1, cfg.embed_dim) * 0.02
    batch = cp.predict_acoustic_codes_jacobi_batch(params, cfg, h, s)
    alone = torch.stack([cp.predict_acoustic_codes_jacobi(params, cfg, h[i:i + 1], s[i:i + 1]) for i in range(b)])
    stack = cfg.layer_stack()
    x = rand(b, rows, cfg.hidden_size)
    hb = nn.run_layer_stack_nocache(params["layers"], x, stack)
    h1 = torch.cat([nn.run_layer_stack_nocache(params["layers"], x[i:i + 1], stack) for i in range(b)])
    layer = nn.layer_params_at(params["layers"], 0)
    ops = {key: frames_same_bits(lambda t, w=layer[key]: torch.matmul(t, w), rand(b, rows, layer[key].shape[0]))
           for key in ("qkv_proj", "o_proj", "gateup_proj", "down_proj")}
    mask = torch.tril(torch.ones((rows, rows), dtype=torch.bool, device=DEV))[None, None, None]
    ops["attention"] = frames_same_bits(lambda q, k, v: nn.gqa_attention(q, k, v, mask, stack.head_dim**-0.5),
                                        rand(b, rows, stack.num_heads, stack.head_dim),
                                        rand(b, rows, stack.num_kv_heads, stack.head_dim),
                                        rand(b, rows, stack.num_kv_heads, stack.head_dim))
    ops["heads"] = frames_same_bits(lambda t: torch.einsum("bgh,ghv->bgv", t, params["lm_heads"]),
                                    rand(b, cfg.num_acoustic, cfg.hidden_size))
    r = {"codes_equal": float((batch == alone).float().mean()),
         "hidden_frames_same_bits": sum(torch.equal(hb[i], h1[i]) for i in range(b)),
         "hidden_rel_err": rel_err(hb, h1), "ops_frames_same_bits": ops}
    phase("jacobi", f"{label} code predictor, B={b} against each frame alone: Jacobi codes equal {r['codes_equal']:.4f}"
          f"{' (bar 1)' if dtype == torch.float32 else ' (a report)'}; one no-cache pass at {b * rows} rows "
          f"against {rows}: frames with the same bits {r['hidden_frames_same_bits']}/{b}, max|err|/max "
          f"{r['hidden_rel_err']:.4e}; layer 0's products and the heads alone, frames with the same bits: "
          + ", ".join(f"{k} {n}/{b}" for k, n in ops.items()))
    if dtype == torch.float32:
        check(r["codes_equal"] == 1.0, f"{label} Jacobi at B={b} differs from its frames alone: "
              f"{batch.tolist()} against {alone.tolist()}")
    return r


def jacobi_fixture() -> dict:
    """The seeded 1.7B f32 code predictor (``cp_fixture``) with
    ``decode_mode="jacobi"`` on the card: its 4 frames one at a time, then as
    one batch of 4, must give the JAX package's codes (its sequential frames:
    a greedy fixed point equals them), and kernel 1 must not launch."""
    cfg = jacobi_cfg(cp_fixture.config())
    params = W.fuse_model_params(W.from_numpy_tree(cp_fixture.numpy_params(cfg), DEV))
    fixture = cp_fixture.load()
    xs = [(torch.from_numpy(h).to(DEV), torch.from_numpy(s).to(DEV)) for h, s in cp_fixture.numpy_inputs(cfg)]
    before = fused_layer.cp_frame.launches
    got, passes = jacobi_frames(params, cfg, xs)
    batch = cp.predict_acoustic_codes_batch(params, cfg, torch.cat([h for h, _ in xs]), torch.cat([s for _, s in xs]))
    launched = fused_layer.cp_frame.launches - before
    phase("jacobi", f"seeded 1.7B f32 code predictor, decode_mode jacobi, {len(xs)} frames: codes equal to the JAX "
          f"package's (fixture {cp_fixture.FIXTURE.name}) {got.tolist() == fixture['codes']}, passes per frame "
          f"{passes}; as one batch of {len(xs)}: equal {batch.tolist() == fixture['codes']}; kernel 1 launched "
          f"{launched} times")
    check(got.tolist() == fixture["codes"], f"Jacobi f32 differs from the JAX package's codes: {got.tolist()}")
    check(batch.tolist() == fixture["codes"], f"batched Jacobi f32 differs from the JAX codes: {batch.tolist()}")
    check(launched == 0, f"kernel 1 launched {launched} times under decode_mode jacobi")
    return {"passes": passes, "batch_witness": batch_rows_witness(params, cfg, torch.float32, "seeded 1.7B f32")}


def jacobi_code_predictors() -> dict:
    """Jacobi against the sequential route (kernel 1) on 32 random frames, at
    1.7B in bf16 and int8 and at 0.6B in bf16: phase 3's bf16 bars, the same
    bits twice (the first ``JACOBI_REPEATED_FRAMES``), the passes per frame, one pass's time and the break-even pass
    count (kernel 1's frame time over one pass's, both measured here)."""
    out = {}
    for label, variant, form in (("1.7B bf16", "1.7B", "bf16"), ("1.7B int8", "1.7B", "int8"),
                                 ("0.6B bf16", "0.6B", "bf16")):
        cfg = config_for_variant(variant, "custom_voice").code_predictor
        params = cp_params(cfg, torch.bfloat16, seed=2)
        if form == "int8":
            params = quant.quantize_code_predictor_params(params)
        gen = torch.Generator(device=DEV).manual_seed(1)
        e = cfg.embed_dim
        xs = [(torch.randn((1, 1, e), generator=gen, device=DEV).to(torch.bfloat16),
               (torch.randn((1, 1, e), generator=gen, device=DEV) * 0.02).to(torch.bfloat16))
              for _ in range(CP_FRAMES)]
        h0, s0 = xs[0]
        pack = fused_layer.CpFramePack(params, cfg, torch.bfloat16, DEV)
        frame = torch.stack([fused_layer.cp_frame(params, cfg, h, s, pack) for h, s in xs])
        k1 = kt.time_frame(fused_layer, params, cfg, h0, s0)
        jcfg = jacobi_cfg(cfg)
        launches = fused_layer.cp_frame.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        got, passes = jacobi_frames(params, jcfg, xs)
        end.record()
        torch.cuda.synchronize()
        frame_ms = start.elapsed_time(end) / CP_FRAMES
        again, _ = jacobi_frames(params, jcfg, xs[:JACOBI_REPEATED_FRAMES])
        check(fused_layer.cp_frame.launches == launches, f"{label}: kernel 1 launched under decode_mode jacobi")
        r = {"equal": (got == frame).float().mean().item(), "first_equal": int((got[:, 0] == frame[:, 0]).sum()),
             "same_bits": torch.equal(got[:JACOBI_REPEATED_FRAMES], again), "passes_mean": float(np.mean(passes)),
             "passes_max": int(max(passes)), "jacobi_ms_per_frame": frame_ms,
             "kernel1_ms": k1["ms"], "kernel1_device_ms": k1["device_ms"],
             **jacobi_pass_times(params, jcfg, h0, s0)}
        r["break_even"] = k1["ms"] / r["pass_ms"]
        r["break_even_device"] = k1["device_ms"] / r["pass_device_ms"]
        phase("jacobi", f"{label} code predictor, {CP_FRAMES} frames: Jacobi against kernel 1 share of codes equal "
              f"{r['equal']:.4f}, first codes equal {r['first_equal']}/{CP_FRAMES}, the first "
              f"{JACOBI_REPEATED_FRAMES} frames the same bits twice {r['same_bits']}; "
              f"passes per frame mean {r['passes_mean']:.2f}, max {r['passes_max']}; one pass {r['pass_ms']:.4f} ms "
              f"per call (host included), device span {r['pass_device_ms']:.4f} ms; Jacobi {frame_ms:.4f} ms/frame "
              f"against kernel 1 {k1['ms']:.4f} ms/frame per call, device span {k1['device_ms']:.4f}; break-even "
              f"passes {r['break_even']:.3f} per call, {r['break_even_device']:.3f} by device span")
        check(r["same_bits"], f"{label} Jacobi: two runs of the same frames differ")
        check_bf16_bars(r, f"{label} Jacobi against kernel 1")
        if label == "1.7B bf16":
            r["batch_witness"] = batch_rows_witness(params, jcfg, torch.bfloat16, label)
        out[label] = r
        del params, pack
        torch.cuda.empty_cache()
    return out


def jacobi_phase() -> dict:
    """Phase ``jacobi`` before the main path: the f32 fixture, the code
    predictors at 1.7B and 0.6B, kernel 4 at the no-cache stack's shapes
    (m = 16 a frame, 128 for B = 8), and the talker's tiered decode
    attention and MRoPE streams (``decode_tiers``)."""
    t0 = time.perf_counter()
    out = {"fixture": jacobi_fixture(), "code_predictors": jacobi_code_predictors(),
           "kernel4": kernel4_prompt_rows([16, 128], CP_PROJ_SHAPES, "jacobi", "the Jacobi stack's")}
    out["tiers"] = decode_tiers()
    phase("jacobi", f"phase wall time {time.perf_counter() - t0:.1f} s")
    return out


def jacobi_utterance(model: Qwen3TTS, label: str, int8: bool) -> dict:
    """A staged ``synthesize_with_timing`` of ``JACOBI_UTTERANCE_FRAMES`` frames on
    ``model``'s trees with ``decode_mode="jacobi"`` beside ``model`` itself
    (sequential), with every launch count set to 0 just before each (no
    warm run: ``run_main_path`` warmed ``model``, phase ``jacobi`` the
    Jacobi shapes): under Jacobi kernel 1 never launches, kernel 3 once a
    frame, kernel 2 9 times, and on int8 kernel 4 at 16 rows 4 times a code
    predictor layer and pass. In bf16 also ``jacobi_batch``."""
    mj = jacobi_model(model)
    opts = main_options(JACOBI_UTTERANCE_FRAMES)
    layers = model.config.code_predictor.num_hidden_layers
    out = {}
    for name, m in (("sequential", model), ("jacobi", mj)):
        torch.cuda.synchronize()
        for k in COUNTERS.values():
            k.launches = 0
        passes0 = cp.predict_acoustic_codes_jacobi.iterations
        with kernel4_launches() as (rows, _):
            t0 = time.perf_counter()
            audio, timing = m.synthesize_with_timing(TEXT, "ryan", "english", opts)
            wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in COUNTERS.items()}
        passes = cp.predict_acoustic_codes_jacobi.iterations - passes0
        r = out[name] = {"ms_per_frame": timing.generation_ms / timing.generation_frames,
                         "rtf": wall / (len(audio.samples) / OUTPUT_SAMPLE_RATE), "wall_ms": wall * 1e3,
                         "passes_per_frame": passes / JACOBI_UTTERANCE_FRAMES, "launches": launches,
                         "kernel4_rows": dict(sorted(rows.items()))}
        phase("jacobi", f"{label} {name} synthesize_with_timing, {timing.generation_frames} frames: "
              f"{r['ms_per_frame']:.3f} ms/frame, wall {r['wall_ms']:.1f} ms, RTF {r['rtf']:.4f}"
              + (f", Jacobi passes per frame {r['passes_per_frame']:.2f}" if name == "jacobi" else "")
              + f"; launches {launches}" + (f", kernel 4 by rows {r['kernel4_rows']}" if int8 else ""))
        check(timing.generation_frames == JACOBI_UTTERANCE_FRAMES and bool(np.isfinite(audio.samples).all()),
              f"{label} {name}: {timing.generation_frames} frames, finite audio {np.isfinite(audio.samples).all()}")
        check(launches["talker_step"] == JACOBI_UTTERANCE_FRAMES and launches["residual_unit"] == 9,
              f"{label} {name}: kernel 3 {launches['talker_step']} (want {JACOBI_UTTERANCE_FRAMES}), kernel 2 "
              f"{launches['residual_unit']} (want 9)")
        if name == "jacobi":
            check(launches["cp_frame"] == 0 and passes >= 2 * JACOBI_UTTERANCE_FRAMES,
                  f"{label} Jacobi: kernel 1 launched {launches['cp_frame']} times, {passes} passes")
            check(not int8 or r["kernel4_rows"].get(16) == 4 * layers * passes,
                  f"{label} Jacobi: kernel 4 at 16 rows {r['kernel4_rows'].get(16)}, want {4 * layers * passes}")
        else:
            check(launches["cp_frame"] == JACOBI_UTTERANCE_FRAMES,
                  f"{label}: kernel 1 launched {launches['cp_frame']} times")
    if not int8:
        out["batch"] = jacobi_batch(model, mj, label)
    return out


def jacobi_batch(model: Qwen3TTS, mj: Qwen3TTS, label: str) -> dict:
    """``synthesize_batch``'s loop at B = 8 (``st.BATCH_TEXTS``, stream i seed
    42 + i, ``JACOBI_BATCH_FRAMES`` frames forced) with Jacobi beside the
    sequential batch: aggregate frames/s of the loop; then each Jacobi
    stream against its B = 1 run through the same loop (share of codes
    equal, first differing (frame, code)): a report, not a gate. Phase
    ``jacobi``'s ``batch_rows_witness`` holds the batched codes equal to the
    frames alone in f32 and shows, in bf16, whether a pass's 128 rows round
    otherwise than 16: a sampled stream departs from its first differing code."""
    opts = SynthesisOptions(max_length=JACOBI_BATCH_FRAMES, min_new_tokens=JACOBI_BATCH_FRAMES, seed=42,
                            temperature=0.9)
    texts, seeds = list(st.BATCH_TEXTS), [42 + i for i in range(len(st.BATCH_TEXTS))]
    b = len(texts)
    out, frames = {}, {}
    for name, m in (("sequential", model), ("jacobi", mj)):
        group = m._prepare_batch_group("basic", texts, ["ryan"] * b, ["english"] * b, [None] * b, opts, seeds)
        passes0 = cp.predict_acoustic_codes_jacobi.iterations
        launches0 = fused_layer.cp_frame.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, counts = m._generate_batch_group(group)
        loop_s = time.perf_counter() - t0
        frames[name] = [f[:n] for f, n in zip(got, counts)]
        out[name] = {"frames_per_s": float(counts.sum()) / loop_s, "ms_per_frame": loop_s * 1e3 / int(counts.max()),
                     "passes_per_frame": (cp.predict_acoustic_codes_jacobi.iterations - passes0) / int(counts.max())}
        check(fused_layer.cp_frame.launches == launches0, f"{label} B={b} {name}: kernel 1 launched in the batch")
    shares, firsts = [], []
    for i in range(b):
        solo = batch_frames(mj, texts[i:i + 1], opts, seeds[i:i + 1])[0]
        mine = frames["jacobi"][i]
        check(solo.shape == mine.shape, f"{label} Jacobi B={b}: stream {i} frame counts differ from its B=1 run")
        differ = (solo != mine).reshape(-1)
        shares.append(float(1.0 - differ.mean()))
        firsts.append(divmod(int(np.argmax(differ)), solo.shape[1]) if differ.any() else None)
    out["share_equal_to_b1"], out["first_divergence"] = float(np.mean(shares)), firsts
    phase("jacobi", f"{label} synthesize_batch loop B={b}, {JACOBI_BATCH_FRAMES} frames: Jacobi "
          f"{out['jacobi']['frames_per_s']:.1f} aggregate frames/s ({out['jacobi']['ms_per_frame']:.2f} ms/frame, "
          f"{out['jacobi']['passes_per_frame']:.2f} passes per frame) against the sequential batch "
          f"{out['sequential']['frames_per_s']:.1f} ({out['sequential']['ms_per_frame']:.2f} ms/frame); each Jacobi "
          f"stream against its B=1 run through the same loop: share of codes equal {out['share_equal_to_b1']:.4f} "
          f"(per stream {[round(x, 4) for x in shares]}), first differing (frame, code) {firsts}; not a gate")
    return out


# A pos in each window of a 2624-row cache (256, 512, 1024, 2048, 2624).
TIER_POSITIONS = (3, 100, 255, 256, 400, 511, 512, 800, 1023, 1024, 1500, 2047, 2048, 2200, 2500, 2623)


def decode_tiers() -> dict:
    """The unfused 1.7B talker's ``talker.decode_step`` (the layer path) on a
    2624-row cache, ``decode_tiering`` on against off, at ``TIER_POSITIONS``:
    f32 codec-head argmax equal 16 of 16, hidden within F32_STEP_TOL; bf16
    phase 5's bars (argmax, HIDDEN_TOL); a step's and one layer's attention's
    device span per window. Then three equal MRoPE streams through the stack
    must give the bits of plain positions."""
    base = config_for_variant("1.7B", "custom_voice").talker
    rows = fused_layer.TALKER_STREAM_MAX_SEQ
    tiers = nn.decode_attention_tiers(rows)
    gen = torch.Generator(device=DEV).manual_seed(14)
    out = {}
    for form, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        unfused = W.init_talker_params(gen, base, dtype)
        stack = base.layer_stack()
        shape = (stack.num_layers, 1, rows, stack.num_kv_heads, stack.head_dim)
        ck0 = torch.randn(shape, generator=gen, device=DEV).to(dtype)
        cv0 = torch.randn(shape, generator=gen, device=DEV).to(dtype)
        on, off = replace(base, decode_tiering=True), replace(base, decode_tiering=False)
        argmax, h_err, times = 0, 0.0, {}
        for pos in TIER_POSITIONS:
            x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=DEV).to(dtype)
            h_on, l_on = talker.decode_step(unfused, on, x, pos, nn.KVCache(ck0.clone(), cv0.clone()))
            h_off, l_off = talker.decode_step(unfused, off, x, pos, nn.KVCache(ck0.clone(), cv0.clone()))
            argmax += int(torch.argmax(l_on)) == int(torch.argmax(l_off))
            h_err = max(h_err, rel_err(h_on, h_off))
            window = next(t for t in tiers if pos + 1 <= t)
            if window not in times:
                times[window] = tier_times(unfused, on, off, x, pos, nn.KVCache(ck0.clone(), cv0.clone()))
        bar_argmax, bar_h = (len(TIER_POSITIONS), F32_STEP_TOL) if form == "f32" else (TALKER_MIN_ARGMAX_EQUAL,
                                                                                       HIDDEN_TOL)
        phase("tiers", f"1.7B {form} talker, layer path, {rows}-row cache, {len(TIER_POSITIONS)} steps: tiered "
              f"against dense codec-head argmax equal {argmax}/{len(TIER_POSITIONS)} (bar {bar_argmax}), hidden "
              f"max|err|/max {h_err:.4e} (bar {bar_h}); by window, tiered / dense: a step's device span (a CUDA "
              f"graph of {TIER_GRAPH_STEPS} steps), one layer's attention device span (a CUDA graph), ms: "
              + ", ".join(f"{w} (pos {t['pos']}) {t['on_ms']:.3f} / {t['off_ms']:.3f}, {t['attn_on_ms']:.4f} / "
                          f"{t['attn_off_ms']:.4f}" for w, t in times.items()))
        check(argmax >= bar_argmax, f"tiered decode attention {form}: argmax equal {argmax}/{len(TIER_POSITIONS)}")
        check(h_err <= bar_h, f"tiered decode attention {form}: hidden error {h_err:.4e} > {bar_h}")
        out[form] = {"argmax_equal": argmax, "hidden_rel_err": h_err, "ms_by_window": times}
        if form == "bf16":
            out["mrope_equal_streams_same_bits"] = mrope_on_card(unfused, stack, gen)
        del unfused, ck0, cv0
        torch.cuda.empty_cache()
    return out


TIER_GRAPH_STEPS = 5


def tier_times(unfused: dict, on: TalkerConfig, off: TalkerConfig, x: torch.Tensor, pos: int,
               cache: nn.KVCache) -> dict:
    """One decode step at ``pos`` tiered and dense, each by its device span
    (``TIER_GRAPH_STEPS`` steps of the layer path captured in a CUDA graph:
    the eager step's host time, some 20-60 ms, would hide a difference of
    under a millisecond); and one layer's attention alone
    (``nn.tiered_decode_attention`` against ``nn.gqa_attention`` on the
    cache's first layer), device span."""
    stack = on.layer_stack()
    q = torch.randn((1, 1, stack.num_heads, stack.head_dim), device=DEV).to(x.dtype)
    ck, cv = cache.k[0], cache.v[0]
    mask = (torch.arange(cache.max_seq, device=DEV) <= pos)[None, None, None, None]
    scale = 1.0 / stack.head_dim**0.5
    return {"pos": pos,
            "on_ms": kt.graph_ms([lambda: talker.decode_step(unfused, on, x, pos, cache)], TIER_GRAPH_STEPS),
            "off_ms": kt.graph_ms([lambda: talker.decode_step(unfused, off, x, pos, cache)], TIER_GRAPH_STEPS),
            "attn_on_ms": kt.graph_ms([lambda: nn.tiered_decode_attention(q, ck, cv, mask, scale, pos)],
                                      kt.GRAPH_CALLS),
            "attn_off_ms": kt.graph_ms([lambda: nn.gqa_attention(q, ck, cv, mask, scale)], kt.GRAPH_CALLS)}


def mrope_on_card(unfused: dict, stack: nn.LayerStackConfig, gen: torch.Generator) -> bool:
    """A 10-row prefill of the 1.7B talker's stack (its MRoPE section) with
    three equal [3, S] streams against plain positions: the same bits."""
    x = torch.randn((1, 10, stack.hidden_size), generator=gen, device=DEV).to(unfused["norm"].dtype)
    pos = torch.arange(10, device=DEV)

    def run(**kw):
        cache = nn.init_kv_cache(stack, 1, 10, x.dtype, DEV)
        return nn.run_layer_stack(unfused["layers"], x, stack, cache, write_pos=0, self_attn_prefill=True, **kw)

    same = same_bits(run(positions=pos), run(positions=None, positions_thw=torch.stack([pos, pos, pos])))
    phase("tiers", f"MRoPE, 1.7B bf16 talker stack (section {stack.mrope_section}), 10-row prefill: three equal "
          f"streams give the bits of plain positions {same}")
    check(same, "MRoPE with three equal streams differs from plain positions on the card")
    return same


class BenchTokenizer:
    """Fixed 13-token prompt (bench.py's short-corpus length class)."""

    def encode(self, text):
        return [200 + (i * 37) % 1000 for i in range(13)]


def _on(tree, dev):
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.to(dev)
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return type(tree)(_on(v, dev) for v in tree)


def _nudge_int8_scales(tree: dict, factor: float) -> None:
    """Multiply every int8 linear's scale in ``tree`` by ``factor``, in place."""
    for v in tree.values():
        if quant.is_quantized(v):
            v["scale"].mul_(factor)
        elif isinstance(v, dict):
            _nudge_int8_scales(v, factor)


def _small_runs(
    cfg: ModelConfig, voc: vocoder.VocoderConfig, seed: int, quantize_int8: bool, frames: int, nudges=()
) -> dict:
    """The same f32 small model on the card and on the CPU (plain versions),
    and on the CPU once more for each factor in ``nudges`` by which every
    int8 scale is multiplied."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    trees = (
        W.init_talker_params(gen, cfg.talker, torch.float32),
        W.init_code_predictor_params(gen, cfg.code_predictor, torch.float32),
        vocoder.init_vocoder_params(gen, voc),
    )
    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=42, temperature=0.9)
    runs = {}
    for name, dev, factor in [("card", DEV, None), ("cpu", "cpu", None)] + [(f, "cpu", f) for f in nudges]:
        model = Qwen3TTS(cfg, *_on(trees, dev), BenchTokenizer(), vocoder_config=voc, quantize_int8=quantize_int8)
        if factor is not None:
            _nudge_int8_scales(model.talker_params, factor)
            _nudge_int8_scales(model.cp_params, factor)
        codes = model._custom_voice_session("x", "ryan", "english", opts).run_to_completion()
        runs[name] = (codes, model.decode_codes(codes).samples)
    return runs


def small_model_agrees() -> None:
    """A small f32 model whose shapes the kernels take: the card's run must
    give the CPU plain run's frames exactly and its audio within 1e-4."""
    talker_cfg = TalkerConfig(
        text_embed_dim=128, hidden_size=128, text_proj_intermediate=128,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64,
    )
    cpc = CodePredictorConfig(
        hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=64, vocab_size=256,
    )
    voc = vocoder.VocoderConfig(
        codebook_dim=32, latent_dim=48, hidden_size=32, num_layers=2, num_heads=2, head_dim=16,
        intermediate_size=64, codebook_embed_dim=16, decoder_dim=64,
    )
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="small", talker=talker_cfg, code_predictor=cpc)
    kernels = ("cp_frame", "talker_step", "residual_unit")
    before = {k: COUNTERS[k].launches for k in kernels}
    runs = _small_runs(cfg, voc, seed=5, quantize_int8=False, frames=24)
    launched = {k: COUNTERS[k].launches - before[k] for k in kernels}
    (f_cpu, a_cpu), (f_gpu, a_gpu) = runs["cpu"], runs["card"]
    same = f_cpu.shape == f_gpu.shape and bool((f_cpu == f_gpu).all())
    err = float(abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else math.inf
    phase("e2e-small", f"{len(f_gpu)} frames identical to the CPU plain run: {same}; "
          f"audio max|err| {err:.3e} (peak {float(abs(a_cpu).max()):.3e}); launches on the card {launched}")
    check(launched["talker_step"] == len(f_gpu) and launched["cp_frame"] == len(f_gpu),
          f"small model: the card's run did not take kernels 1 and 3 once a frame: {launched}")
    check(same, "small model: frames on the card differ from the CPU plain run")
    check(err <= 1e-4, f"small model: audio differs from the CPU plain run by {err:.3e}")


SMALL_TALKER = TalkerConfig(
    text_embed_dim=128, hidden_size=256, text_proj_intermediate=128,
    intermediate_size=512, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=64,
)
SMALL_VOC = vocoder.VocoderConfig(
    codebook_dim=32, latent_dim=48, hidden_size=32, num_layers=2, num_heads=2, head_dim=16,
    intermediate_size=64, codebook_embed_dim=16, decoder_dim=64,
)
# Small int8 models (widths the int8 GEMVs take: multiples of 256) and the
# code-predictor route the JAX gates give each: kernel 1; kernels 5 + 6 (the
# intermediate 768 is not a multiple of the hidden 512: no stream pack);
# kernel 7 (the dims tile by 256, but the vocab 255 is odd). Seeds whose CPU
# codes do not move under the 2^-22 scale nudge (see small_int8_agrees).
SMALL_INT8 = [
    ("frame", CodePredictorConfig(
        hidden_size=256, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, vocab_size=256), 4,
     ("cp_frame", "talker_step", "int8_matmul"), ("fused_attention_step", "fused_mlp_step", "streamed_decode_step")),
    ("layer_steps", CodePredictorConfig(
        hidden_size=512, intermediate_size=768, num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4, head_dim=64, vocab_size=256, codec_embed_dim=256), 1,
     ("fused_attention_step", "fused_mlp_step", "talker_step", "int8_matmul"), ("cp_frame", "streamed_decode_step")),
    ("streamed_step", CodePredictorConfig(
        hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, vocab_size=255), 0,
     ("streamed_decode_step", "talker_step", "int8_matmul"), ("cp_frame", "fused_attention_step", "fused_mlp_step")),
]


def small_int8_agrees(route: str, cpc: CodePredictorConfig, seed: int, kernels: tuple, absent: tuple) -> None:
    """A small f32 model in int8 on the card against the CPU, over the 6
    frames of the JAX package's own bar for its int8 kernels against its
    plain int8 path (tests/test_fused_layer.py::
    test_streamed_talker_full_pipeline_codes): the first 2 frames equal and
    >= 90% of codes. ``route``: the code predictor's route, whose kernels
    (``kernels``) must launch and ``absent`` must not.

    Matmul inputs are rounded to bf16, so a last-bit difference in an f32
    sum (the kernels sum in other orders) can move an input by a bf16 ulp.
    On random weights that may flip a near-tied code some frames in, and
    from there the runs part, whatever the kernels. So the bar holds only
    for a model without such near-ties, and the phase checks that first: the
    CPU run must give the same codes when every int8 scale is moved by one
    part in 2^22 either way (many seeds fail this within 12 frames).
    """
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="small", talker=SMALL_TALKER, code_predictor=cpc)
    counters = [COUNTERS[k] for k in kernels + absent]
    before = [k.launches for k in counters]
    nudges = (1 + 2.0**-22, 1 - 2.0**-22)
    runs = _small_runs(cfg, SMALL_VOC, seed=seed, quantize_int8=True, frames=6, nudges=nudges)
    launched = dict(zip(kernels + absent, (k.launches - b for k, b in zip(counters, before))))
    (f_cpu, _), (f_gpu, a_gpu) = runs["cpu"], runs["card"]
    stable = all(np.array_equal(runs[f][0], f_cpu) for f in nudges)
    n = min(len(f_cpu), len(f_gpu))
    share = float((f_cpu[:n] == f_gpu[:n]).mean()) if n else 0.0
    first2 = n >= 2 and bool((f_cpu[:2] == f_gpu[:2]).all())
    label = f"small int8 model, code-predictor route {route}"
    phase("e2e-small-int8", f"{label}: CPU codes unmoved by scales x (1 +- 2^-22): {stable}; {len(f_gpu)} frames "
          f"on the card, {len(f_cpu)} on the CPU: first 2 frames equal {first2}, share of equal codes {share:.4f}; "
          f"launches {launched}; audio finite {bool(np.isfinite(a_gpu).all())}")
    check(stable, f"{label}: its CPU codes move under a 2^-22 scale nudge (a near-tied model)")
    check(all(launched[k] > 0 for k in kernels), f"{label}: a kernel of the route never launched: {launched}")
    check(all(launched[k] == 0 for k in absent), f"{label}: a kernel of another route launched: {launched}")
    check(first2, f"{label}: the first 2 frames on the card differ from the CPU plain run")
    check(share >= 0.9, f"{label}: share of equal codes {share:.4f} < 0.9")


STAGED_MS_PER_FRAME: dict = {}  # run_main_path's ms a frame, by label
COUNTERS = {
    "cp_frame": fused_layer.cp_frame,
    "talker_step": fused_layer.talker_step,
    "int8_matmul": quant.int8_matmul,
    "residual_unit": fused_blocks.residual_unit,
    "residual_unit_stream": fused_blocks.residual_unit_stream,
    "fused_attention_step": fused_layer.fused_attention_step,
    "fused_mlp_step": fused_layer.fused_mlp_step,
    "streamed_decode_step": fused_layer.streamed_decode_step,
}


@contextlib.contextmanager
def timed_calls(module, name: str, kernel_call):
    """CUDA events around every call of ``module.name`` (which the path
    calls by that name) for which ``kernel_call(*args, **kwargs)`` holds:
    kernel 2's residual units (``blocks.residual_unit``, or a stream's
    ``vocoder._residual_unit_stream``, of a unit that takes the kernel),
    the per-step code predictor's steps (``fused_layer.run_fused_decode_step``:
    kernel 7, or kernels 5 + 6 per layer), to give a kernel's share of a
    run. Yields the list of (start, end) pairs."""
    spans = []
    routed = getattr(module, name)

    def timed(*args, **kwargs):
        if not kernel_call(*args, **kwargs):
            return routed(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = routed(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return y

    setattr(module, name, timed)
    try:
        yield spans
    finally:
        setattr(module, name, routed)


def _unit_takes_kernel(x, *args) -> bool:
    return fused_blocks.residual_unit_should_fuse(x)


def _every_call(*args, **kwargs) -> bool:
    return True


def run_main_path(model: Qwen3TTS, label: str, kernels: tuple, absent: tuple = ()) -> dict:
    """One warm run, then one timed run with every launch count set to 0
    just before it; the counts are read just after. Every kernel of
    ``kernels`` must launch in it, kernels 1 and 3 (the code-predictor frame,
    the talker step) once a frame where they are among them, and none of
    ``absent``."""
    opts = main_options()
    text = TEXT

    warm, _ = model.synthesize_with_timing(text, "ryan", "english", opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in COUNTERS.values():
        k.launches = 0
    with (timed_calls(blocks, "residual_unit", _unit_takes_kernel) as spans,
          timed_calls(fused_layer, "run_fused_decode_step", _every_call) as steps):
        t0 = time.perf_counter()
        audio, timing = model.synthesize_with_timing(text, "ryan", "english", opts)
        wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in COUNTERS.items()}
    torch.cuda.synchronize()
    k2_ms = sum(start.elapsed_time(end) for start, end in spans)
    per_step = ""
    if steps:
        step_ms = sum(start.elapsed_time(end) for start, end in steps)
        per_step = (f", the code predictor's {len(steps)} per-step calls {step_ms:.2f} ms by CUDA events "
                    f"({step_ms / timing.generation_frames:.3f} ms/frame)")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    samples = audio.samples
    STAGED_MS_PER_FRAME[label] = timing.generation_ms / timing.generation_frames
    check(timing.generation_frames == FRAMES, f"{label}: expected {FRAMES} frames, got {timing.generation_frames}")
    check(samples.shape == (FRAMES * SAMPLES_PER_FRAME,), f"{label}: audio shape {samples.shape}")
    check(bool(torch.isfinite(torch.from_numpy(samples)).all()), f"{label}: audio has non-finite samples")
    check(all(launches[k] > 0 for k in kernels), f"{label}: a kernel of the path never launched: {launches}")
    check(all(launches[k] == 0 for k in absent), f"{label}: a kernel of another path launched: {launches}")
    check(launches["residual_unit"] == len(spans) == 9,
          f"{label}: kernel 2 launched {launches['residual_unit']} times in {len(spans)} units, want 9")
    for name in ("cp_frame", "talker_step"):
        check(name not in kernels or launches[name] == FRAMES,
              f"{label}: kernel {name} launched {launches[name]} times, not once a frame")
    repeatable = bool((warm.samples == samples).all())
    check(repeatable, f"{label}: the timed run's audio differs from the warm run's (same seed)")
    rtf = wall / (len(samples) / OUTPUT_SAMPLE_RATE)
    phase("e2e", f"{label} timed run: prefill {timing.prefill_ms:.2f} ms, "
          f"{timing.generation_ms / timing.generation_frames:.3f} ms/frame over {timing.generation_frames} frames "
          f"(generation {timing.generation_ms:.1f} ms{per_step}), decode {timing.decode_ms:.1f} ms (kernel 2's {len(spans)} "
          f"calls {k2_ms:.2f} ms, the rest {timing.decode_ms - k2_ms:.1f}), "
          f"wall {wall * 1e3:.1f} ms, RTF {rtf:.4f}, peak allocated {peak_mb:.0f} MiB, "
          f"launches {launches}, audio peak {float(abs(samples).max()):.3e}, "
          f"audio equal to the warm run's {repeatable}")
    return launches, samples


def main_options(frames: int = FRAMES) -> SynthesisOptions:
    """The cells' options: ``frames`` frames forced, seed 42."""
    return SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=42, temperature=0.9)


def staged_reference(model: Qwen3TTS, staged: np.ndarray) -> tuple[np.ndarray, float, float]:
    """The frames of a staged session (``run_to_completion``, as
    ``synthesize_with_timing`` runs it), the staged decode's own spread
    between buckets 64 and 256 on them (``staged``: its audio at bucket 64,
    from the timed staged run), and the bar for a streamed decode of the
    same frames: ``STREAM_SPREAD_FACTOR`` times that spread (at least 1e-5
    of max|audio|, kernel 2's bar, should the spread be 0)."""
    ref = model._custom_voice_session(TEXT, "ryan", "english", main_options()).run_to_completion()
    codes = model.codes_to_tensor(ref)
    at256 = vocoder.decode_bucketed(model.vocoder_params, model.vocoder_config, codes, bucket=256)[0]
    spread = float(np.abs(at256 - staged).max()) if at256.shape == staged.shape else math.inf
    return ref, spread, max(STREAM_SPREAD_FACTOR * spread, 1e-5 * float(np.abs(staged).max()))


def _audio_line(err: float, spread: float, bar: float) -> str:
    return (f"max|audio - staged decode| {err:.3e} (bar {bar:.3e}: {STREAM_SPREAD_FACTOR:g} x the staged decode's "
            f"spread {spread:.3e} between buckets 64 and 256, at least 1e-5 of max|audio|; err/bar {err / bar:.3f})")


def stream_session(model: Qwen3TTS, label: str, staged: np.ndarray, ref: np.ndarray, spread: float, bar: float,
                   kernels: tuple) -> dict:
    """The same utterance as ``run_main_path``'s streamed: one warm session,
    then one timed session pulled chunk by chunk (``synthesize_streaming``,
    4 frames, then 10 a chunk) with every launch count set to 0 just before
    it, read just after. Kernel 2's stream entry must launch 9 times a chunk
    (its batch entry never), kernels 1 and 3 (where among ``kernels``) once
    a frame; the frames must be those of a staged session (``ref``), and
    the chunks put together the staged decode's audio (``staged``) within
    ``bar`` (``staged_reference``). TTFA: from the call until the first
    chunk's samples are on the host."""
    opts = main_options()
    list(model.synthesize_streaming(TEXT, "ryan", "english", opts))
    torch.cuda.synchronize()
    for k in COUNTERS.values():
        k.launches = 0
    with timed_calls(vocoder, "_residual_unit_stream", _unit_takes_kernel) as spans:
        t0 = time.perf_counter()
        session = model.synthesize_streaming(TEXT, "ryan", "english", opts)
        chunks, at = [], []
        for chunk in session:
            at.append(time.perf_counter())
            chunks.append(chunk.samples)
    launches = {name: k.launches for name, k in COUNTERS.items()}
    torch.cuda.synchronize()
    k2_ms = sum(start.elapsed_time(end) for start, end in spans)
    wall = at[-1] - t0
    ttfa_ms = (at[0] - t0) * 1e3
    chunk_ms = [(b - a) * 1e3 for a, b in zip(at, at[1:])]
    sizes = [len(c) // SAMPLES_PER_FRAME for c in chunks]
    frames = session.state.frames[: session.frames_generated].cpu().numpy()
    audio = np.concatenate(chunks)
    err = float(np.abs(audio - staged).max()) if audio.shape == staged.shape else math.inf
    rtf = wall / (len(audio) / OUTPUT_SAMPLE_RATE)
    phase("stream", f"{label} streaming session, {len(chunks)} chunks of {sizes} frames: TTFA {ttfa_ms:.2f} ms, "
          f"chunks after the first {', '.join(f'{t:.2f}' for t in chunk_ms)} ms, wall {wall * 1e3:.1f} ms, RTF "
          f"{rtf:.4f}; kernel 2's stream entry {launches['residual_unit_stream']} launches "
          f"({launches['residual_unit_stream'] / len(chunks):.1f} a chunk) {k2_ms:.2f} ms by CUDA events; launches "
          f"{launches}; frames equal to the staged session's {np.array_equal(frames, ref)}; "
          f"{_audio_line(err, spread, bar)}, audio peak {float(np.abs(audio).max()):.3e}")
    check(sum(sizes) == FRAMES and sizes[0] == STREAM_CHUNKS[0] and all(n == STREAM_CHUNKS[1] for n in sizes[1:-1]),
          f"{label} stream: chunk sizes {sizes}")
    check(launches["residual_unit_stream"] == 9 * len(chunks) == len(spans),
          f"{label} stream: kernel 2's stream entry launched {launches['residual_unit_stream']} times in "
          f"{len(chunks)} chunks, want 9 a chunk")
    check(launches["residual_unit"] == 0, f"{label} stream: kernel 2's batch entry launched")
    for name in ("cp_frame", "talker_step"):
        check(name not in kernels or launches[name] == FRAMES,
              f"{label} stream: kernel {name} launched {launches[name]} times, not once a frame")
    check(np.array_equal(frames, ref), f"{label} stream: frames differ from the staged session's")
    check(err <= bar, f"{label} stream: audio {err:.3e} from the staged decode (bar {bar:.3e})")
    return {"launches": launches, "ttfa_ms": ttfa_ms, "chunk_ms": chunk_ms, "rtf": rtf, "k2_ms": k2_ms}


def voice_session(model: Qwen3TTS, label: str, staged: np.ndarray, spread: float, bar: float,
                  kernels: tuple) -> dict:
    """``synthesize_with_voice``, the port's default entry point
    (``run_to_audio``: chunks of ``DECODE_BUCKET`` frames on the streaming
    vocoder), on the same utterance: one warm call, then one timed call
    with every launch count set to 0 just before it, read just after.
    Kernel 2's stream entry must launch 9 times a chunk (its batch entry
    never), kernels 1 and 3 (where among ``kernels``) once a frame; the
    audio must equal the warm call's bit for bit and the staged decode's
    (``staged``) within ``bar``. Wall time (the call, audio on the host) and
    RTF."""
    opts = main_options()
    warm = model.synthesize_with_voice(TEXT, "ryan", "english", opts).samples
    torch.cuda.synchronize()
    for k in COUNTERS.values():
        k.launches = 0
    with timed_calls(vocoder, "_residual_unit_stream", _unit_takes_kernel) as spans:
        t0 = time.perf_counter()
        audio = model.synthesize_with_voice(TEXT, "ryan", "english", opts).samples
        wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in COUNTERS.items()}
    torch.cuda.synchronize()
    k2_ms = sum(start.elapsed_time(end) for start, end in spans)
    chunks = -(-FRAMES // DECODE_BUCKET)
    err = float(np.abs(audio - staged).max()) if audio.shape == staged.shape else math.inf
    repeatable = audio.shape == warm.shape and bool((audio == warm).all())
    rtf = wall / (len(audio) / OUTPUT_SAMPLE_RATE)
    phase("voice", f"{label} synthesize_with_voice, {chunks} chunks of up to {DECODE_BUCKET} frames: wall "
          f"{wall * 1e3:.1f} ms, RTF {rtf:.4f}; kernel 2's stream entry {launches['residual_unit_stream']} launches "
          f"{k2_ms:.2f} ms by CUDA events; launches {launches}; audio equal to the warm call's {repeatable}; "
          f"{_audio_line(err, spread, bar)}")
    check(audio.shape == (FRAMES * SAMPLES_PER_FRAME,), f"{label} voice: audio shape {audio.shape}")
    check(launches["residual_unit_stream"] == 9 * chunks == len(spans),
          f"{label} voice: kernel 2's stream entry launched {launches['residual_unit_stream']} times in "
          f"{chunks} chunks, want 9 a chunk")
    check(launches["residual_unit"] == 0, f"{label} voice: kernel 2's batch entry launched")
    for name in ("cp_frame", "talker_step"):
        check(name not in kernels or launches[name] == FRAMES,
              f"{label} voice: kernel {name} launched {launches[name]} times, not once a frame")
    check(repeatable, f"{label} voice: the timed call's audio differs from the warm call's (same seed)")
    check(err <= bar, f"{label} voice: audio {err:.3e} from the staged decode (bar {bar:.3e})")
    return {"launches": launches, "wall_ms": wall * 1e3, "rtf": rtf}


def grown_session(model: Qwen3TTS) -> None:
    """A 300-frame session whose buffers grow once (256 -> 512 frames: the
    talker cache 288 -> 544 rows, kernel 3 on both) against a session that
    holds 512 frames from the start: token for token."""
    import qwen3_tts_tpu_torch.pipeline as pipeline

    opts = main_options(GROWN_FRAMES)
    grown = model._custom_voice_session(TEXT, "ryan", "english", opts)
    rows = [grown.state.cache.max_seq]
    t0 = time.perf_counter()
    got = grown.run_to_completion()
    t_grown = time.perf_counter() - t0
    rows.append(grown.state.cache.max_seq)
    initial = pipeline.GROWTH_INITIAL_FRAMES
    pipeline.GROWTH_INITIAL_FRAMES = 4096
    try:
        full = model._custom_voice_session(TEXT, "ryan", "english", opts)
    finally:
        pipeline.GROWTH_INITIAL_FRAMES = initial
    full_rows = full.state.cache.max_seq
    t0 = time.perf_counter()
    want = full.run_to_completion()
    t_full = time.perf_counter() - t0
    same = got.shape == want.shape == (GROWN_FRAMES, 16) and bool((got == want).all())
    phase("grow", f"1.7B bf16, {GROWN_FRAMES} frames: cache {rows[0]} -> {rows[1]} rows grown ({t_grown * 1e3:.1f} ms) "
          f"against {full_rows} rows from the start ({t_full * 1e3:.1f} ms): token-exact {same}")
    check(rows == [288, 544] and full_rows == 544, f"grown session: cache rows {rows}, full {full_rows}")
    check(same, "grown session: frames differ from the full-size session's")


def kernel2_stream() -> dict:
    """Kernel 2's stream entry (``fused_blocks.residual_unit_stream``) at
    C = 384 / 192 / 96 and dilations 1 / 3 / 9 over a streaming session's
    first two chunks (4, then 10 frames) and over ``synthesize_with_voice``'s
    first two (64 frames each): the chunks put together against one batch
    call of kernel 2 on all rows (the JAX package's bar: the same bits; a
    difference is reported and held to 1e-5 * max|x|), and each chunk
    against the plain version within 1e-5 * max|x|; each chunk size timed
    once a unit by its device span (CUDA graph), per call from Python,
    beside the plain version and the library yardstick (cuDNN's dilated
    conv plus one matmul) on the same rows, with the card's 3xTF32 bound
    for a chunk's 9 units: the carry's rows read, only the chunk's rows
    computed and written. Returns its row of the kernels line."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    keys = ("device_ms", "ms", "plain_ms", "library_ms")
    per_chunk = {f: dict.fromkeys(keys + ("bytes", "ops"), 0.0) for f in STREAM_CHUNKS + VOICE_CHUNKS}
    worst_plain = worst_batch = 0.0
    all_equal = True
    for c, per in UNIT_ROWS_PER_FRAME.items():
        for dil in kt.RU_DILATIONS:
            p = kt.unit_params(gen, c)
            for seq in (STREAM_CHUNKS, VOICE_CHUNKS):
                x = torch.randn((1, sum(seq) * per, c), generator=gen, device=DEV)
                batch = fused_blocks.residual_unit(x, p, dil)
                carry = plain_carry = torch.zeros((1, 6 * dil, c), device=DEV)
                outs, at, err, spans = [], 0, 0.0, []
                for i, f in enumerate(seq):
                    xc = x[:, at:at + f * per]
                    y, new = fused_blocks.residual_unit_stream(xc, carry, p, dil)
                    want, plain_carry = fused_blocks.residual_unit_stream_plain(xc, plain_carry, p, dil)
                    err = max(err, (y - want).abs().max().item())
                    if f not in seq[:i]:
                        fn = lambda: fused_blocks.residual_unit_stream(xc, carry, p, dil)  # noqa: E731
                        r = per_chunk[f]
                        spans.append(kt.graph_ms([fn], 5))
                        r["device_ms"] += spans[-1]
                        r["ms"] += time_ms(fn, iters=5)
                        r["plain_ms"] += time_ms(
                            lambda: fused_blocks.residual_unit_stream_plain(xc, carry, p, dil), iters=3)
                        r["library_ms"] += time_ms(kt.library_unit(xc, p, dil), iters=5)
                        # [carry | chunk] read, the chunk's rows written, the weights; the
                        # MACs of both convs for the chunk's rows.
                        r["bytes"] += 4 * (carry.shape[1] + 2 * xc.shape[1]) * c + nbytes(p)
                        r["ops"] += 2 * xc.shape[1] * c * c * 8
                    outs.append(y)
                    carry, at = new, at + f * per
                got = torch.cat(outs, dim=1)
                torch.cuda.synchronize()
                equal = torch.equal(got, batch)
                diff = (got - batch).abs().max().item()
                tol = 1e-5 * x.abs().max().item()
                phase("kernel2-stream", f"C={c} dilation={dil}, chunks of {seq} frames ({per} rows a frame): "
                      f"bit-equal to one batch call {equal} (max|diff| {diff:.3e}), max|err| against the plain "
                      f"version {err:.3e} (atol {tol:.3e}); device span a chunk size "
                      f"{', '.join(f'{t:.4f}' for t in spans)} ms")
                check(err <= tol, f"kernel 2 stream C={c} dilation={dil} {seq}: max|err| {err:.3e} > {tol:.3e}")
                check(equal or diff <= tol,
                      f"kernel 2 stream C={c} dilation={dil} {seq}: {diff:.3e} from the batch call")
                all_equal &= equal
                worst_plain, worst_batch = max(worst_plain, err), max(worst_batch, diff)
                del x, batch, got, outs
    bounds = {f: bound(r["bytes"], 3 * r["ops"], "tf32") for f, r in per_chunk.items()}
    for f, r in per_chunk.items():
        phase("kernel2-stream", f"a {f}-frame chunk's 9 units: device spans {r['device_ms']:.4f} ms, per call "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library (conv1d + matmul, no snakes) "
              f"{r['library_ms']:.4f}; 3xTF32 bound {bounds[f]['bound_ms']:.4f} ms ({bounds[f]['bound_by']})")
    steady, voice = per_chunk[STREAM_CHUNKS[1]], per_chunk[VOICE_CHUNKS[0]]
    return {
        "name": "residual_unit_stream", "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/residual_unit.cu",
        "replaces": "qwen3_tts_tpu/models/codec/fused_blocks.py:177", "launches": 0, "path": "stream_bf16",
        "max_abs_err": worst_plain, "batch_max_abs_diff": worst_batch, "batch_bit_equal": all_equal,
        "ms": steady["ms"], "device_ms": steady["device_ms"], "plain_ms": steady["plain_ms"],
        **bounds[STREAM_CHUNKS[1]], "library_ms": steady["library_ms"],
        "first_chunk_device_ms": per_chunk[STREAM_CHUNKS[0]]["device_ms"],
        "voice_chunk_device_ms": voice["device_ms"], "voice_chunk_plain_ms": voice["plain_ms"],
        "voice_chunk_library_ms": voice["library_ms"], "voice_chunk_bound_ms": bounds[VOICE_CHUNKS[0]]["bound_ms"],
    }


# Voice cloning and voice design (the encoders and the clone / design
# sessions at 1.7B).
CLONE_TEXT = "The reference speaker said these words."


def encoders_check() -> tuple:
    """The two encoders of voice cloning at full width (the speaker encoder
    at the 1.7B Base checkpoint's enc_dim 2048, Mimi at its default
    config), built on the card from ``encoder_fixture``'s seeded trees
    through ``models.weights``' converters, in f32, on the fixture's two
    references (24 kHz, and 16 kHz resampled on the host): the x-vectors
    within 1e-5 of max|x| and the codes equal to the JAX package's (the
    committed fixture; a differing code is reported with its distance
    margin). Each encoder's device forward timed by CUDA events beside its
    whole ``encode`` (the speaker encoder's mel is host numpy). Returns the
    encoders."""
    spk = SpeakerEncoder(W.speaker_encoder_from_numpy(encoder_fixture.speaker_numpy_params(
        encoder_fixture.speaker_config()), DEV), encoder_fixture.speaker_config())
    mimi = Encoder12Hz(W.mimi_encoder_from_numpy(encoder_fixture.mimi_numpy_params(encoder_fixture.mimi_config()),
                                                 DEV), encoder_fixture.mimi_config())
    want = encoder_fixture.load()
    for rate in encoder_fixture.RATES:
        audio = AudioBuffer(encoder_fixture.reference_audio(rate), rate)
        if rate != OUTPUT_SAMPLE_RATE:
            audio = resample_to_24k(audio)
        xvec, codes = spk.encode(audio.samples), mimi.encode(audio.samples)
        wx, wc = want[f"xvector_{rate}"], want[f"codes_{rate}"]
        err = float(np.abs(xvec - wx).max())
        tol = 1e-5 * float(np.abs(wx).max())
        diff = np.argwhere(codes != wc) if codes.shape == wc.shape else np.zeros((0, 2), int)
        margins = [float(want[f"margin_{rate}"][t, q]) for t, q in diff]
        mel = torch.from_numpy(spk.mel.compute_for_speaker_encoder(audio.samples)).to(DEV)[None]
        samples = torch.from_numpy(audio.samples).to(DEV)[None]
        with torch.no_grad():
            spk_ms = time_ms(lambda: speaker.forward(spk.params, spk.cfg, mel), iters=5)
            mimi_ms = time_ms(lambda: mimi_encoder.forward(mimi.params, mimi.cfg, samples), iters=5)
        t0 = time.perf_counter()
        spk.encode(audio.samples)
        spk_wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mimi.encode(audio.samples)
        mimi_wall = (time.perf_counter() - t0) * 1e3
        phase("encoders", f"{rate} Hz reference ({len(audio.samples)} samples at 24 kHz): x-vector [{len(xvec)}] "
              f"max|err| {err:.3e} (bar {tol:.3e}); codes {codes.shape}, {len(diff)} differ from the fixture "
              f"(margins {margins}; least margin in the fixture {want[f'margin_{rate}'].min():.4f}); speaker "
              f"encoder forward {spk_ms:.3f} ms on the card ({mel.shape[-1]} mel frames), encode {spk_wall:.1f} "
              f"ms with the host mel; Mimi forward {mimi_ms:.3f} ms, encode {mimi_wall:.1f} ms")
        check(xvec.shape == wx.shape and err <= tol, f"speaker encoder {rate} Hz: max|err| {err:.3e} > {tol:.3e}")
        check(codes.shape == wc.shape and not len(diff),
              f"Mimi encoder {rate} Hz: codes {codes.shape} differ at {diff.tolist()} (margins {margins})")
    return spk, mimi


def clone_options(**kw) -> SynthesisOptions:
    """``main_options``, seed 42, every frame forced; ICL clamps its length
    to max(75, 6 x text tokens) = 78 for the 13-token prompt."""
    return replace(main_options(), **kw)


def _decode_cut(model: Qwen3TTS, prefix: np.ndarray | None, frames: np.ndarray, bucket: int) -> np.ndarray:
    """The batch decode of [prefix || frames] at ``bucket``, the prefix's
    samples cut (the frames alone without a prefix)."""
    codes = frames if prefix is None else np.concatenate([prefix, frames])
    wav = vocoder.decode_bucketed(model.vocoder_params, model.vocoder_config, model.codes_to_tensor(codes),
                                  bucket=bucket)[0]
    return wav if prefix is None else wav[len(prefix) * SAMPLES_PER_FRAME:]


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for k in COUNTERS.values():
        k.launches = 0


def _counts() -> dict:
    torch.cuda.synchronize()
    return {name: k.launches for name, k in COUNTERS.items()}


def _prefix_pieces(n: int, chunk: int) -> int:
    """How many streaming-vocoder calls ``_feed_prefix`` makes for n frames."""
    return n // chunk + bin(n % chunk).count("1")


def clone_case(label: str, start, prefix: np.ndarray | None, prompt_rows: int, kernels: tuple) -> dict:
    """One clone or design session kind, ``start(options)`` giving its
    session (the prefix set where there is one): staged first (prefill ms,
    ms/frame), then ``run_to_audio`` (what ``synthesize_voice_clone`` /
    ``synthesize_voice_design`` run) with every launch count set to 0 just
    before it, read just after: kernels 1 and 3 once a frame, kernel 2's
    stream entry 9 times a vocoder call (the prefix's pieces and the
    chunks), its batch entry never, kernel 4 (where among ``kernels``) in
    the prefill and the codec head. The frames must be the staged ones, the
    audio within ``STREAM_SPREAD_FACTOR`` x the staged decode's own spread
    between buckets 64 and 256 of the staged decode of [prefix || frames]
    with the prefix cut. Returns the frames, the audio and the bar."""
    opts = clone_options()
    t0 = time.perf_counter()
    staged = start(opts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frames = staged.run_to_completion()
    t2 = time.perf_counter()
    n = len(frames)
    ref64 = _decode_cut(staged.model, prefix, frames, 64)
    ref256 = _decode_cut(staged.model, prefix, frames, 256)
    spread = float(np.abs(ref64 - ref256).max())
    bar = max(STREAM_SPREAD_FACTOR * spread, 1e-5 * float(np.abs(ref64).max()))
    _reset_counts()
    with timed_calls(vocoder, "_residual_unit_stream", _unit_takes_kernel) as spans:
        t3 = time.perf_counter()
        session = start(opts)
        audio = session.run_to_audio().samples
        wall = time.perf_counter() - t3
    launches = _counts()
    k2_ms = sum(a.elapsed_time(b) for a, b in spans)
    got = session.state.frames[:session.frames_emitted].cpu().numpy()
    calls = -(-n // DECODE_BUCKET) + (0 if prefix is None else _prefix_pieces(len(prefix), DECODE_BUCKET))
    err = float(np.abs(audio - ref64).max()) if audio.shape == ref64.shape else math.inf
    rtf = wall / (len(audio) / OUTPUT_SAMPLE_RATE)
    phase("clone", f"{label}: {prompt_rows} prompt rows, prefill {(t1 - t0) * 1e3:.2f} ms, "
          f"{(t2 - t1) * 1e3 / n:.3f} ms/frame over {n} frames; run_to_audio wall {wall * 1e3:.1f} ms, RTF "
          f"{rtf:.4f}, kernel 2's stream entry {launches['residual_unit_stream']} launches in {calls} vocoder calls "
          f"({k2_ms:.2f} ms by CUDA events); launches {launches}; frames equal to the staged session's "
          f"{np.array_equal(got, frames)}; {_audio_line(err, spread, bar)}")
    check(n > 0 and np.array_equal(got, frames), f"{label}: frames differ from the staged session's")
    check(audio.shape == (n * SAMPLES_PER_FRAME,), f"{label}: audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), f"{label}: audio has non-finite samples")
    for name in ("cp_frame", "talker_step"):
        check(launches[name] == n, f"{label}: kernel {name} launched {launches[name]} times, not once a frame")
    check(launches["residual_unit_stream"] == 9 * calls == len(spans) and launches["residual_unit"] == 0,
          f"{label}: kernel 2's stream entry launched {launches['residual_unit_stream']} times, want 9 x {calls}")
    check(("int8_matmul" in kernels) == (launches["int8_matmul"] > 0), f"{label}: kernel 4 launches {launches}")
    check(err <= bar, f"{label}: audio {err:.3e} from the staged decode (bar {bar:.3e})")
    return {"frames": frames, "audio": audio, "bar": bar, "spread": spread, "launches": launches,
            "prefill_ms": (t1 - t0) * 1e3, "ms_per_frame": (t2 - t1) * 1e3 / n, "rtf": rtf}


def clone_stream(label: str, start, prefix: np.ndarray, whole: dict) -> dict:
    """The same ICL session streamed (``synthesize_voice_clone_streaming``:
    the prefix fed in pieces of the first chunk's 4 frames, then 4, then 10
    frames a chunk) with every launch count set to 0 just before it: TTFA
    (the prefix feed included), chunk times, RTF; kernel 2's stream entry 9
    times a vocoder call, kernels 1 and 3 once a frame; the frames those of
    the whole synthesis and the chunks put together its audio within its
    bar (``STREAM_SPREAD_FACTOR`` x the staged decode's spread)."""
    opts = clone_options()
    _reset_counts()
    t0 = time.perf_counter()
    session = start(opts)
    chunks, at = [], []
    for chunk in session:
        at.append(time.perf_counter())
        chunks.append(chunk.samples)
    launches = _counts()
    n = session.frames_generated
    frames = session.state.frames[:n].cpu().numpy()
    sizes = [len(c) // SAMPLES_PER_FRAME for c in chunks]
    audio = np.concatenate(chunks)
    calls = len(chunks) + _prefix_pieces(len(prefix), STREAM_CHUNKS[0])
    err = float(np.abs(audio - whole["audio"]).max()) if audio.shape == whole["audio"].shape else math.inf
    ttfa_ms = (at[0] - t0) * 1e3
    chunk_ms = [(b - a) * 1e3 for a, b in zip(at, at[1:])]
    rtf = (at[-1] - t0) / (len(audio) / OUTPUT_SAMPLE_RATE)
    phase("clone-stream", f"{label} streamed, {len(chunks)} chunks of {sizes} frames after {len(prefix)} reference "
          f"frames: TTFA {ttfa_ms:.2f} ms, chunks after the first {', '.join(f'{t:.2f}' for t in chunk_ms)} ms, "
          f"RTF {rtf:.4f}; launches {launches} ({calls} vocoder calls); frames equal to the whole synthesis's "
          f"{np.array_equal(frames, whole['frames'])}; max|stream - whole| {err:.3e} (bar {whole['bar']:.3e}, "
          f"err/bar {err / whole['bar']:.3f})")
    check(np.array_equal(frames, whole["frames"]), f"{label} stream: frames differ from the whole synthesis's")
    check(sum(sizes) == n and sizes[0] == STREAM_CHUNKS[0], f"{label} stream: chunk sizes {sizes}")
    for name in ("cp_frame", "talker_step"):
        check(launches[name] == n, f"{label} stream: kernel {name} launched {launches[name]} times")
    check(launches["residual_unit_stream"] == 9 * calls and launches["residual_unit"] == 0,
          f"{label} stream: kernel 2's stream entry launched {launches['residual_unit_stream']} times, want 9 x {calls}")
    check(err <= whole["bar"], f"{label} stream: audio {err:.3e} from the whole synthesis (bar {whole['bar']:.3e})")
    return {"launches": launches, "ttfa_ms": ttfa_ms, "chunk_ms": chunk_ms, "rtf": rtf}


def clone_and_design(model: Qwen3TTS, label: str, encoders: tuple, kernels: tuple) -> dict:
    """The 1.7B trees of ``model`` as a Base checkpoint (with the fixture's
    encoders) and as a VoiceDesign checkpoint: an x-vector clone, an ICL
    clone (overlaid and sequential; whole and streamed) from the fixture's
    3 s reference, and a voice-design synthesis, each by ``clone_case`` /
    ``clone_stream``. Returns the kernel-4 rows of the prompts (m) seen."""
    base = Qwen3TTS(replace(model.config, model_type=ModelType.BASE, speaker_encoder=encoders[0].cfg),
                    model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer, *encoders,
                    vocoder_config=model.vocoder_config)
    design = Qwen3TTS(replace(model.config, model_type=ModelType.VOICE_DESIGN), model.talker_params,
                      model.cp_params, model.vocoder_params, model.tokenizer, vocoder_config=model.vocoder_config)
    t0 = time.perf_counter()
    icl = base.create_voice_clone_prompt(AudioBuffer(encoder_fixture.reference_audio(24000), 24000), CLONE_TEXT)
    prompt_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(icl.ref_codes, encoder_fixture.load()["codes_24000"]),
          f"{label}: create_voice_clone_prompt's codes differ from the fixture's")
    xvec = VoiceClonePrompt(icl.speaker_embedding)
    instruct = "A warm, low voice, speaking slowly."
    ids, chatml = model.tokenizer.encode(TEXT), model.tokenizer.encode(f"<|im_start|>user\n{instruct}<|im_end|>\n")
    t_ref, n_text = len(icl.ref_codes), len(icl.ref_text_ids) + len(ids) + 1
    icl_rows = 9 + next_bucket(t_ref + 1, 32)
    # The prompts' rows as the sessions pad them (the kernel-4 m of their prefill).
    rows = {"x-vector": 10, "ICL": icl_rows, "ICL sequential": icl_rows + next_bucket(n_text, 32),
            "voice design": next_bucket(len(chatml), 32) + 9}
    phase("clone", f"{label}: create_voice_clone_prompt {prompt_ms:.1f} ms (3 s at 24 kHz: x-vector and "
          f"{t_ref} frames of codes, equal to the fixture's)")
    out = {"x-vector": clone_case(f"{label} x-vector clone", lambda o: base._voice_clone_session(TEXT, xvec, "english", o),
                                  None, rows["x-vector"], kernels)}
    for name, seq in (("ICL", False), ("ICL sequential", True)):
        def start(o, seq=seq):
            return base._voice_clone_session(TEXT, icl, "english", replace(o, icl_sequential=seq))
        whole = clone_case(f"{label} {name} clone", start, icl.ref_codes, rows[name], kernels)
        out[name] = whole
        out[f"{name} streamed"] = clone_stream(f"{label} {name} clone", start, icl.ref_codes, whole)
    out["voice design"] = clone_case(
        f"{label} voice design",
        lambda o: design._voice_design_session(TEXT, instruct, "english", o),
        None, rows["voice design"], kernels)
    del base, design
    return {"rows": rows, "runs": out}


@contextlib.contextmanager
def _stream_units(route):
    """The streaming vocoder's units that take kernel 2 through ``route(x,
    carry, p, dilation)`` (the rest unchanged)."""
    routed = vocoder._residual_unit_stream

    def unit(x, st, p, dilation):
        return route(x, st, p, dilation) if _unit_takes_kernel(x) else routed(x, st, p, dilation)

    vocoder._residual_unit_stream = unit
    try:
        yield
    finally:
        vocoder._residual_unit_stream = routed


def _feed_pieces(model: Qwen3TTS, prefix: torch.Tensor, sizes: list) -> list:
    """The prefix fed to a fresh streaming-vocoder state in pieces of
    ``sizes``; returns each piece's audio."""
    state = vocoder.init_stream_state(model.vocoder_config, DECODE_BUCKET + len(prefix), device=DEV)
    wavs, at = [], 0
    for size in sizes:
        wav, state = vocoder.decode_stream_chunk(model.vocoder_params, model.vocoder_config, state,
                                                 prefix[at:at + size].T[None])
        wavs.append(wav)
        at += size
    return wavs


def prefix_pieces_timing(model: Qwen3TTS) -> dict:
    """Kernel 2's stream entry on the ICL prefix's pieces: the fixture's
    38 reference frames fed to a fresh streaming-vocoder state as
    ``run_to_audio`` feeds them (2, 4, 32 frames) and as a stream with a
    4-frame first chunk does (9 x 4, then 2; ``prefix_piece_sizes``), each
    piece's decode and its 9 stream-entry units timed by CUDA events. Then
    the same pieces again, each unit's kernel output held to the plain
    version on the same inputs (within 1e-5 * max|x|, the carry equal) and
    timed beside it, the library yardstick and the 3xTF32 bound, and each
    piece's audio held to that of a stream on the plain units (within 1e-5
    of max|audio|)."""
    prefix = torch.from_numpy(encoder_fixture.load()["codes_24000"].astype(np.int64)).to(DEV)
    out = {}
    for chunk in (DECODE_BUCKET, STREAM_CHUNKS[0]):
        sizes = prefix_piece_sizes(len(prefix), chunk)
        state = vocoder.init_stream_state(model.vocoder_config, DECODE_BUCKET + len(prefix), device=DEV)
        events, at = [], 0
        with timed_calls(vocoder, "_residual_unit_stream", _unit_takes_kernel) as spans:
            for size in sizes:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                before = len(spans)
                start.record()
                _, state = vocoder.decode_stream_chunk(model.vocoder_params, model.vocoder_config, state,
                                                       prefix[at:at + size].T[None])
                end.record()
                events.append((start, end, before))
                at += size
            torch.cuda.synchronize()
            timed = [(s.elapsed_time(e), sum(a.elapsed_time(b) for a, b in spans[i:i + 9])) for s, e, i in events]
        units = []  # every unit that takes kernel 2, in launch order

        def held(x, st, p, dilation):
            y, carry = fused_blocks.residual_unit_stream(x, st, p, dilation)
            want, want_carry = fused_blocks.residual_unit_stream_plain(x, st, p, dilation)
            c = x.shape[-1]
            units.append({
                "rows": x.shape[1], "err": (y - want).abs().max().item(), "tol": 1e-5 * x.abs().max().item(),
                "carry_equal": torch.equal(carry, want_carry),
                "plain_ms": time_ms(lambda: fused_blocks.residual_unit_stream_plain(x, st, p, dilation), iters=3),
                "library_ms": time_ms(kt.library_unit(x, p, dilation), iters=3),
                # [carry | piece] read, the piece's rows written, the weights;
                # the MACs of both convs for the piece's rows.
                "bytes": 4 * (st.shape[1] + 2 * x.shape[1]) * c + nbytes(p), "ops": 2 * x.shape[1] * c * c * 8})
            return y, carry

        with _stream_units(held):
            got = _feed_pieces(model, prefix, sizes)
        with _stream_units(fused_blocks.residual_unit_stream_plain):
            want = _feed_pieces(model, prefix, sizes)
        audio = [((g - w).abs().max().item(), 1e-5 * w.abs().max().item()) for g, w in zip(got, want)]
        check(len(units) == 9 * len(sizes), f"prefix pieces of {chunk}: {len(units)} units took kernel 2")
        rows = []
        for i, (size, (call_ms, k2_ms)) in enumerate(zip(sizes, timed)):
            group = units[9 * i:9 * i + 9]
            rows.append({"frames": size, "call_ms": call_ms, "ms": k2_ms,
                         "plain_ms": sum(u["plain_ms"] for u in group),
                         "library_ms": sum(u["library_ms"] for u in group),
                         **bound(sum(u["bytes"] for u in group), 3 * sum(u["ops"] for u in group), "tf32")})
        worst = max(units, key=lambda u: u["err"] / u["tol"])
        out[chunk] = {"pieces": rows, "max_abs_err": max(u["err"] for u in units),
                      "audio_max_abs_err": max(e for e, _ in audio)}
        phase("clone-prefix", f"the 38-frame prefix in pieces of up to {chunk}: " + "; ".join(
            f"{r['frames']} frames {r['call_ms']:.2f} ms (kernel 2's 9 units {r['ms']:.2f}, plain "
            f"{r['plain_ms']:.2f}, library {r['library_ms']:.2f}, 3xTF32 bound {r['bound_ms']:.4f})" for r in rows)
            + f"; {len(units)} units against the plain version on the same inputs: worst max|err| "
            f"{worst['err']:.3e} (bar {worst['tol']:.3e}, {worst['rows']} rows), carries equal "
            f"{all(u['carry_equal'] for u in units)}; each piece's audio against a stream on the plain units: "
            + ", ".join(f"{e:.3e} (bar {b:.3e})" for e, b in audio))
        for u in units:
            check(u["err"] <= u["tol"] and u["carry_equal"], f"prefix pieces of {chunk}: kernel 2's stream entry "
                  f"on {u['rows']} rows: max|err| {u['err']:.3e} (bar {u['tol']:.3e}), carry equal {u['carry_equal']}")
        for size, (err, tol) in zip(sizes, audio):
            check(err <= tol, f"prefix pieces of {chunk}: a {size}-frame piece's audio {err:.3e} from the "
                  f"plain units' (bar {tol:.3e})")
    return out


def kernel4_prompt_rows(ms: list, shapes=TALKER_PROJ_SHAPES, name: str = "kernel4-prompt",
                        whose: str = "the talker's") -> list:
    """Kernel 4 at rows ``ms`` (the clone and design prefills' prompts), at
    ``shapes`` (the 1.7B talker's four projection shapes), printed as phase
    ``name``: against its plain version
    (one bf16 ulp of the output's scale), timed by ``kt.time_shape`` beside
    ``torch.matmul`` on the dequantized weight and the plain version, with
    the bound."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    out = []
    for m in ms:
        for k, n in shapes:
            x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
            w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=DEV) * 0.02)
            got = quant.int8_matmul(x, w["q8"], w["scale"])
            want = quant.int8_matmul_plain(x, w["q8"], w["scale"])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = want.float().abs().max().item() * 2.0**-7
            times = {**kt.time_shape(quant, x, w),
                     "plain_ms": time_ms(lambda: quant.int8_matmul_plain(x, w["q8"], w["scale"]), iters=20)}
            b = bound(nbytes(x, w) + m * n * x.element_size(), 2 * m * k * n)
            plan = quant.int8_matmul_plan(m, k, n, sms)
            phase(name, f"kernel 4 at {whose} m={m} K={k} N={n} (tier {plan.tier}, {plan.splits} K splits): max|err| "
                  f"{err:.4e} (bar {tol:.4e}); device span: kernel {times['device_ms']:.4f} ms, torch.matmul on the "
                  f"dequantized weight {times['library_device_ms']:.4f} ms; per call: kernel {times['ms']:.4f}, "
                  f"library {times['library_ms']:.4f}, plain {times['plain_ms']:.4f}; bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})")
            check(err <= tol, f"kernel 4 m={m} K={k} N={n}: max|err| {err:.4e} > {tol:.4e}")
            out.append({"m": m, "k": k, "n": n, "tier": plan.tier, "max_abs_err": err, **times, **b})
    return out


def layer_path_past_gate(model: Qwen3TTS) -> None:
    """Past kernel 3's gate (``TALKER_STREAM_MAX_SEQ`` rows: a long prompt
    at 2048 frames) the fused tree's steps take the layer path: one bf16
    step at a 2656-row cache, which must launch no kernel 3, against kernel
    3 at a 2624-row cache of the same rows: hidden within HIDDEN_TOL of the
    scale (the argmax reported: bf16 sums in another order can flip a
    near-tie)."""
    params, cfg = model.talker_params, model.config.talker
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    pos = fused_layer.TALKER_STREAM_MAX_SEQ - 40
    x = torch.randn((1, 1, cfg.hidden_size), generator=gen, device=DEV).to(model.compute_dtype)
    big = nn.init_kv_cache(cfg.layer_stack(), 1, fused_layer.TALKER_STREAM_MAX_SEQ + 32, model.compute_dtype, DEV)
    big.k[:, :, :pos] = torch.randn(big.k[:, :, :pos].shape, generator=gen, device=DEV).to(big.k.dtype)
    big.v[:, :, :pos] = torch.randn(big.v[:, :, :pos].shape, generator=gen, device=DEV).to(big.v.dtype)
    small = nn.KVCache(big.k[:, :, :fused_layer.TALKER_STREAM_MAX_SEQ].clone(),
                       big.v[:, :, :fused_layer.TALKER_STREAM_MAX_SEQ].clone())
    check(not talker.stream_plane_mode(params, cfg, big) and talker.stream_plane_mode(params, cfg, small),
          "the gate: a 2656-row cache must take the layer path and a 2624-row one the kernel")
    _reset_counts()
    with torch.no_grad():
        h_layer, logits_layer = talker.decode_step(params, cfg, x, pos, big)
    layer_launches = _counts()["talker_step"]
    with torch.no_grad():
        h_kernel, logits_kernel = talker.decode_step_planes(params, cfg, x, pos, *talker.plane_views(small),
                                                            model.talker_step_pack)
    torch.cuda.synchronize()
    err = rel_err(h_layer, h_kernel)
    same = int(logits_layer.argmax()) == int(logits_kernel.argmax())
    phase("gate", f"fused bf16 talker step at pos {pos}: layer path on {big.max_seq} rows (kernel 3 launched "
          f"{layer_launches} times) against kernel 3 on {small.max_seq}: hidden {err:.3e} of the scale (bar "
          f"{HIDDEN_TOL}), same argmax {same}")
    check(layer_launches == 0, "the layer path past the gate launched kernel 3")
    check(err <= HIDDEN_TOL, f"the layer path past the gate: hidden {err:.3e} of the scale > {HIDDEN_TOL}")


BATCH = 8
BATCH_FIXTURE_SEEDS = [42, 43, 44]
DESIGN_INSTRUCTS = ("A calm voice.", "A bright, cheerful young woman, speaking quickly and clearly.", "Deep.")


@contextlib.contextmanager
def kernel4_launches():
    """Kernel 4's launches while entered (``int8_matmul`` reaches its core
    by module lookup; a launch is a card call that its gate lets through):
    yields (rows, inputs), ``rows`` m -> launches and ``inputs`` the first
    (x [m, K] copy, q8, scale) of every distinct (m, K, N)."""
    rows: dict = {}
    inputs: dict = {}
    core = quant._int8_mm_core

    def recording(x2, q8, scale):
        if x2.is_cuda and quant.int8_matmul_route(x2, q8) == "kernel":
            m = x2.shape[0]
            rows[m] = rows.get(m, 0) + 1
            inputs.setdefault((m, x2.shape[1], q8.shape[1]), (x2.clone(), q8, scale))
        return core(x2, q8, scale)

    quant._int8_mm_core = recording
    try:
        yield rows, inputs
    finally:
        quant._int8_mm_core = core


def kernel4_batch_shapes(inputs: dict) -> list:
    """Kernel 4 at every shape the B = 8 int8 batch gave it (``inputs``, from
    ``kernel4_launches``: the talker's projections and codec head, the code
    predictor's projections, heads and its 2-row prefill, the prompt's
    prefill), on those inputs and weights, printed as phase
    ``kernel4-batch``: against its plain version (one bf16 ulp of the
    output's scale), timed by ``kt.time_shape`` beside ``torch.matmul`` on
    the dequantized weight and the plain version, with the bound."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    shapes = []
    for (m, k, n), (x, q8, scale) in sorted(inputs.items()):
        got = quant.int8_matmul(x, q8, scale)
        want = quant.int8_matmul_plain(x, q8, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = want.float().abs().max().item() * 2.0**-7
        times = {**kt.time_shape(quant, x, {"q8": q8, "scale": scale}),
                 "plain_ms": time_ms(lambda: quant.int8_matmul_plain(x, q8, scale), iters=20)}
        b = bound(nbytes(x, q8, scale) + m * n * x.element_size(), 2 * m * k * n)
        plan = quant.int8_matmul_plan(m, k, n, sms)
        phase("kernel4-batch", f"m={m} K={k} N={n} (tier {plan.tier}, {plan.splits} K splits), the batch's own "
              f"input and weight: max|err| {err:.4e} (bar {tol:.4e}); device span: kernel {times['device_ms']:.4f} "
              f"ms, torch.matmul on the dequantized weight {times['library_device_ms']:.4f} ms; per call: kernel "
              f"{times['ms']:.4f}, library {times['library_ms']:.4f}, plain {times['plain_ms']:.4f}; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(err <= tol, f"kernel 4 at the batch's m={m} K={k} N={n}: max|err| {err:.4e} > {tol:.4e}")
        shapes.append({"m": m, "k": k, "n": n, "tier": plan.tier, "max_abs_err": err, **times, **b})
    return shapes


def kernel4_batch_rows(cfg: ModelConfig, b: int, frames: int) -> dict:
    """The kernel-4 launches of one ``synthesize_batch`` of b CustomVoice
    streams on the int8 tree, by rows: the prefill's 4 projections a talker
    layer at 10·b rows and its codec head at b; a frame's talker step (4 a
    layer and the head) at b, the code predictor's 2-row prefill (4 a layer)
    at 2·b, its 14 steps (4 a layer) and 15 heads at b."""
    t, c = cfg.talker.num_hidden_layers, cfg.code_predictor.num_hidden_layers
    steps = cfg.code_predictor.num_acoustic - 1
    per_b = 1 + frames * (4 * t + 1 + 4 * c * steps + cfg.code_predictor.num_acoustic)
    want = {10 * b: 4 * t, b: per_b}
    want[2 * b] = want.get(2 * b, 0) + frames * 4 * c
    return want


def batch_cells(model: Qwen3TTS, label: str, staged_ms_per_frame: float, int8: bool) -> dict:
    """``synthesize_batch`` of ``st.BATCH_TEXTS`` (125 frames forced, stream
    i seed 42 + i) at B = 1, 4 and 8 on the 1.7B ``model`` (no warm call:
    the loop is host-bound, ~20 s a call), one timed call at each B with
    every launch count set to 0 just before it, read just after. Kernels 1 and 3 never launch (the
    batched loop takes the layer path), kernel 2's batch entry 9 times (one
    decode for all B streams), its stream entry never; on the int8 tree
    kernel 4 at the rows of ``kernel4_batch_rows`` (B in the loop, 10·B in
    the prefill), none sent to the plain form. Prints prefill, the loop's
    ms a frame beside the staged batch-1 cell's, decode, aggregate and
    per-stream RTF, frames a second and peak memory. Returns each run's
    audio, frames (read from its loop), numbers and launches."""
    model.tokenizer = st.WordTokenizer()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on for the batched layer path")
    out = {}
    for b in st.BATCH_SIZES:
        loops = []

        def recording(group, generate=model._generate_batch_group):
            loops.append(generate(group))
            return loops[-1]

        model._generate_batch_group = recording
        _reset_counts()
        quant.int8_matmul.gated = 0
        try:
            with kernel4_launches() as (rows, inputs):
                audio, r = st.time_batch(model, b)
        finally:
            del model._generate_batch_group
        launches = _counts()
        gated = quant.int8_matmul.gated
        want_rows = kernel4_batch_rows(model.config, b, FRAMES) if int8 else {}
        phase("batch", f"{label} synthesize_batch B={b}: prefill {r['prefill_ms']:.2f} ms, loop "
              f"{r['ms_per_frame']:.3f} ms/frame over {r['frames']} frames (the staged batch-1 cell "
              f"{staged_ms_per_frame:.3f}), decode {r['decode_ms']:.1f} ms, wall {r['wall_ms']:.1f} ms, RTF per "
              f"stream {r['rtf_per_stream']:.4f}, aggregate {r['rtf_aggregate']:.4f}, {r['frames_per_s']:.1f} "
              f"frames/s (batch-1 staged {1e3 / staged_ms_per_frame:.1f}), peak allocated {r['peak_mib']:.0f} MiB; "
              f"launches {launches}; kernel 4 launches by rows {dict(sorted(rows.items()))} (want "
              f"{dict(sorted(want_rows.items()))}), calls the gate sent to the plain form {gated}")
        check(all(len(a.samples) == FRAMES * SAMPLES_PER_FRAME for a in audio), f"{label} B={b}: audio lengths")
        check(all(bool(np.isfinite(a.samples).all()) for a in audio), f"{label} B={b}: non-finite audio")
        check(launches["cp_frame"] == launches["talker_step"] == 0,
              f"{label} B={b}: kernel 1 or 3 launched in the batched loop: {launches}")
        check(launches["residual_unit"] == 9 and launches["residual_unit_stream"] == 0,
              f"{label} B={b}: kernel 2 launched {launches['residual_unit']} times (want 9 for one decode)")
        check(rows == want_rows and gated == 0, f"{label} B={b}: kernel 4 rows {rows} (want {want_rows}), gated {gated}")
        check(launches["int8_matmul"] == sum(want_rows.values()), f"{label} B={b}: kernel 4 launches {launches}")
        check(len(loops) == 1, f"{label} B={b}: {len(loops)} layout groups, want 1")
        frames = [f[:n] for f, n in zip(*loops[0])]
        out[b] = {"audio": [a.samples for a in audio], "codes": frames, **r, "launches": launches,
                  "kernel4_rows": rows, "kernel4_inputs": inputs}
    return out


def batch_sizes_agree(cells: dict, label: str, gate: bool) -> float:
    """Stream i's codes (seed 42 + i) at every B of ``batch_cells`` it runs
    in against its codes at the largest B: the share of streams whose codes
    are bit-equal, printed; a gate where ``gate`` (int8: kernel 4 sums each
    row in one order at every row count, and the rest of the layer path
    works row by row), reported in bf16 (``torch.matmul`` at B·m rows)."""
    big = cells[max(cells)]["codes"]
    equal = [[bool(c.shape == big[i].shape and (c == big[i]).all()) for i, c in enumerate(cells[b]["codes"])]
             for b in sorted(cells)]
    share = float(np.mean([e for row in equal for e in row]))
    firsts = {(b, i): divmod(int(np.argmax((c != big[i]).reshape(-1))), c.shape[1])
              for b in sorted(cells) for i, c in enumerate(cells[b]["codes"]) if c.shape == big[i].shape
              and not (c == big[i]).all()}
    phase("batch", f"{label}: each stream's codes at B={sorted(cells)} against its codes at B={max(cells)}, "
          f"bit-equal {equal} (share {share:.4f}; {'a gate' if gate else 'reported'}); first differing (frame, "
          f"code) by (B, stream) {firsts}")
    check(not gate or share == 1.0, f"{label}: a stream's codes differ between batch sizes: {equal}")
    return share


def batch_frames(model: Qwen3TTS, texts: list, options: SynthesisOptions, seeds: list, speakers=None,
                 instructs=None) -> list:
    """Each stream's frames from one batched loop of one layout."""
    b = len(texts)
    speakers = speakers or ["ryan"] * b
    instructs = instructs or [None] * b
    kind = model._split_batch_groups(speakers, instructs)
    check(len(kind) == 1, f"batch_frames takes one layout, got {kind}")
    group = model._prepare_batch_group(kind[0][0], texts, speakers, ["english"] * b, instructs, options, seeds)
    frames, counts = model._generate_batch_group(group)
    return [f[:n] for f, n in zip(frames, counts)]


def batch_against_solo(model: Qwen3TTS, label: str, frames: list) -> float:
    """The bf16 batch's codes (``frames``) against each stream's solo bf16
    run (kernels 1 and 3) with the same seed: the share equal, printed (not
    a gate: bf16 kernels sum in another order, ROADMAP Queue 3)."""
    opts = st.batch_options()
    shares, first = [], []
    for i, text in enumerate(st.BATCH_TEXTS):
        solo = model._custom_voice_session(text, "ryan", "english", replace(opts, seed=42 + i)).run_to_completion()
        same = (frames[i] == solo).all(axis=1) if frames[i].shape == solo.shape else np.zeros(1, bool)
        shares.append(float((frames[i] == solo).mean()) if frames[i].shape == solo.shape else 0.0)
        first.append(int(np.argmin(same)) if not same.all() else len(same))
    phase("batch", f"{label} B={BATCH} against each stream's solo run (kernels 1 and 3): share of codes equal "
          f"{np.mean(shares):.4f} (per stream {[round(x, 4) for x in shares]}), first differing frame per stream "
          f"{first}; not a gate")
    return float(np.mean(shares))


@contextlib.contextmanager
def batch_records(cpcfg: CodePredictorConfig):
    """What the batched path computes while entered, in call order, as f32
    [B, ...] rows: ``hidden`` the talker's (the prefill's last, then each
    decode step's), ``talker`` its logits as sampled (after the penalties:
    frame f's first code), ``cp`` the code predictor's head outputs (15 a
    frame: frame f's code j from call 15·f + j - 1). Yields the dict."""
    out = {"hidden": [], "talker": [], "cp": []}
    routed = talker.prefill_batch, talker.decode_step_batch, sampling.sample_rows, quant.mm

    def prefill_batch(*args, **kwargs):
        last, logits = routed[0](*args, **kwargs)
        out["hidden"].append(last[:, 0].float())
        return last, logits

    def decode_step_batch(*args, **kwargs):
        h, logits = routed[1](*args, **kwargs)
        out["hidden"].append(h[:, 0].float())
        return h, logits

    def sample(logits, cfg, uniform):
        out["talker"].append(logits.float())
        return routed[2](logits, cfg, uniform)

    def mm(x, w):
        y = routed[3](x, w)
        if is_cp_head(cpcfg, x, y):
            out["cp"].append(y.reshape(-1, y.shape[-1]).float())
        return y

    talker.prefill_batch, talker.decode_step_batch, sampling.sample_rows, quant.mm = (
        prefill_batch, decode_step_batch, sample, mm)
    try:
        yield out
    finally:
        talker.prefill_batch, talker.decode_step_batch, sampling.sample_rows, quant.mm = routed


WITNESS_FRAMES = 16


def bf16_witness(model: Qwen3TTS, label: str) -> dict:
    """A bf16 witness of the batched path at full depth: greedy batches
    (``WITNESS_FRAMES`` frames) against each stream's B = 1 run through the
    same batched loop, a CustomVoice batch of the 8 texts (one position for
    every stream) and a voice-design batch of 3 whose instructs differ in
    length (a position each). Each stream is followed to its first
    differing code (frame f, code j); until there both runs saw the same
    codes, so the talker's hidden states h_0 .. h_f (the prefill's last and
    each step's) must agree within ``HIDDEN_TOL`` of their scale (phase
    ``gate``'s bar for bf16 sums in another order; a fault in the per-stream
    positions, mask or cache rows moves them by the whole scale). At (f, j)
    both runs' top-2 margins and the largest difference of their logits are
    printed: a margin under that difference is a near-tie that bf16
    rounding decides."""
    opts = SynthesisOptions(max_length=WITNESS_FRAMES, min_new_tokens=WITNESS_FRAMES, seed=42, temperature=0.0)
    cpcfg = model.config.code_predictor
    cases = {"CustomVoice": (list(st.BATCH_TEXTS), None),
             "voice design": (list(st.BATCH_TEXTS[:len(DESIGN_INSTRUCTS)]), list(DESIGN_INSTRUCTS))}
    out = {}
    for name, (texts, instructs) in cases.items():
        b = len(texts)
        seeds = [42 + i for i in range(b)]
        with batch_records(cpcfg) as rec:
            frames = batch_frames(model, texts, opts, seeds, instructs=instructs)
        equal, firsts, worst, ties = [], [], 0.0, 0
        for i in range(b):
            with batch_records(cpcfg) as one:
                solo = batch_frames(model, texts[i:i + 1], opts, seeds[i:i + 1],
                                    instructs=instructs[i:i + 1] if instructs else None)[0]
            check(solo.shape == frames[i].shape, f"{label} witness {name}: stream {i} frame counts differ")
            differ = (solo != frames[i]).reshape(-1)
            equal.append(float(1.0 - differ.mean()))
            f, j = divmod(int(np.argmax(differ)), solo.shape[1]) if differ.any() else (len(solo), None)
            hidden = [rel_err(rec["hidden"][k][i], one["hidden"][k][0]) for k in range(min(f, len(solo) - 1) + 1)]
            worst = max(worst, max(hidden))
            entry = {"frame": f, "code": j, "hidden": max(hidden)}
            if j is not None:
                got, want = (rec["talker"][f], one["talker"][f]) if j == 0 else (rec["cp"][15 * f + j - 1],
                                                                                one["cp"][15 * f + j - 1])
                live = torch.isfinite(want[0])  # the penalties set some logits to -inf
                same_live = bool((torch.isfinite(got[i]) == live).all())
                entry.update(margin=float(top2_gap(got[i])), solo_margin=float(top2_gap(want[0])),
                             logits_diff=float((got[i] - want[0])[live].abs().max()) if same_live else math.inf)
                ties += entry["margin"] <= entry["logits_diff"]
            firsts.append(entry)
        phase("batch", f"{label} witness, {name} batch of {b} (greedy, {WITNESS_FRAMES} frames) against each stream's "
              f"B=1 run through the same batched loop: share of codes equal {np.mean(equal):.4f}; first differing "
              f"(frame, code) per stream {[(e['frame'], e['code']) for e in firsts]}; there the batch's top-2 margin / "
              f"the solo run's / max|logits difference| "
              + ", ".join(f"{e['margin']:.3e}/{e['solo_margin']:.3e}/{e['logits_diff']:.3e}" for e in firsts
                          if e['code'] is not None)
              + f" ({ties} of {sum(e['code'] is not None for e in firsts)} a margin under the difference); talker "
              f"hidden up to there {worst:.3e} of its scale at most (bar {HIDDEN_TOL})")
        check(worst <= HIDDEN_TOL, f"{label} witness {name}: talker hidden {worst:.3e} of its scale from the B=1 run "
                                   f"before any code differs (bar {HIDDEN_TOL})")
        out[name] = {"equal": float(np.mean(equal)), "first": firsts, "hidden": worst, "ties": ties}
    return out


def stream_batch(model: Qwen3TTS, label: str, whole: list, frames: list) -> dict:
    """``synthesize_streaming_batch`` of the 8 texts (4 frames, then 10 a
    chunk), with every launch count set to 0 just before it, read just
    after: kernel 2's stream entry 9 times a round, its
    batch entry and kernels 1 and 3 never; each stream's TTFA and each
    round's time; each stream's chunks put together held to its
    ``synthesize_batch`` audio (``whole``) within ``STREAM_SPREAD_FACTOR``
    times the staged decode's spread between buckets 64 and 256 on the
    batch's ``frames``, read here."""
    _reset_counts()
    chunks, r = st.time_stream_batch(model, BATCH)
    launches = _counts()
    codes = np.stack([f.T for f in frames])
    at256 = vocoder.decode_bucketed(model.vocoder_params, model.vocoder_config, codes, bucket=256)
    spread = float(max(np.abs(at256[i] - whole[i]).max() for i in range(BATCH)))
    scale = float(max(np.abs(w).max() for w in whole))
    bar = max(STREAM_SPREAD_FACTOR * spread, 1e-5 * scale)
    streamed = [np.concatenate(c) for c in chunks]
    errs = [float(np.abs(a - w).max()) if a.shape == w.shape else math.inf for a, w in zip(streamed, whole)]
    rounds = len(r["round_ms"])
    phase("stream-batch", f"{label} synthesize_streaming_batch B={BATCH}, {rounds} rounds of 4 then 10 frames: "
          f"TTFA per stream {', '.join(f'{t:.2f}' for t in r['ttfa_ms'])} ms; rounds {', '.join(f'{t:.2f}' for t in r['round_ms'])} "
          f"ms; wall {r['wall_ms']:.1f} ms, aggregate RTF {r['rtf_aggregate']:.4f}; launches {launches}; max|chunks "
          f"- synthesize_batch| per stream {max(errs):.3e} (bar {bar:.3e}: {STREAM_SPREAD_FACTOR:g} x the staged "
          f"decode's spread {spread:.3e} between buckets 64 and 256, at least 1e-5 of max|audio|)")
    check(launches["residual_unit_stream"] == 9 * rounds and launches["residual_unit"] == 0,
          f"{label} stream batch: kernel 2 launches {launches} over {rounds} rounds, want 9 a round")
    check(launches["cp_frame"] == launches["talker_step"] == 0, f"{label} stream batch: kernel 1 or 3 launched")
    check(max(errs) <= bar, f"{label} stream batch: audio {max(errs):.3e} from synthesize_batch (bar {bar:.3e})")
    return {**r, "launches": launches, "err": max(errs), "bar": bar}


def kernel2_batch(model: Qwen3TTS, frames: list, decode_bar: float) -> dict:
    """Kernel 2 across streams: the 9 units of the B = 8 decode of
    ``frames`` (their inputs recorded) against their plain versions at the
    same [B, T, C] within 1e-5 * max|x| (phase ``kernel2``'s bar); each unit
    on stream 0's and the last stream's rows alone bit-equal to their rows
    of the batch launch (its causal window does not reach across streams);
    timed per call, by device span, plain and against cuDNN's yardstick,
    with the bound. Then stream 0's own decode (B = 1) against its row of
    the batch decode: the audio within ``decode_bar`` (``stream_batch``'s:
    the upstream convolutions and matmuls run at another batch, as at
    another bucket), each unit's drift from its batch row printed in units
    of phase ``kernel2``'s bar."""
    codes = np.stack([f.T for f in frames])

    def record(codes):
        units, routed = [], blocks.residual_unit

        def recording(x, p, dilation):
            y = routed(x, p, dilation)
            if fused_blocks.residual_unit_should_fuse(x):
                units.append((x, p, dilation, y))
            return y

        blocks.residual_unit = recording
        try:
            wav = vocoder.decode_bucketed(model.vocoder_params, model.vocoder_config, codes, bucket=DECODE_BUCKET)
        finally:
            blocks.residual_unit = routed
        return units, wav

    units, wav = record(codes)
    check(len(units) == 9, f"kernel 2 batch: {len(units)} units took the kernel, want 9")
    worst = worst_rel = 0.0
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    work_bytes = work_ops = 0
    for x, p, dil, y in units:
        want = fused_blocks.residual_unit_plain(x, p, dil)
        err = (y - want).abs().max().item()
        tol = 1e-5 * x.abs().max().item()
        alone = [same_bits(fused_blocks.residual_unit(x[i:i + 1].contiguous(), p, dil), y[i:i + 1])
                 for i in (0, x.shape[0] - 1)]
        fn = lambda x=x, p=p, dil=dil: fused_blocks.residual_unit(x, p, dil)  # noqa: E731
        r = {"ms": time_ms(fn, iters=3), "device_ms": kt.graph_ms([fn], 3),
             "plain_ms": time_ms(lambda: fused_blocks.residual_unit_plain(x, p, dil), iters=2),
             "library_ms": time_ms(kt.library_unit(x, p, dil), iters=3)}
        phase("kernel2-batch", f"[{x.shape[0]}, {x.shape[1]}, {x.shape[2]}] dilation {dil}: max|err| {err:.3e} (atol "
              f"{tol:.3e}); stream 0 and {x.shape[0] - 1} alone bit-equal to their rows {alone}; kernel "
              f"{r['ms']:.4f} ms per call / {r['device_ms']:.4f} device span, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}")
        check(err <= tol, f"kernel 2 batch C={x.shape[2]} d={dil}: max|err| {err:.3e} > {tol:.3e}")
        check(all(alone), f"kernel 2 batch C={x.shape[2]} d={dil}: a stream alone differs from its batch rows")
        worst, worst_rel = max(worst, err), max(worst_rel, err / tol)
        for key in totals:
            totals[key] += r[key]
        work_bytes += 2 * nbytes(x) + nbytes(p)
        work_ops += 2 * x.shape[0] * x.shape[1] * x.shape[2] ** 2 * 8
    tc_bound = bound(work_bytes, 3 * work_ops, "tf32")

    solo_units, solo_wav = record(codes[:1])
    drift = [(ys[0] - y[0]).abs().max().item() / (1e-5 * xs.abs().max().item())
             for (x, p, dil, y), (xs, _, _, ys) in zip(units, solo_units)]
    audio_err = float(np.abs(solo_wav[0] - wav[0]).max())
    phase("kernel2-batch", f"the 9 units of the B={codes.shape[0]} decode: per call {totals['ms']:.4f} ms, device "
          f"spans {totals['device_ms']:.4f}, plain {totals['plain_ms']:.4f}, library {totals['library_ms']:.4f}; "
          f"3xTF32 bound {tc_bound['bound_ms']:.4f} ms; worst err/bar {worst_rel:.3f}; stream 0's own decode: audio "
          f"{audio_err:.3e} from its batch row (bar {decode_bar:.3e}), its units' drift from their batch rows in "
          f"units of 1e-5 * max|x| {', '.join(f'{d:.2f}' for d in drift)}")
    check(audio_err <= decode_bar, f"kernel 2: stream 0's own decode {audio_err:.3e} from its batch row "
                                   f"(bar {decode_bar:.3e})")
    return {"b": int(codes.shape[0]), "max_abs_err": worst, **{f"b8_{k}": v for k, v in totals.items()},
            "b8_bound_ms": tc_bound["bound_ms"], "solo_decode_err": audio_err}


def is_cp_head(cpcfg: CodePredictorConfig, x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``quant.mm(x, w) -> y`` is a code-predictor head: its hidden
    width in and its vocab out (no other product of the 1.7B model has both:
    the talker's o_proj also gives 2048 columns, from 2048)."""
    return x.shape[-1] == cpcfg.hidden_size and y.shape[-1] == cpcfg.vocab_size


def top2_gap(y: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(y.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


@contextlib.contextmanager
def top2_margins(cpcfg: CodePredictorConfig):
    """The least top-2 margins while entered: of the talker's post-penalty
    logits (the sampler's input) and of the code predictor's heads
    (``is_cp_head``). Yields a dict."""
    out = {"talker": math.inf, "cp": math.inf}
    routed_mm, routed_sample = quant.mm, sampling.sample_rows

    def gap(y):
        return float(top2_gap(y).min())

    def mm(x, w):
        y = routed_mm(x, w)
        if is_cp_head(cpcfg, x, y):
            out["cp"] = min(out["cp"], gap(y))
        return y

    def sample(logits, cfg, uniform):
        out["talker"] = min(out["talker"], gap(logits))
        return routed_sample(logits, cfg, uniform)

    quant.mm, sampling.sample_rows = mm, sample
    try:
        yield out
    finally:
        quant.mm, sampling.sample_rows = routed_mm, routed_sample


def batch_fixture(model: Qwen3TTS, label: str = "batch") -> None:
    """The seeded 1.7B-width f32 model (phase ``utterance``'s) through
    ``synthesize_batch`` of ``ckpt_fixture.BATCH_TEXTS``, greedy and PCG,
    with every launch count set to 0 just before, read just after: every
    stream's frames token-exact and its audio within 1e-5 of its max|audio|
    of the JAX package's (the committed fixture); kernels 1 and 3 never,
    kernel 2 9 times."""
    fixture = ckpt_fixture.load_batch()
    texts, n = list(ckpt_fixture.BATCH_TEXTS), ckpt_fixture.BATCH_FRAMES
    for kind, temperature in (("greedy", 0.0), ("pcg", 0.9)):
        opts = SynthesisOptions(max_length=n, min_new_tokens=n, seed=BATCH_FIXTURE_SEEDS[0], temperature=temperature)
        frames = batch_frames(model, texts, opts, BATCH_FIXTURE_SEEDS)
        _reset_counts()
        audio = model.synthesize_batch(texts, options=opts)
        launches = _counts()
        want, want_audio = fixture[f"frames_{kind}"], fixture[f"audio_{kind}"]
        equal = [f.shape == w.shape and bool((f == w).all()) for f, w in zip(frames, want)]
        errs = [float(np.abs(a.samples - w).max() / np.abs(w).max()) if a.samples.shape == w.shape else math.inf
                for a, w in zip(audio, want_audio)]
        phase(label, f"seeded 1.7B-width f32 checkpoint (2 talker layers), synthesize_batch of {len(texts)} texts, "
              f"{kind}, {n} frames: token-exact to the JAX fixture per stream {equal}; max|audio - JAX| / max|audio| "
              f"per stream {', '.join(f'{e:.3e}' for e in errs)} (bar 1e-5); least top-2 margins of the fixture: "
              f"talker {float(fixture['talker_margin']):.3e}, code predictor {float(fixture['cp_margin']):.3e}; "
              f"launches {launches}")
        check(all(equal), f"batch fixture {kind}: frames differ from the JAX fixture")
        check(max(errs) <= 1e-5, f"batch fixture {kind}: audio {max(errs):.3e} of max|audio| from the JAX fixture")
        check(launches["cp_frame"] == launches["talker_step"] == 0 and launches["residual_unit"] == 9,
              f"batch fixture {kind}: launches {launches}")


def per_stream_positions(model: Qwen3TTS, encoders: tuple) -> None:
    """Per-stream positions at full width (the f32 1.7B-width model, 16
    frames, greedy): a voice-design batch of 3 streams whose instructs
    differ in length, and an ICL batch of 2 whose references differ (the
    fixture's 3 s reference, and its first 20 frames with another text; the
    phase-4 encoders): each stream token-exact to its own B = 1 run through
    the same batched path; the least top-2 margins printed."""
    n = 16
    opts = SynthesisOptions(max_length=n, min_new_tokens=n, seed=42, temperature=0.0)
    texts = list(ckpt_fixture.BATCH_TEXTS)
    model.speaker_encoder, model.speech_encoder = encoders
    try:
        icl = model.create_voice_clone_prompt(AudioBuffer(encoder_fixture.reference_audio(24000), 24000), CLONE_TEXT)
    finally:
        model.speaker_encoder = model.speech_encoder = None
    short = VoiceClonePrompt(icl.speaker_embedding, icl.ref_codes[:20], model.tokenizer.encode("Fewer words here."))
    cases = {
        "voice design": dict(texts=texts, seeds=[42, 43, 44], instructs=list(DESIGN_INSTRUCTS)),
        "ICL": dict(texts=texts[:2], seeds=[42, 43], speakers=[icl, short]),
    }
    for name, case in cases.items():
        b = len(case["texts"])
        with top2_margins(model.config.code_predictor) as margins:
            frames = batch_frames(model, case["texts"], opts, case["seeds"], case.get("speakers"), case.get("instructs"))
        equal = []
        for i in range(b):
            one = {k: v[i:i + 1] for k, v in case.items()}
            solo = batch_frames(model, one["texts"], opts, one["seeds"], one.get("speakers"), one.get("instructs"))[0]
            equal.append(solo.shape == frames[i].shape and bool((solo == frames[i]).all()))
        phase("batch", f"per-stream positions, 1.7B-width f32, {name} batch of {b} ({n} frames, greedy): each stream "
              f"token-exact to its own B=1 run {equal}; least top-2 margins: talker {margins['talker']:.3e}, code "
              f"predictor {margins['cp']:.3e}")
        check(all(equal), f"per-stream positions, {name}: a stream differs from its own B=1 run")


def batch_profile() -> dict:
    """``synthesis_timing.py --cells profile-batch8-bf16`` in a process of its
    own (the profiler's later sessions in this one record no device
    activity): ``st.PROFILE_FRAMES`` frames of the bf16 B = 8 batched loop
    under torch.profiler, printed: device kernels a frame, the device's busy
    share of the loop's wall time, and the host ops that cost the most."""
    script = Path(__file__).resolve().parent / "qwen3_tts_tpu_torch" / "synthesis_timing.py"
    out = subprocess.run([sys.executable, str(script), "--cells", "profile-batch8-bf16", "--repeats", "1"],
                         capture_output=True, text=True, check=True, timeout=600).stdout
    r = json.loads(next(line for line in out.splitlines() if line.startswith("{")))
    device = ("not measured (the profiler recorded no device activity)" if r["kernels_per_frame"] is None else
              f"{r['kernels_per_frame']:.1f} device kernels and {r['copies_per_frame']:.1f} copies or fills a frame, "
              f"the device busy {r['device_busy_ms_per_frame']:.3f} ms a frame ({r['busy_share']:.4f} of the "
              f"profiled loop's wall time)")
    phase("batch", f"1.7B bf16 B={r['b']} batched loop, {r['frames']} frames under torch.profiler (another process): "
          f"{device}; {r['ms_per_frame']:.3f} ms a frame unprofiled, {r['profiled_ms_per_frame']:.3f} profiled; "
          f"host ops with the most CPU time of their own (calls a frame, ms a frame): "
          + "; ".join(f"{name} {calls:.0f} {ms:.3f}" for name, calls, ms in r["host_top"]))
    return r


def batch_main(model: Qwen3TTS, label: str, int8: bool) -> dict:
    """Phase ``batch`` on the 1.7B main-path ``model``: ``batch_cells``;
    in bf16 also the batch against solo runs, the bf16 witness
    (``bf16_witness``), the loop's profile (``batch_profile``), the
    streaming batch and kernel 2 across streams (``kernel2_batch``). The
    model's tokenizer is ``st.WordTokenizer`` meanwhile."""
    tokenizer = model.tokenizer
    try:
        out = {"cells": batch_cells(model, label, STAGED_MS_PER_FRAME[label], int8)}
        out["streams_equal"] = batch_sizes_agree(out["cells"], label, int8)
        if not int8:
            frames = out["cells"][BATCH]["codes"]
            out["solo_share"] = batch_against_solo(model, label, frames)
            out["witness"] = bf16_witness(model, label)
            out["profile"] = batch_profile()
            out["stream"] = stream_batch(model, label, out["cells"][BATCH]["audio"], frames)
            out["kernel2"] = kernel2_batch(model, frames, out["stream"]["bar"])
    finally:
        model.tokenizer = tokenizer
    return out


# The coalescing steps' windows: wide enough that 8 requests posted at once
# always form one group, which closes as soon as the 8th arrives.
SERVER_WIDE_MS = 5000.0


@contextlib.contextmanager
def serving(model: Qwen3TTS, **kw):
    """``server.serve(model, "127.0.0.1", 0, **kw)`` in a thread while
    entered; yields its (host, port)."""
    http = server.serve(model, "127.0.0.1", 0, **kw)
    th = threading.Thread(target=http.serve_forever, daemon=True)
    th.start()
    try:
        yield http.server_address
    finally:
        http.shutdown()
        http.server_close()
        th.join(60)


@contextlib.contextmanager
def recording(model: Qwen3TTS, name: str):
    """Every call of ``model.<name>`` while entered (the engine calls the
    model's methods by name): yields a list of (args, kwargs, result). A
    ``synthesize_streaming_batch`` call's result is the list of the rounds
    its session returned."""
    calls = []
    routed = getattr(model, name)

    def rec(*args, **kwargs):
        y = routed(*args, **kwargs)
        if name != "synthesize_streaming_batch":
            calls.append((args, kwargs, y))
            return y
        rounds, pull = [], y.next_chunks

        def next_chunks():
            out = pull()
            if out is not None:
                rounds.append(out)
            return out

        y.next_chunks = next_chunks
        calls.append((args, kwargs, rounds))
        return y

    setattr(model, name, rec)
    try:
        yield calls
    finally:
        delattr(model, name)


def _pct(ms: list) -> str:
    p50, p95 = st.p50_p95(ms)
    return f"p50 {p50:.1f} ms, p95 {p95:.1f} ms"


def _frames_of(n_bytes: int) -> int:
    return (n_bytes - st.WAV_HEADER_BYTES) // 2 // SAMPLES_PER_FRAME


def server_solo(model: Qwen3TTS, base: tuple, card: str) -> dict:
    """Step 1: one request; its float result through the engine bit-equal to
    ``synthesize_with_voice`` of the same options; kernels 1 and 3 once a
    frame, kernel 2's stream entry 9 times a 64-frame chunk, its batch entry
    never."""
    _reset_counts()
    with recording(model, "synthesize_with_voice") as calls:
        r = st.http_post(base, st.server_payload(0))
    launches = _counts()
    check(r["status"] == 200 and len(calls) == 1, f"server solo: status {r['status']}, {len(calls)} library calls")
    args, kwargs, audio = calls[0]
    frames = len(audio.samples) // SAMPLES_PER_FRAME
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = model.synthesize_with_voice(*args, **kwargs)
    lib_ms = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(audio.samples, lib.samples)
    want = {"cp_frame": frames, "talker_step": frames, "residual_unit_stream": 9 * -(-frames // DECODE_BUCKET),
            "residual_unit": 0}
    phase("server", f"{card}: solo request ({frames} frames): HTTP latency {r['ms']:.1f} ms, the library call "
          f"{lib_ms:.1f} ms; float result bit-equal to synthesize_with_voice {same}; launches {launches}")
    check(r["bytes"] == st.WAV_HEADER_BYTES + 2 * len(audio.samples), "server solo: WAV length")
    check(frames > 0 and same, "server solo: the engine's audio differs from synthesize_with_voice's")
    check(all(launches[k] == v for k, v in want.items()), f"server solo: launches {launches}, want {want}")
    return {"ms": r["ms"], "library_ms": lib_ms, "frames": frames, "launches": launches}


def server_coalesced(model: Qwen3TTS, base: tuple, wide: tuple, card: str) -> dict:
    """Step 2: 8 requests posted at once: one ``synthesize_batch`` call of 8,
    each float result bit-equal to that call's row run again directly;
    latencies and aggregate frames/s against the same 8 requests one after
    another through the server with the default window."""
    payloads = [st.server_payload(i) for i in range(BATCH)]
    _reset_counts()
    with recording(model, "synthesize_batch") as calls:
        t0 = time.perf_counter()
        rs = st.concurrently(lambda p: st.http_post(wide, p), payloads)
        wall = time.perf_counter() - t0
    launches = _counts()
    check(all(r["status"] == 200 for r in rs), f"server batch: statuses {[r['status'] for r in rs]}")
    check(len(calls) == 1 and len(calls[0][0][0]) == BATCH, f"server batch: {len(calls)} synthesize_batch calls")
    args, kwargs, audio = calls[0]
    direct = model.synthesize_batch(*args, **kwargs)
    same = [np.array_equal(a.samples, d.samples) for a, d in zip(audio, direct)]
    frames = sum(_frames_of(r["bytes"]) for r in rs)
    t0 = time.perf_counter()
    serial = [st.http_post(base, p) for p in payloads]
    serial_wall = time.perf_counter() - t0
    serial_frames = sum(_frames_of(r["bytes"]) for r in serial)
    phase("server", f"{card}: {BATCH} requests at once, one synthesize_batch of {BATCH}: latencies "
          f"{', '.join(f'{r['ms']:.0f}' for r in rs)} ms ({_pct([r['ms'] for r in rs])}), {frames} frames in "
          f"{wall * 1e3:.0f} ms = {frames / wall:.1f} frames/s; the same {BATCH} one after another: "
          f"{_pct([r['ms'] for r in serial])}, {serial_frames} frames in {serial_wall * 1e3:.0f} ms = "
          f"{serial_frames / serial_wall:.1f} frames/s; rows bit-equal to a direct synthesize_batch {same}; "
          f"launches {launches}")
    check(all(same), "server batch: a result differs from its row of the direct synthesize_batch")
    check(all(r["status"] == 200 for r in serial), "server serial: a request failed")
    check(launches["cp_frame"] == launches["talker_step"] == 0 and launches["residual_unit"] == 9,
          f"server batch: launches {launches} (want kernels 1 and 3 never, kernel 2 9 times)")
    return {"ms": [r["ms"] for r in rs], "frames_per_s": frames / wall, "serial_ms": [r["ms"] for r in serial],
            "serial_frames_per_s": serial_frames / serial_wall, "launches": launches}


def server_streams(model: Qwen3TTS, wide: tuple, card: str) -> dict:
    """Step 3: 8 streaming requests at once: one ``StreamingBatchSession``;
    each stream's chunks put together within ``STREAM_SPREAD_FACTOR`` x the
    staged decode's bucket spread of its ``synthesize_batch`` audio (the
    same texts, seeds and options run directly); TTFA and chunk gaps over
    HTTP."""
    payloads = [st.server_payload(i) for i in range(BATCH)]
    _reset_counts()
    with recording(model, "synthesize_streaming_batch") as calls:
        rs = st.concurrently(lambda p: st.http_stream(wide, p), payloads)
    launches = _counts()
    check(all(r["status"] == 200 for r in rs), f"server streams: statuses {[r['status'] for r in rs]}")
    check(len(calls) == 1 and len(calls[0][0][0]) == BATCH, f"server streams: {len(calls)} sessions, want 1")
    args, kwargs, rounds = calls[0]
    streamed = [np.concatenate([rnd[i].samples for rnd in rounds if rnd[i] is not None] or [np.zeros(0, np.float32)])
                for i in range(BATCH)]
    with recording(model, "_generate_batch_group") as loops:
        whole = [a.samples for a in model.synthesize_batch(*args, **kwargs)]
    frames = [f[:n] for f, n in zip(*loops[0][2])]
    codes = np.zeros((BATCH, max(len(f) for f in frames), frames[0].shape[1]), np.int32)
    for i, f in enumerate(frames):
        codes[i, :len(f)] = f  # zero codes past a stream's end: the vocoder is causal, the trim exact
    at256 = vocoder.decode_bucketed(model.vocoder_params, model.vocoder_config, np.swapaxes(codes, 1, 2), bucket=256)
    spread = float(max(np.abs(at256[i, :len(w)] - w).max() for i, w in enumerate(whole)))
    bar = max(STREAM_SPREAD_FACTOR * spread, 1e-5 * float(max(np.abs(w).max() for w in whole)))
    errs = [float(np.abs(a - w).max()) if a.shape == w.shape else math.inf for a, w in zip(streamed, whole)]
    by_text = {t: i for i, t in enumerate(args[0])}
    ttfa = [r["ttfa_ms"] for r in rs]
    gaps = [g for r in rs for g in r["gaps_ms"]]
    phase("server", f"{card}: {BATCH} streaming requests at once, one StreamingBatchSession of {len(rounds)} rounds: "
          f"TTFA {', '.join(f'{t:.0f}' for t in ttfa)} ms ({_pct(ttfa)}); HTTP chunk gaps {_pct(gaps)}, max "
          f"{max(gaps):.0f} ms; latencies {_pct([r['ms'] for r in rs])}; max|chunks - synthesize_batch| "
          f"{max(errs):.3e} (bar {bar:.3e}: {STREAM_SPREAD_FACTOR:g} x the decode's spread {spread:.3e} between "
          f"buckets 64 and 256); launches {launches}")
    check(sorted(by_text) == sorted(p["text"] for p in payloads), "server streams: the session's texts")
    check(max(errs) <= bar, f"server streams: audio {max(errs):.3e} from synthesize_batch (bar {bar:.3e})")
    check(launches["residual_unit_stream"] == 9 * len(rounds) and launches["cp_frame"] == 0,
          f"server streams: launches {launches} over {len(rounds)} rounds")
    return {"ttfa_ms": ttfa, "gaps_ms": gaps, "ms": [r["ms"] for r in rs], "err": max(errs), "bar": bar,
            "launches": launches}


def server_mixed(base: tuple, card: str) -> dict:
    """Step 4: ``st.mixed_load``: a long solo stream with 8 short requests
    posted during it. Every response completes, and the stream is
    time-sliced, not starved: it has chunks before the short requests end
    and after them (unless it ended first)."""
    r = st.mixed_load(base)
    statuses = [x["status"] for x in r["short"]] + [r["stream"]["status"]]
    s = r["stream"]
    phase("server", f"{card}: mixed load, a {st.SERVER_STREAM_FRAMES}-frame stream with {st.SERVER_REQUESTS} "
          f"{st.SERVER_FRAMES}-frame requests posted at its first audio: requests {_pct(r['ms'])}; the stream's "
          f"TTFA {s['ttfa_ms']:.1f} ms, {len(s['arrivals'])} chunks ({r['stream_chunks_before']} before the first "
          f"request ended, {r['stream_chunks_after']} after the last), gaps {_pct(s['gaps_ms'])}, max "
          f"{max(s['gaps_ms'] or [0]):.0f} ms, whole stream {s['ms']:.0f} ms; statuses {statuses}")
    check(all(x == 200 for x in statuses), f"server mixed: statuses {statuses}")
    ended_first = s["end"] < min(x["end"] for x in r["short"])
    check(r["stream_chunks_before"] >= 1 and (r["stream_chunks_after"] >= 1 or ended_first),
          "server mixed: the stream was not time-sliced around the requests")
    return {k: v for k, v in r.items() if k not in ("short", "stream")} | {"stream_ms": s["ms"]}


def transfer_audit(model: Qwen3TTS, card: str) -> dict:
    """Step 6: ``TransferAudit`` on the card over one staged batch-1 run and
    one B = 8 batch (``SERVER_FRAMES`` frames forced each): the host reads,
    printed as a record."""
    opts = replace(st.batch_options(), max_length=st.SERVER_FRAMES, min_new_tokens=st.SERVER_FRAMES)
    (_, timing), solo = count_host_transfers(model.synthesize_with_timing, st.BATCH_TEXTS[0], "ryan", "english",
                                             opts)
    with recording(model, "_generate_batch_group") as loops:
        _, batch = count_host_transfers(model.synthesize_batch, list(st.BATCH_TEXTS[:BATCH]), options=opts)
    frames = int(max(loops[0][2][1]))
    phase("server", f"{card}: TransferAudit: staged batch-1 run of {timing.generation_frames} frames "
          f"{solo} host reads; B={BATCH} synthesize_batch of {frames} frames {batch} host reads")
    return {"batch1": solo, "batch1_frames": timing.generation_frames, "batch8": batch, "batch8_frames": frames}


def server_phase(model: Qwen3TTS, label: str) -> dict:
    """Phase ``server`` on the 1.7B bf16 main-path ``model`` (its tokenizer
    ``st.WordTokenizer`` meanwhile): two servers in threads of this process,
    one with the default windows (solo, serial and mixed traffic), one with
    windows of ``SERVER_WIDE_MS`` (the coalescing steps), steps 1-4 and 6."""
    card = card_line()
    tokenizer = model.tokenizer
    model.tokenizer = st.WordTokenizer()
    try:
        with serving(model, max_batch=BATCH) as base, \
                serving(model, max_batch=BATCH, batch_window_ms=SERVER_WIDE_MS, stream_window_ms=SERVER_WIDE_MS) as wide:
            out = {"solo": server_solo(model, base, card), "batch": server_coalesced(model, base, wide, card),
                   "streams": server_streams(model, wide, card), "mixed": server_mixed(base, card)}
        out["audit"] = transfer_audit(model, card)
    finally:
        model.tokenizer = tokenizer
    return out


@contextlib.contextmanager
def w8a8_inputs():
    """The first (x [m, K] copy, q8, scale) of every distinct (m, K, N) that
    takes the w8a8 route while entered (``int8_matmul`` reaches its core by
    module lookup)."""
    inputs: dict = {}
    core = quant._int8_mm_core

    def recording(x2, q8, scale):
        if quant._w8a8_allowed():
            inputs.setdefault((x2.shape[0], x2.shape[1], q8.shape[1]), (x2.clone(), q8, scale))
        return core(x2, q8, scale)

    quant._int8_mm_core = recording
    try:
        yield inputs
    finally:
        quant._int8_mm_core = core


def server_w8a8(m8: Qwen3TTS, m8w: Qwen3TTS, card: str) -> dict:
    """Step 5, on the int8 tree with ``int8_activations=True`` (``m8w``)
    beside the weight-only int8 model (``m8``): a solo request launches
    kernel 4 and takes no w8a8 call; a coalesced batch of 8 launches kernel 4
    never and takes the w8a8 route instead, its audio finite and of its
    frames' length. The same batch run directly on both models: ms/frame,
    and the share of codes equal (not a gate: w8a8 is lossy by design).
    ``w8a8_matmul`` on the card bit-equal to the same function on the CPU at
    every shape the batch gives it, on the batch's own first input of each."""
    for m in (m8, m8w):
        m.tokenizer = st.WordTokenizer()
    with serving(m8w, max_batch=BATCH) as base, \
            serving(m8w, max_batch=BATCH, batch_window_ms=SERVER_WIDE_MS, stream_window_ms=SERVER_WIDE_MS) as wide:
        _reset_counts()
        quant.w8a8_matmul.calls = 0
        solo = st.http_post(base, st.server_payload(0))
        solo_launches, solo_w8 = _counts(), quant.w8a8_matmul.calls
        _reset_counts()
        quant.w8a8_matmul.calls = 0
        with recording(m8w, "synthesize_batch") as calls:
            rs = st.concurrently(lambda p: st.http_post(wide, p), [st.server_payload(i) for i in range(BATCH)])
        launches, w8 = _counts(), quant.w8a8_matmul.calls
    check(solo["status"] == 200 and all(r["status"] == 200 for r in rs), "server w8a8: a request failed")
    check(len(calls) == 1 and len(calls[0][0][0]) == BATCH, f"server w8a8: {len(calls)} synthesize_batch calls")
    check(solo_launches["int8_matmul"] > 0 and solo_w8 == 0,
          f"server w8a8 solo: kernel 4 launches {solo_launches['int8_matmul']}, w8a8 calls {solo_w8}")
    check(launches["int8_matmul"] == 0 and w8 > 0,
          f"server w8a8 batch: kernel 4 launches {launches['int8_matmul']} (want 0), w8a8 calls {w8}")
    args, kwargs, audio = calls[0]
    codes = {}
    for name, m in (("w8a8", m8w), ("int8", m8)):
        with w8a8_inputs() as inputs, recording(m, "_generate_batch_group") as loops:
            out, timing = m.synthesize_batch_with_timing(*args, **kwargs)
        codes[name] = ([f[:n] for f, n in zip(*loops[0][2])], timing.generation_ms / timing.generation_frames,
                       inputs, out)
    frames = codes["w8a8"][0]
    check(all(len(a.samples) == len(f) * SAMPLES_PER_FRAME and len(f) > 0 for a, f in zip(audio, frames)),
          "server w8a8: audio lengths")
    check(all(bool(np.isfinite(a.samples).all()) for a in audio), "server w8a8: non-finite audio")
    equal = [float((a == b).mean()) if a.shape == b.shape else 0.0 for a, b in zip(frames, codes["int8"][0])]
    check(not codes["int8"][2], "server w8a8: the weight-only model took the w8a8 route")
    shapes = []
    for (m, k, n), (x, q8, scale) in sorted(codes["w8a8"][2].items()):
        got = quant.w8a8_matmul(x, q8, scale).cpu()
        want = quant.w8a8_matmul(x.cpu(), q8.cpu(), scale.cpu())
        shapes.append((m, k, n, same_bits(got, want)))
    phase("server", f"{card}: int8 with int8_activations: solo request kernel 4 launches "
          f"{solo_launches['int8_matmul']}, w8a8 calls {solo_w8}; coalesced batch of {BATCH} (latencies "
          f"{_pct([r['ms'] for r in rs])}): kernel 4 launches {launches['int8_matmul']}, w8a8 calls {w8}; the same "
          f"batch directly: w8a8 {codes['w8a8'][1]:.3f} ms/frame, weight-only int8 {codes['int8'][1]:.3f} "
          f"ms/frame; share of codes equal to the weight-only batch {np.mean(equal):.4f} (per stream "
          f"{[round(e, 4) for e in equal]}; not a gate); w8a8_matmul on the card bit-equal to the CPU at "
          + ", ".join(f"m={m} K={k} N={n}: {ok}" for m, k, n, ok in shapes))
    check(shapes and all(ok for *_, ok in shapes), "server w8a8: w8a8_matmul on the card differs from the CPU")
    return {"ms": [r["ms"] for r in rs], "w8a8_ms_per_frame": codes["w8a8"][1],
            "int8_ms_per_frame": codes["int8"][1], "equal": float(np.mean(equal)), "shapes": len(shapes),
            "launches": launches, "w8a8_calls": w8}


# Phase ``loop``: the frame loops' contract (``generation/core.py``) on the card.
LOOP_FRAMES = 32  # the sync check's and the read count's staged run and stream
LOOP_BATCH_FRAMES = 16  # its B = 8 batch and streaming batch (the eager batched loop: ~150 ms a frame)
LOOP_EOS_FROM = 40  # the overrun check's EOS id first appears at this frame of the staged run, or later


@contextlib.contextmanager
def sync_free_loops():
    """While entered, every frame that a frame loop runs between two of its
    looks at the device runs under ``torch.cuda.set_sync_debug_mode("error")``:
    a call that waits for the card there raises. The mode is off during each
    look (its wait on the previous look's event, the one blocking call the
    contract allows) and outside the loops (the prologue, the vocoder, the
    sessions' reads)."""
    read, loops = core._FlagReader.read, (core.generate_frames, core.generate_frames_replicas)

    def looked(self, flag):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(self, flag)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def scoped(fn):
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    core._FlagReader.read = looked
    core.generate_frames, core.generate_frames_replicas = (scoped(fn) for fn in loops)
    try:
        yield
    finally:
        core._FlagReader.read = read
        core.generate_frames, core.generate_frames_replicas = loops
        torch.cuda.set_sync_debug_mode(0)


def loop_sync_check(model: Qwen3TTS, label: str, card: str) -> dict:
    """The staged run and a stream at lookahead 1 (``LOOP_FRAMES`` frames),
    a B = 8 ``synthesize_batch`` and ``synthesize_streaming_batch``
    (``LOOP_BATCH_FRAMES`` frames) under ``sync_free_loops``, each with the
    launch counts set to 0 just before it: nothing synchronises between two
    looks, and the kernels of each path launch."""
    opts = main_options(LOOP_FRAMES)
    bopts = replace(st.batch_options(), max_length=LOOP_BATCH_FRAMES, min_new_tokens=LOOP_BATCH_FRAMES)
    texts = list(st.BATCH_TEXTS[:BATCH])
    runs = {
        "staged": lambda: model._custom_voice_session(TEXT, "ryan", "english", opts).run_to_completion(),
        "stream": lambda: list(model.synthesize_streaming(TEXT, "ryan", "english", opts)),
        "batch8": lambda: model.synthesize_batch(texts, options=bopts),
        "stream_batch8": lambda: list(model.synthesize_streaming_batch(texts, options=bopts)),
    }
    out = {}
    tokenizer = model.tokenizer
    try:
        for name, run in runs.items():
            model.tokenizer = st.WordTokenizer() if name.endswith("8") else tokenizer
            _reset_counts()
            error = None
            with sync_free_loops():
                try:
                    run()
                except RuntimeError as e:  # the sync debug mode's error
                    error = str(e).splitlines()[0]
            out[name] = launches = _counts()
            phase("loop", f"{card}: {label} {name} under set_sync_debug_mode('error') between looks: "
                  f"{'no synchronising call' if error is None else 'RAISED: ' + error}; launches {launches}")
            check(error is None, f"loop {label} {name}: a synchronising call in the frame loop: {error}")
    finally:
        model.tokenizer = tokenizer
    staged, stream, batch, sbatch = (out[k] for k in runs)
    check(staged["cp_frame"] == staged["talker_step"] == LOOP_FRAMES, f"loop {label} staged: launches {staged}")
    check(stream["residual_unit_stream"] > 0 and stream["cp_frame"] == LOOP_FRAMES,
          f"loop {label} stream: launches {stream}")
    check(batch["residual_unit"] == 9 and batch["cp_frame"] == 0, f"loop {label} batch: launches {batch}")
    check(sbatch["residual_unit_stream"] > 0, f"loop {label} streaming batch: launches {sbatch}")
    check(("int8" not in label) or batch["int8_matmul"] > 0, f"loop {label} batch: kernel 4 never launched")
    return out


def loop_reads(model: Qwen3TTS, label: str, card: str) -> dict:
    """``TransferAudit`` over one loop call of batch 1 (``LOOP_FRAMES`` and
    ``FRAMES`` frames) and of B = 8 (``LOOP_BATCH_FRAMES``): within
    ``loop_read_bound``; and over a whole staged utterance (a record)."""
    out = {}
    for frames in (LOOP_FRAMES, FRAMES):
        session = model._custom_voice_session(TEXT, "ryan", "english", main_options(frames))
        _, out[f"batch1_{frames}"] = count_host_transfers(session._advance, frames)
        check(session.frames_generated == frames, f"loop {label}: {session.frames_generated} frames, want {frames}")
    tokenizer, model.tokenizer = model.tokenizer, st.WordTokenizer()
    try:
        opts = replace(st.batch_options(), max_length=LOOP_BATCH_FRAMES, min_new_tokens=LOOP_BATCH_FRAMES)
        b = BATCH
        g = model._prepare_batch_group("basic", list(st.BATCH_TEXTS[:b]), ["ryan"] * b, ["english"] * b, [None] * b,
                                       model._normalize_options(opts), [42 + i for i in range(b)])
        _, out["batch8"] = count_host_transfers(
            core.generate_frames_batch, model.talker_params, model.cp_params, model.config.talker,
            model.config.code_predictor, g.scfg, g.state, g.trailing, g.trailing_lens, g.pad_embed, g.uniforms,
            g.frame_limits)
    finally:
        model.tokenizer = tokenizer
    _, out["utterance"] = count_host_transfers(model.synthesize_with_timing, TEXT, "ryan", "english", main_options())
    bounds = {k: loop_read_bound(LOOP_BATCH_FRAMES if k == "batch8" else int(k.split("_")[1]))
              for k in out if k != "utterance"}
    phase("loop", f"{card}: {label} host reads (TransferAudit), N = {core.DONE_READ_EVERY}: batch-1 loop call of "
          f"{LOOP_FRAMES} frames {out[f'batch1_{LOOP_FRAMES}']} (bound {bounds[f'batch1_{LOOP_FRAMES}']}), of "
          f"{FRAMES} frames {out[f'batch1_{FRAMES}']} (bound {bounds[f'batch1_{FRAMES}']}); B={BATCH} loop call of "
          f"{LOOP_BATCH_FRAMES} frames {out['batch8']} (bound {bounds['batch8']}); a whole staged utterance of "
          f"{FRAMES} frames (prefill, loop, decode) {out['utterance']}")
    check(all(out[k] <= bound for k, bound in bounds.items()), f"loop {label}: host reads {out} over {bounds}")
    return out


def eos_run(model: Qwen3TTS, ref: np.ndarray) -> tuple[int, int, int, np.ndarray]:
    """The staged run with its EOS id set to the first token of ``ref`` (the
    staged session's frames) that appears at frame ``LOOP_EOS_FROM`` or
    later, one loop call: (that frame, frames made, iterations launched, the
    frames buffer)."""
    tokens = ref[:, 0]
    at = next((i for i in range(LOOP_EOS_FROM, len(tokens)) if tokens[i] not in tokens[:i]), None)
    check(at is not None, f"loop: no token of the staged run first appears after frame {LOOP_EOS_FROM}")
    opts = replace(main_options(), min_new_tokens=2, eos_token_id=int(tokens[at]))
    session = model._custom_voice_session(TEXT, "ryan", "english", opts)
    session._advance(FRAMES)
    check(bool(session.state.done), f"loop: the run with EOS at frame {at} is not done")
    return at, session.frames_generated, session.state.steps, session.state.frames.cpu().numpy()


def loop_overrun(model: Qwen3TTS, label: str, card: str, ref: np.ndarray) -> dict:
    """Frames run past EOS (``eos_run``): the loop must stop at EOS, its
    frames those of ``ref`` up to it, and run at most 2N - 1 frozen
    iterations."""
    at, n, steps, frames = eos_run(model, ref)
    overrun = steps - n
    phase("loop", f"{card}: {label} EOS at frame {at} (token {int(ref[at, 0])}): {n} frames, {steps} iterations "
          f"launched, {overrun} frozen past EOS (bound 2N - 1 = {2 * core.DONE_READ_EVERY - 1}); frames equal to the "
          f"staged run's up to EOS {np.array_equal(frames[:n], ref[:n])}, rows past it zero {not frames[n:].any()}")
    check(n == at, f"loop {label}: EOS at frame {at}, the loop made {n} frames")
    check(0 <= overrun <= 2 * core.DONE_READ_EVERY - 1, f"loop {label}: {overrun} frames past EOS")
    check(np.array_equal(frames[:n], ref[:n]) and not frames[n:].any(), f"loop {label}: frames past EOS leaked")
    return {"eos_at": at, "overrun": overrun}


def stream_timing(model: Qwen3TTS, lookahead: int) -> tuple[list, float, list]:
    """One ``synthesize_streaming`` of the main path's utterance at
    ``lookahead``, pulled chunk by chunk: (chunks, TTFA ms, gaps ms)."""
    opts = replace(main_options(), streaming_lookahead=lookahead)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks, at = [], []
    for chunk in model.synthesize_streaming(TEXT, "ryan", "english", opts):
        at.append(time.perf_counter())
        chunks.append(chunk.samples)
    return chunks, (at[0] - t0) * 1e3, [(b - a) * 1e3 for a, b in zip(at, at[1:])]


def loop_streams(model: Qwen3TTS, label: str, card: str) -> dict:
    """The streamed utterance at lookahead 0 and 1, in turns (0, 1, 1, 0)
    after a warm stream at each: TTFA and the gaps between chunks; every
    chunk at lookahead 1 bit-equal to lookahead 0's."""
    runs = {0: [], 1: []}
    for k in (0, 1, 1, 0, 0, 1):
        runs[k].append(stream_timing(model, k))
    runs = {k: v[1:] for k, v in runs.items()}  # each lookahead's first stream: warm
    base = runs[0][0][0]
    equal = all(len(c) == len(base) and all(np.array_equal(a, b) for a, b in zip(c, base))
                for r in runs.values() for c, _, _ in r)
    out = {k: {"ttfa_ms": [t for _, t, _ in r], "gap_ms": [g for _, _, gs in r for g in gs]} for k, r in runs.items()}
    phase("loop", f"{card}: {label} streamed ({len(base)} chunks): " + "; ".join(
        f"lookahead {k}: TTFA {', '.join(f'{t:.2f}' for t in v['ttfa_ms'])} ms, gaps {min(v['gap_ms']):.2f}-"
        f"{max(v['gap_ms']):.2f} ms (median {float(np.median(v['gap_ms'])):.2f})" for k, v in out.items())
          + f"; chunks bit-equal across lookaheads {equal}")
    check(equal, f"loop {label}: the stream at lookahead 1 differs from lookahead 0")
    return out


def loop_phase(model: Qwen3TTS, label: str, ref: np.ndarray, batch: dict) -> dict:
    """Phase ``loop`` on a 1.7B main-path ``model`` (kernels 1 and 3 at
    batch 1, kernel 2's stream entry in the streams, kernel 2 at B = 8 and,
    in int8, kernel 4 in the batches): the sync check, the host reads, the
    frames past EOS, the streams at lookahead 0 and 1,
    and the B = 8 frames/s phase ``batch`` measured on the same loop (its
    ``batch`` cells). The f32 fixtures' token-exactness through the same
    loops is phase ``utterance``'s."""
    t0 = time.perf_counter()
    card = card_line()
    out = {"launches": loop_sync_check(model, label, card), "reads": loop_reads(model, label, card),
           "overrun": loop_overrun(model, label, card, ref), "streams": loop_streams(model, label, card)}
    cell = batch["cells"][BATCH]
    phase("loop", f"{card}: {label} staged batch-1 {STAGED_MS_PER_FRAME[label]:.4f} ms/frame (phase e2e's timed "
          f"run); B={BATCH} {cell['frames_per_s']:.1f} frames/s, {cell['ms_per_frame']:.3f} ms/frame (phase batch); "
          f"phase wall time {time.perf_counter() - t0:.1f} s")
    return out


def _row(name: str) -> dict:
    return next(row for row in KERNEL_ROWS if row["name"] == name)


def main_path(encoders: tuple) -> dict:
    """The 1.7B main path in bf16 (the talker fused on the card: kernel 3 on
    plain weights), then in int8 on the same synthetic trees: each staged,
    streamed and through ``synthesize_with_voice``; the grown session in
    bf16. After each, the same trees cloning (with ``encoders``) and
    designing a voice (``clone_and_design``); in bf16 the layer path past
    kernel 3's gate and the ICL prefix's pieces on kernel 2's stream entry,
    in int8 kernel 4 at the clone and design prompts' rows."""
    t0 = time.perf_counter()
    model = Qwen3TTS.from_random(config_for_variant("1.7B", "custom_voice"), seed=0, device=DEV)
    model.tokenizer = BenchTokenizer()
    torch.cuda.synchronize()
    phase("e2e", f"1.7B CustomVoice synthetic weights built in {time.perf_counter() - t0:.1f} s")
    bf16, staged = run_main_path(model, "1.7B bf16", ("cp_frame", "talker_step", "residual_unit"),
                                 absent=("int8_matmul", "fused_attention_step", "fused_mlp_step",
                                         "streamed_decode_step"))
    jacobi_bf16 = jacobi_utterance(model, "1.7B bf16", int8=False)
    ref = staged_reference(model, staged)
    stream_bf16 = stream_session(model, "1.7B bf16", staged, *ref, ("cp_frame", "talker_step"))
    voice_bf16 = voice_session(model, "1.7B bf16", staged, *ref[1:], ("cp_frame", "talker_step"))
    grown_session(model)
    clone_bf16 = clone_and_design(model, "1.7B bf16", encoders, ("cp_frame", "talker_step"))
    layer_path_past_gate(model)
    _row("residual_unit_stream")["prefix_pieces"] = prefix_pieces_timing(model)
    batch_bf16 = batch_main(model, "1.7B bf16", int8=False)
    served = server_phase(model, "1.7B bf16")
    loop_phase(model, "1.7B bf16", ref[0], batch_bf16)

    t0 = time.perf_counter()
    m8 = Qwen3TTS(model.config, model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer,
                  quantize_int8=True)
    m8w = Qwen3TTS(model.config, model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer,
                   quantize_int8=True, int8_activations=True)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("e2e", f"1.7B int8 model quantized from the same trees in {time.perf_counter() - t0:.1f} s")
    int8, staged = run_main_path(m8, "1.7B int8", ("cp_frame", "talker_step", "int8_matmul", "residual_unit"),
                                 absent=("fused_attention_step", "fused_mlp_step", "streamed_decode_step"))
    jacobi_int8 = jacobi_utterance(m8, "1.7B int8", int8=True)
    ref = staged_reference(m8, staged)
    stream_int8 = stream_session(m8, "1.7B int8", staged, *ref, ("cp_frame", "talker_step"))
    voice_int8 = voice_session(m8, "1.7B int8", staged, *ref[1:], ("cp_frame", "talker_step"))
    clone_int8 = clone_and_design(m8, "1.7B int8", encoders, ("cp_frame", "talker_step", "int8_matmul"))
    batch_int8 = batch_main(m8, "1.7B int8", int8=True)
    loop_phase(m8, "1.7B int8", ref[0], batch_int8)  # before server_w8a8 changes its tokenizer
    served["w8a8"] = server_w8a8(m8, m8w, card_line())
    del m8, m8w
    prompt_rows = sorted({m for m in clone_int8["rows"].values() if m > 16})
    _row("int8_matmul")["prompt_shapes"] = kernel4_prompt_rows(prompt_rows)
    _row("int8_matmul")["batch_shapes"] = kernel4_batch_shapes(batch_int8["cells"][BATCH].pop("kernel4_inputs"))
    _row("int8_matmul")["batch_launches_by_rows"] = batch_int8["cells"][BATCH]["kernel4_rows"]
    _row("int8_matmul")["jacobi_launches_by_rows"] = jacobi_int8["jacobi"]["kernel4_rows"]
    _row("residual_unit")["batch"] = {**batch_bf16["kernel2"],
                                      "launches": batch_bf16["cells"][BATCH]["launches"]["residual_unit"]}
    runs = {"bf16": bf16, "int8": int8, "stream_bf16": stream_bf16["launches"], "stream_int8": stream_int8["launches"],
            "voice_bf16": voice_bf16["launches"], "voice_int8": voice_int8["launches"],
            **{f"batch{b}_{dtype}": run["cells"][b]["launches"] for dtype, run in (("bf16", batch_bf16),
                                                                                   ("int8", batch_int8))
               for b in st.BATCH_SIZES},
            "stream_batch8_bf16": batch_bf16["stream"]["launches"],
            "jacobi_bf16": jacobi_bf16["jacobi"]["launches"], "jacobi_int8": jacobi_int8["jacobi"]["launches"],
            "server_solo_bf16": served["solo"]["launches"], "server_batch8_bf16": served["batch"]["launches"],
            "server_streams8_bf16": served["streams"]["launches"],
            **{f"clone_{dtype} {kind}": run["launches"] for dtype, clone in (("bf16", clone_bf16), ("int8", clone_int8))
               for kind, run in clone["runs"].items()},
            **per_step_main_paths()}
    return runs


def per_step_main_paths() -> dict:
    """The 1.7B int8 main path with a code predictor that the JAX gates send
    to the per-step path: vocab 2047 (odd; kernel 7 per step, through the
    ``CpStepPack`` the model holds) and intermediate 2816 (not a multiple of
    1024; kernels 5 + 6 per layer through its ``FusedStepPack``, 70 launches
    of each a frame: 14 steps of 5 layers)."""
    base = config_for_variant("1.7B", "custom_voice")
    runs = {}
    for path, change, route, kernels in (
        ("int8_cp_vocab_2047", dict(vocab_size=2047), "streamed_step", ("streamed_decode_step",)),
        (f"int8_cp_inter_{LAYER_STEPS_INTER}", dict(intermediate_size=LAYER_STEPS_INTER), "layer_steps",
         ("fused_attention_step", "fused_mlp_step")),
    ):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = replace(base, code_predictor=replace(base.code_predictor, **change))
        model = Qwen3TTS.from_random(cfg, seed=0, device=DEV, quantize_int8=True)
        model.tokenizer = BenchTokenizer()
        torch.cuda.synchronize()
        got = cp.cp_route(model.cp_params, cfg.code_predictor)
        phase("e2e", f"1.7B int8, code predictor {change}: built in {time.perf_counter() - t0:.1f} s, route {got}")
        check(got == route, f"1.7B int8 {change}: code-predictor route {got}, want {route}")
        pack_kind = fused_layer.CpStepPack if route == "streamed_step" else fused_layer.FusedStepPack
        check(isinstance(model.cp_step_pack, pack_kind), f"1.7B int8 {change}: the model holds "
                                                         f"{type(model.cp_step_pack).__name__}, want {pack_kind.__name__}")
        others = tuple(k for k in ("cp_frame", "fused_attention_step", "fused_mlp_step", "streamed_decode_step")
                       if k not in kernels)
        runs[path], _ = run_main_path(model, f"1.7B int8 ({path})",
                                      ("talker_step", "int8_matmul", "residual_unit") + kernels, absent=others)
        steps = (cfg.code_predictor.num_acoustic - 1) * (1 if route == "streamed_step" else
                                                         cfg.code_predictor.num_hidden_layers)
        per_frame = {k: runs[path][k] / FRAMES for k in kernels}
        phase("e2e", f"1.7B int8 ({path}): launches a frame {per_frame} (want {steps} of each)")
        check(all(runs[path][k] == steps * FRAMES for k in kernels),
              f"1.7B int8 ({path}): launches {per_frame} a frame, want {steps} of each")
        del model
    return runs


def _assert_trees_equal(got, want, what: str) -> None:
    """Same structure, dtypes and bits, leaf by leaf."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            return check(False, f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{what}: {len(got)} items, want {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{what}[{i}]")
    elif want is None:
        check(got is None, f"{what}: not None")
    else:
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{what}: not bit-equal ({got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")


def cli_run(argv: list, seen: dict) -> tuple:
    """``cli.main(argv)`` in process. ``from_pretrained`` is wrapped to keep
    the model it builds (``seen["model"]``, its load time ``seen["load_s"]``)
    and to set every launch count to 0 as it returns, just before the CLI
    drives the path; ``synthesize_streaming`` to keep the session
    (``seen["session"]``). Returns (launches, the CLI's stderr)."""
    loader = Qwen3TTS.__dict__["from_pretrained"].__func__
    streaming = Qwen3TTS.synthesize_streaming

    def load(cls, *a, **k):
        t0 = time.perf_counter()
        seen["model"] = loader(cls, *a, **k)
        torch.cuda.synchronize()
        seen["load_s"] = time.perf_counter() - t0
        _reset_counts()
        return seen["model"]

    def keep_session(self, *a, **k):
        seen["session"] = streaming(self, *a, **k)
        return seen["session"]

    err = io.StringIO()
    Qwen3TTS.from_pretrained, Qwen3TTS.synthesize_streaming = classmethod(load), keep_session
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        Qwen3TTS.from_pretrained, Qwen3TTS.synthesize_streaming = classmethod(loader), streaming
    launches = _counts()
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    return launches, err.getvalue()


def ckpt_phase() -> None:
    """Phase ``ckpt`` (see the module docstring, item 11)."""
    t_phase = time.perf_counter()
    cfg = config_for_variant("1.7B", "custom_voice")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    hf = ckpt_fixture.generated_weights(ckpt_fixture.model_specs(cfg), gen, torch.bfloat16)
    speech = ckpt_fixture.generated_weights(ckpt_fixture.speech_specs(), gen, torch.float32)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="qwen3_tts_ckpt_") as d:
        t0 = time.perf_counter()
        n_bytes = ckpt_fixture.write_checkpoint(d, cfg, hf, speech)
        t_write = time.perf_counter() - t0
        model_file = Path(d) / "model.safetensors"
        model_bytes = model_file.stat().st_size
        t0 = time.perf_counter()
        raw = W.load_safetensors(model_file, DEV)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        _assert_trees_equal(raw, hf, "safetensors reader")
        del raw
        t0 = time.perf_counter()
        model = Qwen3TTS.from_pretrained(d, device=DEV)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        phase("ckpt", f"1.7B CustomVoice checkpoint (28 talker layers, bf16; vocoder f32): {n_bytes / 1e9:.3f} GB "
              f"written in {t_write:.2f} s ({n_bytes / 1e9 / t_write:.2f} GB/s, the card's tensors "
              f"copied to the host included); model.safetensors ({model_bytes / 1e9:.3f} GB, just written: read "
              f"from the page cache) read onto the card in {t_read:.2f} s "
              f"({model_bytes / 1e9 / t_read:.2f} GB/s), bit-equal to the tensors written; from_pretrained "
              f"{t_load:.2f} s (both files, tokenizer, key maps, fusion, kernel packs)")
        _assert_trees_equal(model.talker_params, W.fuse_model_params(W.load_talker_params(hf, cfg.talker)),
                            "talker tree")
        _assert_trees_equal(model.cp_params, W.fuse_model_params(W.load_code_predictor_params(hf, cfg.code_predictor)),
                            "code-predictor tree")
        _assert_trees_equal(model.vocoder_params, vocoder.load_vocoder_params(speech, model.vocoder_config),
                            "vocoder tree")
        check(model.cp_frame_pack is not None and model.talker_step_pack is not None,
              "from_pretrained's model holds no kernel 1 / kernel 3 pack")
        phase("ckpt", "every tree of from_pretrained's model bit-equal to the key maps of the tensors in memory; "
              f"kernel 1 and kernel 3 packs built; tokenizer ids of the text {model.tokenizer.encode(TEXT)}")
        del model, hf, speech
        torch.cuda.empty_cache()

        opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42)
        chunks = 1 + math.ceil((FRAMES - opts.first_chunk_frames) / opts.chunk_frames)
        base = ["-m", d, "-t", TEXT, "-f", str(FRAMES), "--min-new-tokens", str(FRAMES), "--seed", "42",
                "--output", str(Path(d) / "out.wav"), "--dump-codes"]
        never = ("fused_attention_step", "fused_mlp_step", "streamed_decode_step")
        for label, extra, want in (
            ("default", [], {"cp_frame": FRAMES, "talker_step": FRAMES, "residual_unit": 9,
                             "residual_unit_stream": 0, "int8_matmul": 0}),
            ("--streaming", ["--streaming"], {"cp_frame": FRAMES, "talker_step": FRAMES, "residual_unit": 0,
                                              "residual_unit_stream": 9 * chunks, "int8_matmul": 0}),
            ("--int8", ["--int8"], {"cp_frame": FRAMES, "talker_step": FRAMES, "residual_unit": 9,
                                    "residual_unit_stream": 0}),
        ):
            seen = {}
            t0 = time.perf_counter()
            launches, err = cli_run(base + extra, seen)
            wall = time.perf_counter() - t0
            model = seen["model"]
            if label == "--streaming":
                session = seen["session"]
                codes = session.state.frames[:session.frames_generated].cpu().numpy()
            else:
                codes = np.fromfile(Path(d) / "out.codes.bin", np.int32).reshape(-1, 16)
            api = model.synthesize_streaming(TEXT, "ryan", "english", opts).run_to_completion()
            rtf = re.search(r"RTF ([0-9.]+)\)", err)
            phase("ckpt", f"cli.main {label}: from_pretrained {seen['load_s']:.2f} s; the CLI's RTF "
                  f"{rtf.group(1) if rtf else None} over {len(codes)} frames (wall of main {wall:.2f} s, load "
                  "included); "
                  f"codes equal to the API's on the same model {codes.shape == api.shape and (codes == api).all()}; "
                  f"launches {launches}")
            check(codes.shape == api.shape == (FRAMES, 16) and bool((codes == api).all()),
                  f"ckpt {label}: the CLI's codes differ from the API's on the same model")
            for k, n in want.items():
                check(launches[k] == n, f"ckpt {label}: {k} launched {launches[k]} times, want {n}")
            check(label != "--int8" or launches["int8_matmul"] > 0, "ckpt --int8: kernel 4 never launched")
            check(all(launches[k] == 0 for k in never), f"ckpt {label}: kernel 5, 6 or 7 launched: {launches}")
            del model, seen
            torch.cuda.empty_cache()
        phase("ckpt", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
        validation_phase(d, Path(d) / "out.wav")
    phase("ckpt", "the checkpoint directory deleted")


# ---------------------------------------------------------------------------
# Phase validation: the port's validation chain (qwen3_tts_tpu_torch/validation)
# ---------------------------------------------------------------------------

VALIDATION_STEPS = 16  # the quant report's decode steps (its default)
VALIDATION_MATRIX_FRAMES = 4
VALIDATION_PROFILE_FRAMES = 32
# Random weights cannot meet the production audio gates: the drill's gates.
DRILL_GATES = {"min_rms": 0.0, "max_clipping": 1.0, "max_leading_silence": 99.0, "max_dc": 1.0}
# torch._int_mm's K and N on the card are multiples of 8: the w8a8 product
# at a K and N that are not (``quant.w8a8_padded``).
W8A8_ODD_KN = (2050, 3074)


def validation_quant_report(d: str, card: str) -> dict:
    """The quant report at full depth on the checkpoint: the promote numbers
    of int8 and of w8a8 and the decision; the int8 run takes kernels 1 and
    3 once a step and kernel 4, the w8a8 run (the batched loop's layer
    paths) ``w8a8_matmul`` for every product and no kernel."""
    t0 = time.perf_counter()
    plain = Qwen3TTS.from_pretrained(d, device=DEV)
    int8 = Qwen3TTS.from_pretrained(d, device=DEV, quantize_int8=True)
    rep = quant_report.report(plain, int8, VALIDATION_STEPS, d)
    del plain, int8
    torch.cuda.empty_cache()
    snrs = [v["min_db"] for sec in ("talker_weight_snr", "cp_weight_snr") for v in rep[sec].values()]
    for key in ("logit_drift", "logit_drift_w8a8"):
        dr = rep[key]
        phase("validation", f"{card}: quant-report {key} over {dr['steps']} steps: worst-layer weight SNR "
              f"{min(snrs):.2f} dB (criterion >= 30), mean logit KL {dr['mean_logit_kl']:.4e} (<= 5e-3), talker "
              f"argmax flip rate {dr['talker_argmax_flip_rate']:.4f} (<= 0.01), CP code flip rate "
              f"{dr['cp_code_flip_rate']:.4f} (<= 0.01); the int8 run's launches {dr['launches']}")
    phase("validation", f"quant-report: promote_int8 {rep['promote_int8']} (random weights: near-uniform logits, "
          f"the flip rates overstate drift); device {rep['device']}; {time.perf_counter() - t0:.1f} s")
    steps, wo, wa = VALIDATION_STEPS, rep["logit_drift"]["launches"], rep["logit_drift_w8a8"]["launches"]
    check(snrs and min(snrs) >= quant_report.PROMOTE_CRITERION["min_weight_snr_db"],
          f"quant-report: worst-layer weight SNR {min(snrs)} dB (uniform weights give ~48)")
    check(all(math.isfinite(rep[k][m]) for k in ("logit_drift", "logit_drift_w8a8")
              for m in ("mean_logit_kl", "talker_argmax_flip_rate", "cp_code_flip_rate")), "quant-report: a NaN")
    check(wo.get("cp_frame") == wo.get("talker_step") == steps and wo.get("int8_matmul", 0) > 0
          and "w8a8_matmul" not in wo, f"quant-report int8 launches {wo}")
    check(set(wa) == {"w8a8_matmul"}, f"quant-report w8a8 launches {wa} (the layer paths: w8a8_matmul alone)")
    return rep


def validation_trace(d: str, card: str) -> dict:
    """The CLI with ``--profile`` in a process of its own (in this process
    the profiler's later sessions record nothing), then the trace report of
    its trace: kernels 1, 2 and 3 among the top device kernels by name."""
    n = VALIDATION_PROFILE_FRAMES
    trace_dir = Path(d) / "trace"
    cmd = [sys.executable, "-m", "qwen3_tts_tpu_torch", "-m", d, "-t", TEXT, "-f", str(n), "--min-new-tokens", str(n),
           "--seed", "42", "--output", str(Path(d) / "profiled.wav"), "--profile", str(trace_dir)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"the CLI with --profile exited {r.returncode}: {r.stderr[-2000:]}")
    planes = trace_report.summarize(trace_dir, "kernel")
    check(len(planes) == 1, f"trace-report: {len(planes)} kernel categories in {trace_dir}")
    top, groups = planes[0]["top"], planes[0]["groups"]
    named = {row["group"]: row for row in top}
    want = ("kernel 1: cp_frame", "kernel 2: residual_unit", "kernel 3: talker_step")
    per_frame = {g: round(groups[g] / n, 4) for g in want if g in groups}
    phase("validation", f"{card}: trace-report of the CLI --profile run ({n} frames, bf16; "
          f"{time.perf_counter() - t0:.1f} s): device time {planes[0]['total_ms']:.3f} ms, ms a frame {per_frame}; launches in the trace "
          f"{ {g: named[g]['count'] for g in want if g in named} }; top 5 "
          f"{[(row['group'], round(row['ms'], 3), row['count']) for row in top[:5]]}")
    check(all(g in named for g in want), f"trace-report: kernels 1-3 not among the top named device kernels: "
          f"{[row['group'] for row in top]}")
    check(named[want[0]]["count"] == named[want[2]]["count"] == n and named[want[1]]["count"] == 9,
          f"trace-report: launches {[(g, named[g]['count']) for g in want]}, want {n}, 9, {n}")
    return {"ms_per_frame": per_frame, "total_ms": planes[0]["total_ms"]}


BF16_PLACEMENT = "bf16 mesh == solo (f32 greedy frames; audio atol 1e-5)"
INT8_PLACEMENT = "int8 mesh == solo (f32 greedy frames; audio atol 1e-5)"
W8A8_PLACEMENT = "w8a8 batch mesh == solo (f32 greedy, atol 1e-5)"


def validation_parity(d: str, card: str) -> dict:
    """The parity matrix at ``VALIDATION_MATRIX_FRAMES`` frames on the 1.7B
    checkpoint, then at its default frames on the drill's tiny checkpoint
    (``validation.__main__.drill_checkpoint``), each on this machine's mesh
    (four distinct cards, or ranks sharing the first). Every cell of the
    tiny matrix must pass; of the 1.7B one every cell but the int8 and w8a8
    cross-placement ones, which are reported: their products round the
    activations (int8: to bf16; w8a8: to int8 by each row's amax), so the
    mesh's partial sums in another order (row-parallel products, the text
    projection) flip a rounding here and there, and 28 random layers carry
    the flip to the codes (phase ``tp`` (b) gates the tp int8 step against
    the unsharded kernel-3 step by its own spread under a 2^-22 change of
    the scales). The int8 mesh cells must take kernels 5 and 6."""
    from qwen3_tts_tpu_torch.validation.__main__ import drill_checkpoint

    def log(line: str) -> None:
        phase("validation", line.strip())

    t0 = time.perf_counter()
    full = parity_matrix.run(d, VALIDATION_MATRIX_FRAMES, device=DEV, log=log)
    t_full = time.perf_counter() - t0
    tiny = parity_matrix.run(str(drill_checkpoint(Path(d) / "drill")), device=DEV, log=log)
    cells = full["cells"]
    int8, w8a8 = cells[INT8_PLACEMENT], cells[W8A8_PLACEMENT]
    mesh = int8["launches"]["f32_greedy"]
    phase("validation", f"{card}: parity-matrix on {full['mesh']}: 1.7B at {VALIDATION_MATRIX_FRAMES} frames "
          f"({t_full:.1f} s): cross-placement bf16 {cells[BF16_PLACEMENT]['pass']} (gated); int8 frames equal "
          f"{int8['frames_equal']} (share {int8['share']:.4f}, first differing frame {int8['first_differing_frame']}, "
          f"max|audio delta| {int8['audio_delta']:.3e}); w8a8 max|audio delta| {w8a8['audio_delta']:.3e} (both "
          f"reported); the int8 mesh's launches {mesh}; the drill's tiny checkpoint, every cell gated: failures "
          f"{tiny['failures']} ({time.perf_counter() - t0:.1f} s in all)")
    check(set(full["failures"]) <= {INT8_PLACEMENT, W8A8_PLACEMENT}, f"parity-matrix 1.7B: {full['failures']}")
    check(not tiny["failures"], f"parity-matrix on the drill's checkpoint: {tiny['failures']}")
    check(mesh.get("fused_attention_step", 0) > 0 and mesh.get("fused_mlp_step", 0) > 0,
          f"parity-matrix: the int8 mesh never took kernels 5 and 6: {mesh}")
    return {"full": full, "tiny": tiny}


def validation_phase(d: str, wav: Path) -> dict:
    """Phase ``validation`` (see the module docstring, item 11) in phase
    ``ckpt``'s directory, on its 1.7B checkpoint."""
    t_phase = time.perf_counter()
    card = card_line()
    out = {"quant_report": validation_quant_report(d, card)}

    out["parity_matrix"] = validation_parity(d, card)

    gate = quality.check_wav(wav, **DRILL_GATES)
    default = quality.check_wav(wav)
    phase("validation", f"quality gate on the CLI's WAV: {gate} (the drill's gates); the production gates: "
          f"{'PASS' if default['pass'] else 'FAIL ' + '; '.join(default['failures'])} (a record: random weights)")
    check(gate["pass"], f"quality gate: {gate['failures']}")

    bad = [f"{s['module']}:{s['line']}" for s in audit.read_sites()
           if (s["module"], s["function"]) not in audit.ALLOWED]
    before = launch_counts()
    reads = audit.dynamic_audit(DEV)
    phase("validation", f"audit: static read sites outside the loop contract {bad}; dynamic host reads {reads} "
          f"(bound {loop_read_bound(8)}); launches {launches_since(before)}")
    check(not bad, f"audit: read sites outside the loop contract: {bad}")

    g = torch.Generator().manual_seed(W8A8_ODD_KN[0])
    k, n = W8A8_ODD_KN
    for m in (1, 24):
        x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = quant.w8a8_int_mm(x.to(DEV), w.to(DEV)).cpu()
        equal = got.shape == (m, n) and torch.equal(got, torch._int_mm(x, w))
        phase("validation", f"w8a8 at m={m} K={k} N={n} (not multiples of 8) on the card through the padded "
              f"torch._int_mm: bit-equal to the CPU's torch._int_mm {equal}")
        check(equal, f"w8a8 at m={m} K={k} N={n}: not the CPU's product")

    out["trace_report"] = validation_trace(d, card)
    phase("validation", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out



# ---------------------------------------------------------------------------
# Phase tp: multi-GPU serving (the (dp, tp) mesh, Qwen3TTS.shard)
# ---------------------------------------------------------------------------

TP_FRAMES = 32
# The full-depth step trials' cache rows (phase 7's shard case: pos near the top).
TP_ROWS = TP4["rows"]
# The f32 int8 tp step against the unsharded kernel-3 step: int8 products
# round their inputs to bf16 in f32 programs too, so partial sums in another
# order flip an input's rounding here and there, and 28 layers compound the
# flips (far past F32_STEP_TOL, which holds plain f32 weights). The bar is
# this multiple of the unsharded step's own spread when every int8 scale
# moves by 2^-22, read in the run on the same trials (as
# STREAM_SPREAD_FACTOR reads the decode's), and at least F32_STEP_TOL.
TP_F32_SPREAD_FACTOR = 2.0


def tp_devices(dp: int, tp: int) -> list[torch.device]:
    """The ranks' devices of a dp x tp mesh, in mesh order: with two cards or
    more, every card (replica r's ranks the cards r * tp + t, wrapping
    around), a tp group wider than the cards on cuda:0; with one card, every
    rank on it (ranks sharing a device add locally)."""
    n = torch.cuda.device_count()
    if n < 2 or n < tp:
        return [DEV] * (dp * tp)
    return [torch.device("cuda", (r * tp + t) % n) for r in range(dp) for t in range(tp)]


def _mesh(dp: int, tp: int) -> sharding.Mesh:
    mesh = sharding.make_mesh(tp_devices(dp, tp), tp=tp, dp=dp)
    phase("tp", f"torch.cuda.device_count() {torch.cuda.device_count()}; {mesh}; collectives "
          f"{collectives.route(mesh.replica(0))}")
    return mesh


def _collective_counts() -> dict:
    return {f"{op}.{route}": n for (op, route), n in sorted(collectives.counts.items())}


def tp_utterance(d: str, fixture: dict) -> None:
    """(a) Phase ``utterance``'s checkpoint loaded through
    ``from_pretrained(dtype=f32, mesh=)`` at tp = 4: greedy and PCG frames
    token-exact to the JAX fixture, audio within 1e-5 of max|audio|; the
    talker on the tensor-parallel layer path (a plain tree has no tp
    pack), kernel 1 once a frame, kernel 2 9 times, kernel 3 never."""
    mesh = _mesh(1, 4)
    t0 = time.perf_counter()
    model = Qwen3TTS.from_pretrained(d, dtype=torch.float32, mesh=mesh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(model.mesh is mesh and model.talker_step_pack is None and model.tp_step_packs is None
          and model.cp_frame_pack is not None, "tp utterance: the sharded f32 model's packs")
    n = ckpt_fixture.UTTERANCE_FRAMES
    for kind, temperature in (("greedy", 0.0), ("pcg", 0.9)):
        opts = SynthesisOptions(max_length=n, min_new_tokens=n, seed=42, temperature=temperature)
        _reset_counts()
        collectives.counts.clear()
        frames = model._custom_voice_session(ckpt_fixture.UTTERANCE_TEXT, "ryan", "english", opts).run_to_completion()
        audio = model.decode_codes(frames).samples
        launches = _counts()
        want, want_audio = fixture[f"frames_{kind}"], fixture[f"audio_{kind}"]
        equal = frames.shape == want.shape and bool((frames == want).all())
        share = float((frames == want).mean()) if frames.shape == want.shape else 0.0
        scale = float(np.abs(want_audio).max())
        err = float(np.abs(audio - want_audio).max()) if audio.shape == want_audio.shape else float("inf")
        phase("tp", f"(a) utterance checkpoint from_pretrained(f32, mesh tp=4) in {t_load:.1f} s, {kind}, {n} frames: "
              f"token-exact to the JAX fixture {equal} (share {share:.4f}); fixture margins: talker "
              f"{float(fixture['talker_margin']):.3e}, code predictor {float(fixture['cp_margin']):.3e}; "
              f"max|audio - JAX| {err / scale:.3e} of max|audio| (bar 1e-5); launches {launches}; collectives "
              f"{_collective_counts()}")
        check(equal, f"tp utterance {kind}: frames differ from the JAX fixture")
        check(err <= 1e-5 * scale, f"tp utterance {kind}: audio {err / scale:.3e} of max|audio| from the JAX fixture")
        check(launches["cp_frame"] == n and launches["talker_step"] == 0 and launches["residual_unit"] == 9
              and launches["fused_attention_step"] == 0, f"tp utterance {kind}: launches {launches}")
    del model
    torch.cuda.empty_cache()


def tp_batch(model: Qwen3TTS) -> None:
    """(c) The same f32 model (phase ``utterance``'s) sharded at dp = 3 x tp
    = 2: ``synthesize_batch`` of ``ckpt_fixture.BATCH_TEXTS`` (one stream a
    replica), greedy and PCG, held to the JAX fixture as phase ``batch``'s."""
    model.shard(_mesh(3, 2))
    group = model._prepare_batch_group("basic", list(ckpt_fixture.BATCH_TEXTS), ["ryan"] * 3, ["english"] * 3,
                                       [None] * 3, SynthesisOptions(max_length=4, seed=42), BATCH_FIXTURE_SEEDS)
    check([g.replica for g in group.shards] == [0, 1, 2], f"tp batch: streams on replicas "
          f"{[g.replica for g in group.shards]}")
    collectives.counts.clear()
    batch_fixture(model, "tp")
    phase("tp", f"(c) dp=3 x tp=2 batch collectives {_collective_counts()}")


def _f32_trees(model: Qwen3TTS) -> tuple:
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cast(v) for v in t)
        return t.float() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
    return cast(model.talker_params), cast(model.cp_params)


def _top2_margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float().reshape(-1), 2).values
    return float(top[0] - top[1])


def _staged_frames(model: Qwen3TTS) -> tuple:
    """TP_FRAMES staged frames (one warm run, then one timed with the launch
    counts set to 0 just before it): (frames, ms/frame, launches, the
    post-penalty logits of each frame)."""
    opts = main_options(TP_FRAMES)
    model._custom_voice_session(TEXT, "ryan", "english", opts).run_to_completion()
    logits = []
    session = model._custom_voice_session(TEXT, "ryan", "english", opts)
    session.on_frame = lambda idx, token, codes, lg: logits.append(lg)
    for d in {torch.device("cuda", i) for i in range(torch.cuda.device_count())}:
        torch.cuda.synchronize(d)
    _reset_counts()
    collectives.counts.clear()
    t0 = time.perf_counter()
    frames = session.run_to_completion()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    ms = (time.perf_counter() - t0) * 1e3 / max(len(frames), 1)
    return frames, ms, _counts(), logits


def _tp_caches(mesh: sharding.Mesh, ck: torch.Tensor, cv: torch.Tensor) -> tuple[list, list]:
    plane = sharding.P(None, None, "tp")
    return sharding.shard_leaf(ck, plane, mesh)[0], sharding.shard_leaf(cv, plane, mesh)[0]


@contextlib.contextmanager
def sublayer_bars(trees: dict, errs: dict):
    """Every kernel-5 / 6 call made inside, against its plain version on the
    same inputs (a copy of the caches): the largest output / written-row
    error relative to max|plain|, by sub-layer, into ``errs``. ``trees``:
    each pack's rank tree (by the pack's id), whose layer the call runs."""
    attn_k, mlp_k = fused_layer.fused_attention_step, fused_layer.fused_mlp_step

    def attention(x, layer, cos_t, sin_t, ck, cv, pos, *dims, residual=True, pack=None, layer_index=0):
        view = nn.layer_params_at(trees[id(pack)], layer_index)
        ckp, cvp = ck.clone(), cv.clone()
        want = fused_layer.fused_attention_step_plain(x, view, cos_t, sin_t, ckp, cvp, pos, *dims, residual=residual)
        got = attn_k(x, layer, cos_t, sin_t, ck, cv, pos, *dims, residual=residual, pack=pack, layer_index=layer_index)
        errs["attention"] = max(errs["attention"], rel_err(got, want), rel_err(ck[pos], ckp[pos]),
                                rel_err(cv[pos], cvp[pos]))
        return got

    def mlp(x, layer, inter, eps, residual=True, pack=None, layer_index=0):
        want = fused_layer.fused_mlp_step_plain(x, nn.layer_params_at(trees[id(pack)], layer_index), inter, eps,
                                                residual=residual)
        got = mlp_k(x, layer, inter, eps, residual=residual, pack=pack, layer_index=layer_index)
        errs["mlp"] = max(errs["mlp"], rel_err(got, want))
        return got

    # The kernels count their launches on the module's names, these wrappers.
    attention.launches, mlp.launches = attn_k.launches, mlp_k.launches
    fused_layer.fused_attention_step, fused_layer.fused_mlp_step = attention, mlp
    try:
        yield
    finally:
        fused_layer.fused_attention_step, fused_layer.fused_mlp_step = attn_k, mlp_k
        attn_k.launches, mlp_k.launches = attention.launches, mlp.launches


def tp_step_trials(sh: Qwen3TTS, ref: Qwen3TTS, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """STEP_TRIALS tp decode steps at random (x, pos), pos near the top of a
    TP_ROWS-row cache, each kernel-5 / 6 call in them against its plain
    version on the same inputs (``sublayer_bars``, phase 7's STEP_TOL);
    bf16: the step against the same route on the plain versions (phase 5's
    28-layer bars, HIDDEN_TOL and ROW_TOL); f32: against the unsharded
    model's kernel-3 step, whose own sensitivity is read on the same trials
    (the step again with every int8 scale moved by 2^-22): the normed hidden
    and the written rows within TP_F32_SPREAD_FACTOR times that spread, and
    the codec-head argmax equal wherever the unsharded step's top-2 margin
    exceeds TP_F32_SPREAD_FACTOR times its logits' move (a flip only at such
    a near-tie)."""
    tcfg = sh.config.talker
    stack = tcfg.layer_stack()
    mesh, tree = sh.mesh, sh.talker_params
    layers, packs = [r["layers"] for r in tree.ranks], [r["tp_pack"] for r in tree.ranks]
    kvd = stack.num_kv_heads * stack.head_dim
    ck0 = torch.randn((stack.num_layers, TP_ROWS, kvd), generator=gen, device=DEV).to(dtype)
    cv0 = torch.randn((stack.num_layers, TP_ROWS, kvd), generator=gen, device=DEV).to(dtype)
    r = {"h_err": 0.0, "row_err": 0.0, "argmax": 0, "trials": STEP_TRIALS, "spread": 0.0, "flips": [],
         "unexplained": 0}
    sub = r["sublayer"] = {"attention": 0.0, "mlp": 0.0}
    if dtype == torch.float32:
        ref_layers = ref.talker_params["layers"]
        nudged = {k: {"q8": w["q8"], "scale": w["scale"].clone()} if quant.is_quantized(w) else w
                  for k, w in ref_layers.items()}
        _nudge_int8_scales(nudged, 1 + 2.0**-22)
        nudged_pack = fused_layer.TalkerStepPack(nudged, stack, dtype, DEV)
    trees = {id(p): dict(lyr, qkv_proj=tpk["qkv"], gateup_proj=tpk["gu"])
             for p, lyr, tpk in zip(sh.tp_step_packs, layers, packs)}
    for trial in range(STEP_TRIALS):
        pos = TP_ROWS - 1 - 3 * trial
        x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=DEV).to(dtype)
        cks, cvs = _tp_caches(mesh, ck0, cv0)
        with sublayer_bars(trees, sub):
            fused_layer.tp_decode_step(layers, packs, x, stack, cks, cvs, pos, tree.devices, sh.tp_step_packs)
        cks, cvs = _tp_caches(mesh, ck0, cv0)
        if dtype == torch.bfloat16:
            got = fused_layer.tp_decode_step(layers, packs, x, stack, cks, cvs, pos, tree.devices, sh.tp_step_packs)
            pks, pvs = _tp_caches(mesh, ck0, cv0)
            with plain_kernels():
                want = fused_layer.tp_decode_step(layers, packs, x, stack, pks, pvs, pos, tree.devices)
            r["h_err"] = max(r["h_err"], rel_err(got, want))
            for a, b in zip(cks + cvs, pks + pvs):
                r["row_err"] = max(r["row_err"], rel_err(a[:, pos], b[:, pos]))
        else:
            h, logits = talker.decode_step_planes_tp(tree, tcfg, x, pos, cks, cvs, sh.tp_step_packs)
            ck, cv = ck0.clone(), cv0.clone()
            h_ref, logits_ref = talker.decode_step_planes(ref.talker_params, tcfg, x, pos, ck, cv,
                                                          ref.talker_step_pack)
            r["argmax"] += int(torch.argmax(logits)) == int(torch.argmax(logits_ref))
            r["h_err"] = max(r["h_err"], rel_err(h, h_ref))
            ckn, cvn = ck0.clone(), cv0.clone()
            h_nudged = fused_layer.talker_step(nudged, x, stack, ckn, cvn, pos, nudged_pack)
            h_nudged = nn.rms_norm(h_nudged, ref.talker_params["norm"], tcfg.rms_norm_eps)
            r["spread"] = max(r["spread"], rel_err(h_nudged, h_ref), rel_err(ckn[:, pos], ck[:, pos]),
                              rel_err(cvn[:, pos], cv[:, pos]))
            if int(torch.argmax(logits)) != int(torch.argmax(logits_ref)):
                # A flip is a near-tie when the unsharded step's top-2 margin is within
                # TP_F32_SPREAD_FACTOR times its logits' own move under the nudge.
                moved = float((talker.codec_logits(ref.talker_params, h_nudged)[:, 0] - logits_ref).abs().max())
                margin = _top2_margin(logits_ref)
                r["flips"].append((pos, margin, moved))
                r["unexplained"] += margin > TP_F32_SPREAD_FACTOR * moved
            # The ranks' rows, gathered onto the first card (each rank's on its own card under NCCL).
            r["row_err"] = max(r["row_err"], rel_err(torch.cat([c[:, pos].to(DEV) for c in cks], -1), ck[:, pos]),
                               rel_err(torch.cat([c[:, pos].to(DEV) for c in cvs], -1), cv[:, pos]))
    # Times at the last pos: the step (host clock, every card synchronised, and the
    # first card's span by CUDA events) over 20 steps; one all-reduce of the step's parts.
    steps = 20
    for dev in set(tree.devices):
        torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fused_layer.tp_decode_step(layers, packs, x, stack, cks, cvs, pos, tree.devices, sh.tp_step_packs)
    end.record()
    for dev in set(tree.devices):
        torch.cuda.synchronize(dev)
    r["step_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    r["step_device_ms"] = start.elapsed_time(end) / steps
    parts = [torch.randn((1, stack.hidden_size), generator=gen, device=DEV).to(dtype).to(d) for d in tree.devices]
    r["all_reduce_ms"] = time_ms(lambda: collectives.all_reduce([p.clone() for p in parts]), iters=100)
    r["clone_ms"] = time_ms(lambda: [p.clone() for p in parts], iters=100)
    return r


def tp_full_depth() -> dict:
    """(b) The full-depth 1.7B int8 model at tp = 4 and tp = 2, in bf16 and
    in f32, against the same trees unsharded: kernels 5 and 6 launched 28 x
    tp times a step each, kernel 3 never, kernel 1 once a frame; the step
    bars (``tp_step_trials``); the TP_FRAMES staged frames' share of codes
    equal to the unsharded model's, the first differing frame and its top-2
    margin (reported, not gated); ms/frame beside the unsharded model's,
    the step's time, one all-reduce's, peak memory per device."""
    cfg = config_for_variant("1.7B", "custom_voice")
    base = Qwen3TTS.from_random(cfg, seed=0, device=DEV)
    voc, card = base.vocoder_params, card_line()
    trees = {torch.bfloat16: (base.talker_params, base.cp_params)}
    trees[torch.float32] = _f32_trees(base)
    del base
    layers_n = cfg.talker.num_hidden_layers
    out = {}
    for dtype, (tparams, cparams) in trees.items():
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        ref = Qwen3TTS(cfg, tparams, cparams, voc, BenchTokenizer(), quantize_int8=True)
        ref_frames, ref_ms, ref_launches, ref_logits = _staged_frames(ref)
        for tp in (4, 2):
            torch.cuda.empty_cache()
            base_mb = {}
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
                base_mb[torch.device("cuda", i)] = torch.cuda.memory_allocated(i) / 2**20
            sh = Qwen3TTS(cfg, tparams, cparams, voc, BenchTokenizer(), quantize_int8=True).shard(_mesh(1, tp))
            check(sh.talker_step_pack is None and sh.tp_step_packs is not None and len(sh.tp_step_packs) == tp,
                  f"tp full depth {name} tp={tp}: packs")
            frames, ms, launches, _ = _staged_frames(sh)
            counts = _collective_counts()
            steps = len(frames)
            peaks = {str(d): round(torch.cuda.max_memory_allocated(d) / 2**20 - base_mb[d])
                     for d in sorted(set(sh.mesh.replica(0)), key=str)}
            equal = frames.shape == ref_frames.shape
            share = float((frames == ref_frames).mean()) if equal else 0.0
            differ = np.flatnonzero(~(frames == ref_frames).all(axis=1)) if equal else np.array([0])
            first = f"frame {int(differ[0])} (top-2 margin of the unsharded run's logits " \
                    f"{_top2_margin(ref_logits[int(differ[0])]):.4e})" if len(differ) else "none"
            r = tp_step_trials(sh, ref, dtype, torch.Generator(device=DEV).manual_seed(70 + tp))
            f32_bar = max(F32_STEP_TOL, TP_F32_SPREAD_FACTOR * r["spread"])
            bars = (HIDDEN_TOL, ROW_TOL) if dtype == torch.bfloat16 else (f32_bar, f32_bar)
            phase("tp", f"(b) {card}: full-depth 1.7B int8 {name} tp={tp}, {steps} staged frames: {ms:.3f} ms/frame "
                  f"against {ref_ms:.3f} unsharded; share of codes equal to the unsharded model's {share:.4f}, first "
                  f"differing {first} (reported, not gated); launches {launches} (kernels 5 and 6 want "
                  f"{layers_n * tp * steps} each); collectives {counts}; peak allocated MiB by device above what was "
                  f"allocated before the model was built (its int8 quantization and shards included) {peaks}")
            target = "the same route on the plain versions" if dtype == torch.bfloat16 else \
                f"the unsharded kernel-3 step (codec-head argmax {r['argmax']}/{r['trials']}, flips at (pos, top-2 " \
                f"margin, the logits' move under the nudge) {[(p, f'{m:.3e}', f'{d:.3e}') for p, m, d in r['flips']]}; " \
                f"its own spread under a 2^-22 change of the int8 scales {r['spread']:.4e})"
            phase("tp", f"(b) {name} tp={tp}: {r['trials']} steps at pos near {TP_ROWS} rows, each kernel-5 / 6 "
                  f"call against its plain version: attention {r['sublayer']['attention']:.4e}, mlp "
                  f"{r['sublayer']['mlp']:.4e} ({'bar' if dtype == torch.bfloat16 else 'reported; phase 7 bar'} "
                  f"{STEP_TOL[dtype]}); the step against {target}: hidden "
                  f"max|err|/max {r['h_err']:.4e} (bar {bars[0]}), written rows {r['row_err']:.4e} (bar {bars[1]}); "
                  f"the step {r['step_ms']:.4f} ms by host clock ({r['step_device_ms']:.4f} ms on the first card by "
                  f"CUDA events) "
                  f"over 20 steps, one all-reduce of the parts {r['all_reduce_ms']:.4f} ms ({r['clone_ms']:.4f} "
                  f"of it the parts' copies)")
            check(launches["fused_attention_step"] == launches["fused_mlp_step"] == layers_n * tp * steps,
                  f"tp {name} tp={tp}: kernels 5 / 6 launched {launches}, want {layers_n * tp * steps} each")
            check(launches["talker_step"] == 0 and launches["cp_frame"] == steps, f"tp {name} tp={tp}: {launches}")
            # In f32 a call's own bf16 input flips reach past phase 7's bar at these widths (reported).
            check(dtype == torch.float32 or max(r["sublayer"].values()) <= STEP_TOL[dtype],
                  f"tp {name} tp={tp}: a kernel-5 / 6 call {r['sublayer']} from its plain version "
                  f"(bar {STEP_TOL[dtype]})")
            check(r["h_err"] <= bars[0] and r["row_err"] <= bars[1], f"tp {name} tp={tp}: step error "
                  f"{r['h_err']:.4e} / {r['row_err']:.4e} > {bars}")
            check(dtype == torch.bfloat16 or r["unexplained"] == 0,
                  f"tp f32 tp={tp}: codec-head argmax {r['argmax']}/{r['trials']}, {r['unexplained']} flips past the "
                  f"unsharded step's own sensitivity: {r['flips']}")
            out[f"{name}_tp{tp}"] = {"ms_per_frame": ms, "unsharded_ms_per_frame": ref_ms, "share_equal": share,
                                     "launches": launches["fused_attention_step"], **{k: r[k] for k in (
                                         "step_ms", "step_device_ms", "all_reduce_ms")}}
            del sh
        del ref
    torch.cuda.empty_cache()
    _row("int8_matmul")["tp_dp_batch"] = tp_dp_batch(cfg, trees[torch.bfloat16], voc)
    return out


TP_DP_FRAMES = 16  # part (d): the dp = 2 batch's frames (the eager batched loop: ~0.2 s a frame at B = 8)


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class _OpRecorder(TorchDispatchMode):
    """While ``on``, each aten op's tensor inputs and outputs on the card
    (``DEV``'s device type), cloned, as events in call order; views,
    in-place ops and fresh allocations are skipped (their contents are no
    result of their own)."""

    def __init__(self, events: list):
        super().__init__()
        self.events, self.on, self.where = events, False, ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.on and not func.is_view and not name.endswith("_") and not name.startswith(("empty", "new_empty")):
            def here(tree):
                return [t.clone() for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.device.type == DEV.type]
            outs = here(out)
            if outs:
                self.events.append({"op": str(func), "where": self.where, "seq": len(self.events),
                                    "in": here((args, kwargs)), "out": outs})
        return out


def replica0_records(m: Qwen3TTS, make_group) -> list:
    """Every op of replica 0's talker prefill and of its first frame, in
    order (``_OpRecorder`` events; kernel 4, the attention and the sampling
    as events of their own too, with their inputs and outputs), while
    ``make_group(m)`` prefills a CustomVoice batch group and
    ``m._run_batch_loops`` runs its first frame."""
    events: list = []
    rec = _OpRecorder(events)
    prefill_fn, frame_fn, layer_fn, rows_fn, mm = (gbatch.prefill_custom_voice_batch, core.batch_frame,
                                                   nn.layer_params_at, prefill.custom_voice_rows, quant._int8_mm_core)
    attention_fn, sample_fn = nn.gqa_attention, sampling.sample_rows
    state = {"prefill": 0, "frame": 0, "layer": 0, "stream": 0}

    def window(kind: str, fn):
        def run(*args, **kwargs):
            state[kind] += 1
            if state[kind] > 1:
                return fn(*args, **kwargs)
            rec.on, state["layer"], rec.where = True, 0, kind
            try:
                return fn(*args, **kwargs)
            finally:
                rec.on = False
        return run

    def layer(*args, **kwargs):  # a layer's weights are taken as the layer starts, on every path
        if rec.on:
            rec.where = f"{rec.where.split(' ')[0]} layer {state['layer']}"
            state["layer"] += 1
        return layer_fn(*args, **kwargs)

    def rows(*args, **kwargs):
        if not rec.on:
            return rows_fn(*args, **kwargs)
        rec.where, state["stream"] = f"prefill rows of stream {state['stream']}", state["stream"] + 1
        try:
            return rows_fn(*args, **kwargs)
        finally:
            rec.where = "prefill"

    def whole(name: str, fn, inside: bool = True):  # inside: record the ops it makes too
        def run(*args):
            on = rec.on
            rec.on = on and inside
            out = fn(*args)
            rec.on = on
            if rec.on:
                rec.on = False
                ins = args[:1] if name == "kernel4" else args  # not the weights
                events.append({"op": name, "where": rec.where, "seq": len(events),
                               "in": [a.clone() for a in ins if isinstance(a, torch.Tensor)], "out": [out.clone()]})
                if name == "kernel4":
                    events[-1]["mkn"] = (args[0].shape[0], args[0].shape[1], args[1].shape[1])
                rec.on = True
            return out
        return run

    gbatch.prefill_custom_voice_batch, core.batch_frame = window("prefill", prefill_fn), window("frame", frame_fn)
    nn.layer_params_at, prefill.custom_voice_rows, quant._int8_mm_core = layer, rows, whole("kernel4", mm)
    # An einsum lays a lone stream's operands out otherwise: the attention is compared whole.
    nn.gqa_attention, sampling.sample_rows = whole("gqa_attention", attention_fn, False), whole("sample", sample_fn)
    try:
        with rec:
            g = make_group(m)
            m._run_batch_loops(g, g.frame_limits, until=lambda: state["frame"] > 0)
    finally:
        gbatch.prefill_custom_voice_batch, core.batch_frame = prefill_fn, frame_fn
        nn.layer_params_at, prefill.custom_voice_rows, quant._int8_mm_core = layer_fn, rows_fn, mm
        nn.gqa_attention, sampling.sample_rows = attention_fn, sample_fn
    _sync_all()
    return events


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))
    return torch.equal(a, b)


def _comparable(small: torch.Tensor, big: torch.Tensor) -> bool:
    return small.ndim == big.ndim and all(s <= b for s, b in zip(small.shape, big.shape))


def _rows_equal(small: torch.Tensor, big: torch.Tensor) -> bool:
    """``small`` (a run of fewer streams) bit-equal to the leading slice of
    every axis of ``big``: a batch's streams lead each axis they fold into,
    so the first streams' rows of the larger run are that slice."""
    return _comparable(small, big) and _bits_equal(small, big[tuple(slice(0, s) for s in small.shape)])


def _by_where(events: list) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e["where"], []).append(e)
    return out


def _key(e: dict) -> tuple:
    return e["op"], tuple((x.ndim, x.dtype) for x in e["out"])


def _plan_of(m: int, k: int, n: int, sms: int) -> tuple | None:
    """Kernel 4's plan (tier, bm, bk, splits, cluster), None where its gate sends the shape to the plain form."""
    return tuple(quant.int8_matmul_plan(m, k, n, sms)) if quant.int8_matmul_route(
        torch.empty((m, k), device="meta"), torch.empty((k, n), device="meta")) == "kernel" else None


def first_divergence(small: list, big: list, sms: int) -> dict:
    """Replica 0's records of a run of fewer streams (``small``) against a
    larger run's (``big``), within each stretch of the run (``where``: the
    prompt rows of stream i, the prefill, a layer; the larger run's
    rows of its other streams have no counterpart), the events paired by
    ``difflib`` on (op, output ranks and dtypes), so that a layout copy
    one run makes and the other does not (an einsum's operand at B = 1)
    pairs with nothing: the first op whose output rows differ in bits
    (``first``), and every op whose input rows were equal and whose output
    rows were not (``guilty``: a sum whose order follows the rows), by op
    and shapes, kernel 4 with both runs' plans; ``unpaired`` counts the
    events of each run left without a partner."""
    first, guilty = None, {}
    stretches = _by_where(big)
    pairs, unpaired = [], [0, 0]
    for where, events in _by_where(small).items():
        others = stretches.get(where, [])
        blocks = difflib.SequenceMatcher(None, [_key(e) for e in events], [_key(e) for e in others],
                                         autojunk=False).get_matching_blocks()
        paired = sum(blk.size for blk in blocks)
        unpaired[0] += len(events) - paired
        unpaired[1] += len(others) - paired
        for blk in blocks:
            for s, b in zip(events[blk.a:blk.a + blk.size], others[blk.b:blk.b + blk.size]):
                if len(s["out"]) == len(b["out"]) and all(_comparable(x, y) for x, y in zip(s["out"], b["out"])):
                    pairs.append((s, b))
                else:  # a layout the runs lay out otherwise (an operand squeezed at B = 1)
                    unpaired[0] += 1
                    unpaired[1] += 1
    pairs.sort(key=lambda p: p[0]["seq"])
    for s, b in pairs:
        if all(_rows_equal(x, y) for x, y in zip(s["out"], b["out"])):
            continue
        inputs_equal = len(s["in"]) == len(b["in"]) and all(_rows_equal(x, y) for x, y in zip(s["in"], b["in"]))
        entry = {"index": s["seq"], "op": s["op"], "where": s["where"], "inputs_equal": inputs_equal,
                 "shapes": [tuple(x.shape) for x in s["out"]], "big_shapes": [tuple(x.shape) for x in b["out"]]}
        if s["op"] == "kernel4":
            entry["plans"] = [_plan_of(*e["mkn"], sms) for e in (s, b)]
            entry["mkn"] = [s["mkn"], b["mkn"]]
        first = first or entry
        if inputs_equal:
            key = (s["op"], str(entry.get("mkn", entry["shapes"])))
            guilty.setdefault(key, {**entry, "count": 0})["count"] += 1
    return {"events": (len(small), len(big)), "first": first, "guilty": guilty, "unpaired": unpaired}


def divergence_line(label: str, d: dict) -> str:
    """``first_divergence``'s result as a phase line."""
    f = d["first"]
    first = "none" if f is None else (
        f"event {f['index']} {f['op']} in {f['where']}, output {f['shapes']} against {f['big_shapes']}, its input "
        f"rows equal {f['inputs_equal']}"
        + (f", (m, K, N) {f['mkn']}, plans (tier, bm, bk, splits) {f['plans']}" if "plans" in f else ""))
    guilty = "; ".join(f"{g['op']} {g.get('mkn', g['shapes'])} x{g['count']}"
                       + (f" plans {g['plans']}" if "plans" in g else "") + f" (first in {g['where']})"
                       for g in d["guilty"].values()) or "none"
    return (f"{label}: {d['events'][0]} / {d['events'][1]} events of replica 0's prefill and first frame "
            f"({d['unpaired'][0]} / {d['unpaired'][1]} unpaired); first_divergence: {first}; ops whose input rows were equal and output rows were not: {guilty}")


def tp_dp_batch(cfg: ModelConfig, trees: tuple, voc: dict) -> dict:
    """(d) The full-depth 1.7B int8 model in bf16 at dp = 2 x tp = 1 on the
    cards there are (both replicas on cuda:0 with one card): a batch of
    BATCH streams (BATCH / 2 a replica) for TP_DP_FRAMES frames forced.
    One run with ``core.batch_frame`` recorded, ``TransferAudit`` on and
    ``sync_free_loops``: the rounds alternate between the replicas, kernel
    4 launches in every replica's frames and only on its first device, the
    loop's host reads stay within ``loop_read_bound``, and nothing
    synchronises between two looks; kernel 4 at replica 0's talker
    projections and codec head (its rows: BATCH / 2) on the run's own
    inputs, as phase ``kernel4-batch`` (``kernel4_batch_shapes``). Then, each with the launch counts set
    to 0 just before it: the lock-step loop timed, the same replicas run one
    after another (each alone through the driver, as the loops ran before
    the lock-step driver) timed, and the unsharded B = BATCH batch timed,
    all in this process: ms a frame of each; the lock-step frames bit-equal
    to the one-after-another frames and to the unsharded batch's, every
    code; kernels 1 and 3 never, no call the gate sent to kernel 4's plain
    form. First, every op of replica 0's prefill and first frame
    (``replica0_records``) of the dp = 2 run and of stream 0 alone at B = 1,
    each against the same rows of the unsharded batch's (``first_divergence``):
    no op's output rows may differ in bits."""
    card = card_line()
    opts = replace(st.batch_options(), max_length=TP_DP_FRAMES, min_new_tokens=TP_DP_FRAMES)
    texts = list(st.BATCH_TEXTS[:BATCH])

    def build(mesh=None) -> Qwen3TTS:
        m = Qwen3TTS(cfg, *trees, voc, st.WordTokenizer(), quantize_int8=True)
        return m.shard(mesh) if mesh is not None else m

    def group(m: Qwen3TTS, b: int = BATCH, options: SynthesisOptions = opts):
        return m._prepare_batch_group("basic", texts[:b], ["ryan"] * b, ["english"] * b, [None] * b,
                                      m._normalize_options(options), [42 + i for i in range(b)])

    def timed(g, run) -> tuple:
        _sync_all()
        _reset_counts()
        quant.int8_matmul.gated = 0
        t0 = time.perf_counter()
        run(g, g.frame_limits)
        _sync_all()
        ms = (time.perf_counter() - t0) * 1e3 / TP_DP_FRAMES
        launches = {**_counts(), "gated": quant.int8_matmul.gated}
        return np.concatenate([p.state.frames.cpu().numpy() for p in g.shards]), ms, launches

    ref = build()
    ref_frames, ref_ms, ref_launches = timed(group(ref), ref._run_batch_loops)
    # The records: phase batch's options (its caches), one frame.
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    cells = st.batch_options()
    whole = replica0_records(ref, lambda m: group(m, BATCH, cells))
    parts = {b: first_divergence(replica0_records(ref, lambda m: group(m, b, cells)), whole, sms) for b in (1, 4)}
    del ref
    sh = build(_mesh(2, 1))
    split = first_divergence(replica0_records(sh, lambda m: group(m, BATCH, cells)), whole, sms)
    del whole
    for b, d in parts.items():
        phase("tp", divergence_line(f"(d) {card}: streams 0-{b - 1} at B={b} against the unsharded B={BATCH} batch",
                                    d))
    phase("tp", divergence_line(f"(d) {card}: replica 0 of dp=2 ({BATCH // 2} streams) against the unsharded "
                                f"B={BATCH} batch", split))
    devs = [str(sh.mesh.first(r)) for r in range(2)]
    g = group(sh)
    replica = {id(p.state): r for r, p in enumerate(g.shards)}
    order, k4, k4_devs, current, inputs = [], [0, 0], [set(), set()], [None], {}
    talker_shapes = {*TALKER_PROJ_SHAPES, (cfg.talker.hidden_size, cfg.talker.codec_vocab_size)}
    frame, mm = core.batch_frame, quant._int8_mm_core

    def recorded(run):
        r = current[0] = replica[id(run.state)]
        order.append((r, run.state.steps))
        before = quant.int8_matmul.launches
        frame(run)
        k4[r] += quant.int8_matmul.launches - before
        current[0] = None

    def seen(x2, q8, scale):
        if current[0] is not None and x2.is_cuda and quant.int8_matmul_route(x2, q8) == "kernel":
            k4_devs[current[0]].add(str(x2.device))
            if current[0] == 0 and (x2.shape[1], q8.shape[1]) in talker_shapes:
                inputs.setdefault((x2.shape[0], x2.shape[1], q8.shape[1]), (x2.clone(), q8, scale))
        return mm(x2, q8, scale)

    core.batch_frame, quant._int8_mm_core = recorded, seen
    error, reads = None, -1
    try:
        with sync_free_loops():
            _, reads = count_host_transfers(sh._run_batch_loops, g, g.frame_limits)
    except RuntimeError as e:  # the sync debug mode's error
        error = str(e).splitlines()[0]
    finally:
        core.batch_frame, quant._int8_mm_core = frame, mm
    shapes = kernel4_batch_shapes(inputs)  # a replica's talker projections and codec head at its rows
    lock_frames, lock_ms, launches = timed(group(sh), sh._run_batch_loops)

    def one_after_another(g, limits):
        for share in sh._replica_loops(g, limits):
            core.generate_frames_replicas(cfg.talker, cfg.code_predictor, g.scfg, [share], sh.mesh)

    seq_frames, seq_ms, seq_launches = timed(group(sh), one_after_another)
    del sh
    torch.cuda.empty_cache()
    want_order = [(r, step) for step in range(TP_DP_FRAMES) for r in range(2)]
    bound_reads = loop_read_bound(TP_DP_FRAMES)
    share = float((lock_frames == ref_frames).mean())
    phase("tp", f"(d) {card}: full-depth 1.7B int8 bf16, dp=2 x tp=1 on {devs}, B={BATCH} ({BATCH // 2} a replica), "
          f"{TP_DP_FRAMES} frames: round order {'alternates' if order == want_order else order} "
          f"({len(order)} replica frames); kernel 4 launches in each replica's frames {k4} on devices "
          f"{[sorted(d) for d in k4_devs]}; host reads of the lock-step loop {reads} (bound {bound_reads}); "
          f"under set_sync_debug_mode('error') between looks: "
          f"{'no synchronising call' if error is None else 'RAISED: ' + error}")
    phase("tp", f"(d) {card}: ms/frame lock-step {lock_ms:.3f}, the replicas one after another {seq_ms:.3f}, "
          f"unsharded B={BATCH} {ref_ms:.3f}; lock-step frames bit-equal to one after another "
          f"{bool((lock_frames == seq_frames).all())}, share of codes equal to the unsharded batch {share:.4f} "
          f"(bar 1.0000); launches lock-step {launches}, one after another {seq_launches}, unsharded {ref_launches}")
    check(order == want_order, f"tp dp batch: the rounds' order {order[:8]}..., want {want_order[:8]}...")
    check(all(n > 0 for n in k4) and [sorted(d) for d in k4_devs] == [[d] for d in devs],
          f"tp dp batch: kernel 4 launches a replica {k4} on {k4_devs}, want each nonzero on {devs}")
    check(error is None, f"tp dp batch: a synchronising call in the lock-step loop: {error}")
    check(0 <= reads <= bound_reads, f"tp dp batch: {reads} host reads, bound {bound_reads}")
    check(bool((lock_frames == seq_frames).all()), "tp dp batch: lock-step frames differ from one after another")
    check(share == 1.0, f"tp dp batch: {share:.4f} of codes equal to the unsharded batch's")
    for name, d in (("B=1", parts[1]), ("B=4", parts[4]), ("replica 0 of dp=2", split)):
        check(d["first"] is None, f"tp dp batch: {name} departs from the unsharded B={BATCH} batch: {d['first']}")
    for name, n in (("lock-step", launches), ("one after another", seq_launches), ("unsharded", ref_launches)):
        check(n["cp_frame"] == n["talker_step"] == 0 and n["int8_matmul"] > 0 and n["gated"] == 0,
              f"tp dp batch {name}: launches {n}")
    return {"ms_per_frame": lock_ms, "one_after_another_ms_per_frame": seq_ms, "unsharded_ms_per_frame": ref_ms,
            "kernel4_launches_by_replica": k4, "host_reads": reads, "share_equal_unsharded": share,
            "first_divergence": {"b1": parts[1]["first"], "b4": parts[4]["first"], "dp2": split["first"]},
            "kernel4_replica_shapes": shapes}


def tp_phase() -> None:
    """Phase ``tp`` (see the module docstring, item 13): the full-depth int8
    runs; the fixtures ran in phase ``utterance``'s checkpoint."""
    t0 = time.perf_counter()
    runs = tp_full_depth()
    for name in ("fused_attention_step", "fused_mlp_step"):
        _row(name)["tp_main_path"] = runs
    phase("tp", f"full-depth wall time {time.perf_counter() - t0:.1f} s")



def utterance_phase(encoders: tuple) -> None:
    """Phase ``utterance`` (see the module docstring, item 12)."""
    t_phase = time.perf_counter()
    fixture = ckpt_fixture.load_utterance()
    workdir = tempfile.TemporaryDirectory(prefix="qwen3_tts_utterance_")
    d = workdir.name
    t0 = time.perf_counter()
    ckpt_fixture.write_utterance_checkpoint(d)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Qwen3TTS.from_pretrained(d, dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(model.cp_frame_pack is not None and model.talker_step_pack is not None,
          "utterance: the f32 model holds no kernel 1 / kernel 3 pack")
    n = ckpt_fixture.UTTERANCE_FRAMES
    for kind, temperature in (("greedy", 0.0), ("pcg", 0.9)):
        opts = SynthesisOptions(max_length=n, min_new_tokens=n, seed=42, temperature=temperature)
        _reset_counts()
        frames = model._custom_voice_session(ckpt_fixture.UTTERANCE_TEXT, "ryan", "english", opts).run_to_completion()
        audio = model.decode_codes(frames).samples
        launches = _counts()
        want, want_audio = fixture[f"frames_{kind}"], fixture[f"audio_{kind}"]
        equal = frames.shape == want.shape and bool((frames == want).all())
        share = float((frames == want).mean()) if frames.shape == want.shape else 0.0
        scale = float(np.abs(want_audio).max())
        err = float(np.abs(audio - want_audio).max()) if audio.shape == want_audio.shape else float("inf")
        phase("utterance", f"seeded 1.7B-width checkpoint (2 talker layers) from disk in f32 (written "
              f"{t_write:.1f} s, from_pretrained {t_load:.1f} s), {kind}, {n} frames: token-exact to the JAX "
              f"fixture {equal} (share of codes equal {share:.4f}); least top-2 margins of the fixture: talker "
              f"{float(fixture['talker_margin']):.3e}, code predictor {float(fixture['cp_margin']):.3e}; "
              f"max|audio - JAX| {err:.3e} = {err / scale:.3e} of max|audio| {scale:.4f} (bar 1e-5); launches "
              f"{launches}")
        check(equal, f"utterance {kind}: frames differ from the JAX fixture")
        check(err <= 1e-5 * scale, f"utterance {kind}: audio {err / scale:.3e} of max|audio| from the JAX fixture")
        check(launches["cp_frame"] == launches["talker_step"] == n and launches["residual_unit"] == 9,
              f"utterance {kind}: launches {launches}")
    batch_fixture(model)
    per_stream_positions(model, encoders)
    phase("utterance", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    with workdir:
        tp_utterance(d, fixture)
    tp_batch(model)
    del model
    torch.cuda.empty_cache()
    phase("tp", f"fixtures' wall time {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
    phase("card", "name, power limit:")
    kind = torch.cuda.get_device_name(0)
    print_card()
    t0 = time.perf_counter()
    path = build.build()
    phase("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")
    kernel1()
    kernel2()
    KERNEL_ROWS.append(kernel2_stream())
    vocoder_fixture_check()
    encoders = encoders_check()
    kernel3()
    kernel4()
    kernels5_6()
    kernel7()
    kernel7_wide_head()
    per_step_path()
    _row("int8_matmul")["jacobi_shapes"] = jacobi_phase()["kernel4"]
    small_model_agrees()
    for case in SMALL_INT8:
        small_int8_agrees(*case)
    launches = main_path(encoders)
    ckpt_phase()
    utterance_phase(encoders)
    tp_phase()
    for row in KERNEL_ROWS:
        row["launches"] = launches[row["path"]][row["name"].removesuffix("_int8")]
    check(len({row["replaces"] for row in KERNEL_ROWS}) == 8,
          "the kernels line must list the seven TPU kernels and kernel 2's stream entry")
    phase("done", f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": KERNEL_ROWS}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
