"""Public names of the JAX package that the port lacked, against the JAX package (CPU).

* ``Qwen3TTS.create_voice_clone_prompt(..., pad_to_seconds=)``: the audio,
  resampled to 24 kHz first, is zero-padded to a whole number of
  ``pad_to_seconds`` units (at least one) before both encoders. A 2.6 s
  reference at 24 kHz and at 16 kHz with ``pad_to_seconds=1.0`` (3 s
  after padding; a 3 s reference would be a whole number of units, and
  the padding a no-op) gives the JAX package's x-vector within 1e-5 of
  max|x| and its ICL codes equal; ``pad_to_seconds=None`` is the unpadded
  prompt.
* ``generation.prefill.prefill_custom_voice``: the JAX alias's state on
  the tiny model.
* ``utils.device.auto_device()``: raises without a card (no CPU fallback);
  with ``torch.cuda`` reporting one card, it is ``cuda:0``.
* The multi-GPU serving names: ``parallel.sharding.make_mesh`` (a (dp, tp)
  mesh of the JAX package's shape), ``Qwen3TTS.shard`` (returns the model),
  ``Qwen3TTS.mesh`` (None until sharded, then the mesh) and
  ``from_pretrained``'s ``mesh`` keyword, each as the JAX package has it.
* The package's ``__all__`` and ``models.codec.__all__``: the JAX package's
  names as sets, each name bound; ``hub``: its constants equal, and
  ``download`` asks ``huggingface_hub.hf_hub_download`` for the JAX
  module's files in the same order and directories (the function
  replaced in both, so nothing reaches the network).
* The last names: ``generation.batch``'s five functions with the JAX
  parameters in order (``tests/test_torch_batch_module.py`` holds their
  results), ``code_predictor.embed_codes_for_group`` equal to the JAX
  gather, ``sharding.kv_cache_spec`` the JAX spec (and the port's
  ``batch_cache_spec``), ``tokenizer.DEFAULT_TOKENIZER_REPO`` the JAX
  constant, and ``SpeakerEncoder.from_random``, ``VectorQuantizer.random``
  and ``ResidualVectorQuantizer.random`` the same under one generator seed,
  other under another, in the JAX shapes (an ECAPA kernel in
  ``F.conv1d``'s layout), each usable. Then an AST walk of both packages:
  every public JAX name (module functions, classes and their methods,
  constants) has a counterpart of that name in the same module of the
  port, or stands in ``NOT_PORTED`` with its reason (ROADMAP "Not to
  port"). The same walk over ``scripts/`` (the JAX side's validation
  chain): each script has its counterpart in ``qwen3_tts_tpu_torch/
  validation/`` (``PORTED_SCRIPTS``), whose module has each of its public
  names or a reason in ``NOT_PORTED_SCRIPT_NAMES``, or stands in
  ``NOT_PORTED_SCRIPTS`` with its reason.
"""

import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio
from qwen3_tts_tpu.generation import prefill as jprefill
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import rng as jrng
from qwen3_tts_tpu.ops import sampling as jsampling
from qwen3_tts_tpu_torch import encoder_fixture
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio
from qwen3_tts_tpu_torch.audio.resample import resample_to_24k
from qwen3_tts_tpu_torch.generation import prefill as tprefill
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import sampling as tsampling
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS
from qwen3_tts_tpu_torch.utils import device as tdevice
from test_pipeline import TINY_TALKER
from test_torch_voice_clone import REF_TEXT, build_models

torch.set_num_threads(1)

SECONDS = 2.6


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.mark.parametrize("rate", [24000, 16000])
def test_pad_to_seconds_matches_jax(models, rate):
    jm, tm = models
    audio = encoder_fixture.reference_audio(rate, seed=5, seconds=SECONDS)
    jp = jm.create_voice_clone_prompt(JAudio(audio, rate), REF_TEXT, pad_to_seconds=1.0)
    tp = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT, pad_to_seconds=1.0)
    scale = np.abs(jp.speaker_embedding).max()
    np.testing.assert_allclose(tp.speaker_embedding, jp.speaker_embedding, rtol=0, atol=1e-5 * scale)
    assert tp.ref_codes.shape == jp.ref_codes.shape
    np.testing.assert_array_equal(tp.ref_codes, jp.ref_codes)
    assert tp.ref_text_ids == jp.ref_text_ids

    plain = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT)
    unpadded = tm.create_voice_clone_prompt(TAudio(audio, rate), REF_TEXT, pad_to_seconds=None)
    np.testing.assert_array_equal(unpadded.speaker_embedding, plain.speaker_embedding)
    np.testing.assert_array_equal(unpadded.ref_codes, plain.ref_codes)
    # The padded prompt is that of the 24 kHz audio zero-padded to 3 s by hand.
    at24 = resample_to_24k(TAudio(audio, rate)).samples if rate != 24000 else audio
    by_hand = np.zeros(3 * 24000, np.float32)
    by_hand[:len(at24)] = at24
    want = tm.create_voice_clone_prompt(TAudio(by_hand, 24000), REF_TEXT)
    np.testing.assert_array_equal(tp.speaker_embedding, want.speaker_embedding)
    np.testing.assert_array_equal(tp.ref_codes, want.ref_codes)
    assert plain.ref_codes.shape[0] < tp.ref_codes.shape[0]
    assert np.abs(plain.speaker_embedding - tp.speaker_embedding).max() > 0


def test_prefill_custom_voice_matches_jax(models):
    jm, tm = models
    max_new, rows = 8, 32
    ids = np.array([5, 9, 3, 7, 0, 0, 0, 0], np.int64)
    uniforms = jrng.pcg_uniform_sequence(42, max_new + 1)
    stack = tm.config.talker.layer_stack()
    jstate, jtrail, jlen, jpad = jprefill.prefill_custom_voice(
        jm.talker_params, jm.config.talker, jsampling.SamplingConfig(), jnp.asarray(ids, jnp.int32), jnp.int32(4),
        jnp.int32(3061), jnp.int32(2050), jnn.init_kv_cache(jm.config.talker.layer_stack(), 1, rows, jnp.float32),
        jnp.asarray(uniforms), max_new)
    tstate, ttrail, tlen, tpad = tprefill.prefill_custom_voice(
        tm.talker_params, tm.config.talker, tsampling.SamplingConfig(), torch.from_numpy(ids), 4, 3061, 2050,
        tnn.init_kv_cache(stack, 1, rows, torch.float32, torch.device("cpu")), torch.from_numpy(uniforms), max_new)
    assert int(tstate.token) == int(jstate.token)
    assert tstate.pos == int(jstate.pos) and tstate.frame_idx == int(jstate.frame_idx) == 0
    assert tlen == int(jlen)
    for got, want in ((tstate.last_hidden, jstate.last_hidden), (tstate.cache.k, jstate.cache.k),
                      (tstate.cache.v, jstate.cache.v), (tstate.penalty_mask, jstate.penalty_mask),
                      (ttrail, jtrail), (tpad, jpad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert tstate.last_hidden.shape == (1, 1, TINY_TALKER.hidden_size)


def test_auto_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.auto_device()
    assert tdevice.parse_device("cpu") == torch.device("cpu")


def test_auto_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.auto_device() == torch.device("cuda", 0)
    assert tdevice.parse_device("auto") == torch.device("cuda", 0)


def test_make_mesh_is_public():
    from qwen3_tts_tpu.parallel import sharding as jsharding
    from qwen3_tts_tpu_torch.parallel import sharding as tsharding

    assert tsharding.make_mesh(["cpu"] * 4, tp=2).shape == dict(jsharding.make_mesh(jax.devices()[:4], tp=2).shape)


def test_shard_returns_the_model(models):
    from qwen3_tts_tpu_torch.parallel import sharding as tsharding

    _, tm = models
    model = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                     vocoder_config=tm.vocoder_config)
    mesh = tsharding.make_mesh(["cpu"] * 2, tp=2)
    assert model.shard(mesh) is model and model.mesh is mesh


def test_mesh_attribute(models):
    jm, tm = models
    assert jm.mesh is None and tm.mesh is None


def test_from_pretrained_takes_a_mesh():
    want = inspect.signature(JP.Qwen3TTS.from_pretrained).parameters["mesh"]
    got = inspect.signature(Qwen3TTS.from_pretrained).parameters["mesh"]
    assert got.default is want.default is None and got.kind == want.kind


def test_package_all_matches_jax():
    import qwen3_tts_tpu
    import qwen3_tts_tpu_torch

    assert set(qwen3_tts_tpu_torch.__all__) == set(qwen3_tts_tpu.__all__)
    assert all(hasattr(qwen3_tts_tpu_torch, name) for name in qwen3_tts_tpu_torch.__all__)
    assert qwen3_tts_tpu_torch.CODEC_EOS_TOKEN_ID == qwen3_tts_tpu.CODEC_EOS_TOKEN_ID
    assert qwen3_tts_tpu_torch.SAMPLES_PER_FRAME == qwen3_tts_tpu.SAMPLES_PER_FRAME


def test_codec_all_matches_jax():
    from qwen3_tts_tpu.models import codec as jcodec
    from qwen3_tts_tpu_torch.models import codec as tcodec

    assert set(tcodec.__all__) == set(jcodec.__all__)
    assert all(hasattr(tcodec, name) for name in tcodec.__all__)


def test_hub_constants_match_jax():
    from qwen3_tts_tpu import hub as jhub
    from qwen3_tts_tpu_torch import hub as thub

    assert thub.MODEL_IDS == jhub.MODEL_IDS
    assert (thub.SPEECH_TOKENIZER_ID, thub.TEXT_TOKENIZER_ID) == (jhub.SPEECH_TOKENIZER_ID, jhub.TEXT_TOKENIZER_ID)
    assert inspect.signature(thub.download) == inspect.signature(jhub.download)


@pytest.mark.parametrize("tokenizer_json", [True, False], ids=["tokenizer_json", "vocab_merges"])
def test_hub_download_asks_for_the_jax_files(tmp_path, monkeypatch, tokenizer_json):
    """Both ``download``s against a stand-in ``hf_hub_download`` (the module
    is imported inside the function, so the stand-in is what it finds):
    the same (repo, file, revision, directory) requests, the same returned
    directory; without ``tokenizer.json`` both fall back to vocab + merges."""
    huggingface_hub = pytest.importorskip("huggingface_hub")
    from qwen3_tts_tpu import hub as jhub
    from qwen3_tts_tpu_torch import hub as thub

    def run(download, root):
        calls = []

        def fake(repo, fname, revision=None, local_dir=None):
            calls.append((repo, fname, revision, str(Path(local_dir).relative_to(root))))
            if fname == "tokenizer.json" and not tokenizer_json:
                raise FileNotFoundError(fname)
            return str(Path(local_dir) / fname)

        monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake)
        out = download("1.7b-customvoice", root, revision="r1")
        return calls, str(out.relative_to(root))

    want = run(jhub.download, tmp_path / "jax")
    got = run(thub.download, tmp_path / "port")
    assert got == want
    assert got[1] == "Qwen3-TTS-12Hz-1.7B-CustomVoice"
    assert [c[1] for c in got[0]][-1] == ("tokenizer.json" if tokenizer_json else "tokenizer_config.json")


BATCH_NAMES = ("prefill_custom_voice_batch", "prefill_voice_clone_batch", "prefill_voice_design_batch",
               "prefill_voice_clone_icl_batch", "generate_frames_batch")


@pytest.mark.parametrize("name", BATCH_NAMES)
def test_generation_batch_names_match_jax(name):
    from qwen3_tts_tpu.generation import batch as jbatch
    from qwen3_tts_tpu_torch.generation import batch as tbatch

    want = inspect.signature(getattr(jbatch, name)).parameters
    got = inspect.signature(getattr(tbatch, name)).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]


def test_embed_codes_for_group_matches_jax(models):
    from qwen3_tts_tpu.models import code_predictor as jcp
    from qwen3_tts_tpu_torch.models import code_predictor as tcp

    jm, tm = models
    codes = np.random.RandomState(2).randint(0, tm.config.code_predictor.vocab_size, 7)
    for group in (0, tm.config.code_predictor.num_acoustic - 1):
        want = np.asarray(jcp.embed_codes_for_group(jm.cp_params, group, jnp.asarray(codes, jnp.int32)))
        got = tcp.embed_codes_for_group(tm.cp_params, group, torch.from_numpy(codes))
        assert got.shape == want.shape == (1, 7, tm.cp_params["codec_embeddings"].shape[-1])
        np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_spec_matches_jax():
    from qwen3_tts_tpu.parallel import sharding as jsharding
    from qwen3_tts_tpu_torch.parallel import sharding as tsharding

    assert tuple(tsharding.kv_cache_spec()) == tuple(jsharding.kv_cache_spec()) == (None, "dp", None, "tp", None)
    assert tsharding.kv_cache_spec() == tsharding.batch_cache_spec()


def test_default_tokenizer_repo_matches_jax():
    from qwen3_tts_tpu import tokenizer as jtokenizer
    from qwen3_tts_tpu_torch import tokenizer as ttokenizer

    assert ttokenizer.DEFAULT_TOKENIZER_REPO == jtokenizer.DEFAULT_TOKENIZER_REPO


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_speaker_encoder_from_random():
    from qwen3_tts_tpu.models import speaker as jspeaker
    from qwen3_tts_tpu.models.config import SpeakerEncoderConfig as JConfig
    from qwen3_tts_tpu_torch.models.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.models.speaker import SpeakerEncoder
    from test_torch_voice_clone import SPEAKER

    cfg = SpeakerEncoderConfig(**SPEAKER)
    a, b, c = (SpeakerEncoder.from_random(torch.Generator().manual_seed(s), cfg, device="cpu") for s in (1, 1, 2))
    want = dict(_leaves(jspeaker.SpeakerEncoder.from_random(jax.random.PRNGKey(0), JConfig(**SPEAKER)).params))
    got, same, other = dict(_leaves(a.params)), dict(_leaves(b.params)), dict(_leaves(c.params))
    assert set(got) == set(want)
    for path, leaf in got.items():
        shape = tuple(want[path].shape)
        # An ECAPA kernel: the JAX package's [K, Cin, Cout], F.conv1d's [Cout, Cin, K].
        assert tuple(leaf.shape) == (shape[::-1] if path.endswith("/w") else shape), path
        assert torch.equal(leaf, same[path]), path
    assert any(not torch.equal(leaf, other[path]) for path, leaf in got.items())
    xvec = a.encode(np.sin(np.arange(24000, dtype=np.float32) * 0.05))
    assert xvec.shape == (cfg.enc_dim,) and np.isfinite(xvec).all() and np.abs(xvec).max() > 0


def test_quantizers_random():
    from qwen3_tts_tpu.models.codec import quantizer as jq
    from qwen3_tts_tpu_torch.models.codec import quantizer as tq

    def vq(seed):
        return tq.VectorQuantizer.random(torch.Generator().manual_seed(seed), 64, 8, scale=0.5, device="cpu")

    def rvq(seed):
        return tq.ResidualVectorQuantizer.random(torch.Generator().manual_seed(seed), 3, 64, 8, device="cpu")

    a = vq(4)
    assert a.codebook.shape == jq.VectorQuantizer.random(jax.random.PRNGKey(0), 64, 8, 0.5).codebook.shape
    assert torch.equal(a.codebook, vq(4).codebook) and not torch.equal(a.codebook, vq(5).codebook)
    assert abs(float(a.codebook.std()) - 0.5) < 0.1
    assert a.encode(a.codebook[None, [3, 9, 60]])[1].tolist() == [[3, 9, 60]]

    r = rvq(6)
    assert r.codebooks.shape == jq.ResidualVectorQuantizer.random(jax.random.PRNGKey(0), 3, 64, 8).codebooks.shape
    assert torch.equal(r.codebooks, rvq(6).codebooks) and not torch.equal(r.codebooks, rvq(7).codebooks)
    quantized, indices = r.encode(torch.randn((2, 5, 8), generator=torch.Generator().manual_seed(8)))
    assert quantized.shape == (2, 5, 8) and indices.shape == (2, 3, 5)


# The public JAX names that the port does not have, each with its reason
# (ROADMAP "Not to port"; the code predictor's specs: Queue 3).
NOT_PORTED = {
    "generation/core.py": {"generate_frames_jit": "an XLA program", "prefill_and_start": "an XLA program"},
    "models/codec/vocoder.py": {"decode_jit": "an XLA program", "decode_stream_chunk_jit": "an XLA program"},
    "utils/compile_cache.py": {"enable": "XLA's compilation cache"},
    "models/codec/blocks.py": {"CONV_DN": "XLA's convolution dimension numbers; F.conv1d has one layout"},
    "models/codec/encoder.py": {
        "forward_bucketed": "one XLA program a bucket; the port runs forward, which gives the same codes",
        "init_encoder_params": "the port builds the Mimi tree from numpy (encoder_fixture.mimi_numpy_params)"},
    "models/code_predictor.py": {"scan_slices": "pre-slices the inputs of lax.scan"},
    "ops/quant.py": {"pallas_dequant_scope": "chooses Pallas or XLA's dequant dot; the port has one int8 route",
                     "set_pallas_enabled": "the same choice, process-wide",
                     "pallas_allowed": "the same choice, read"},
    "ops/nn.py": {"decode_attention_flash": "unused, and slower than dense attention",
                  "DECODE_FLASH_BLOCK": "its block size"},
    "ops/fused_layer.py": {
        "make_stream_pack": "the TPU's [H, H] DMA tiles; the CUDA kernels read the canonical tree",
        "STREAM_NBUF": "a Pallas DMA depth", "CP_STREAM_NBUF": "a Pallas DMA depth",
        "TALKER_STREAM_NBUF": "a Pallas DMA depth", "CP_WRES_BUDGET": "a VMEM residency budget",
        "cp_resident_layers": "VMEM residency under that budget",
        "streamed_cp_frame": "kernel 1, here fused_layer.cp_frame",
        "streamed_talker_step": "kernel 3, here fused_layer.talker_step"},
    "parallel/sharding.py": {"code_predictor_specs": "the code predictor stays whole on each replica"},
}


def _public_names(root: Path) -> dict:
    """Each module's public top-level functions, classes (and their public
    methods, as ``Class.method``) and constants, by path under ``root``."""
    import ast

    out = {}
    for f in sorted(root.rglob("*.py")):
        names = set()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")}
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name) and not t.id.startswith("_")}
        out[str(f.relative_to(root))] = names
    return out


def test_every_jax_name_has_a_counterpart_or_a_reason():
    repo = Path(__file__).resolve().parent.parent
    jax_names, port_names = _public_names(repo / "qwen3_tts_tpu"), _public_names(repo / "qwen3_tts_tpu_torch")
    missing = {path: names - port_names.get(path, set()) for path, names in jax_names.items()}
    assert {path: names for path, names in missing.items() if names} == {
        path: set(reasons) for path, reasons in NOT_PORTED.items()}


# scripts/ (the JAX side's validation chain): each script's counterpart in
# qwen3_tts_tpu_torch/validation/, or the reason it has none.
PORTED_SCRIPTS = {
    "quality_check.py": "quality.py",
    "trace_report.py": "trace_report.py",
    "audit_host_syncs.py": "audit.py",
    "quant_report.py": "quant_report.py",
    "parity_matrix.py": "parity_matrix.py",
    "test_variants.py": "variants.py",
}
NOT_PORTED_SCRIPTS = {
    "__init__.py": "makes scripts/ a package",
    "warmup.py": "compiles the XLA programs ahead of time",
    "count_programs.py": "counts XLA programs and their instructions",
    "render_bench_docs.py": "renders the JAX side's docs",
    "torch_oracle.py": "the independent oracle, kept independent (the port copies none of it)",
    "dump_reference_values.py": "the oracle's golden dump, kept independent (validation parity --golden reads it)",
    "make_synthetic_ckpt.py": "ckpt_fixture.py takes its place (validation drill)",
    "transcribe.py": "imports neither package; the quality gate takes its callable as it is",
}
NOT_PORTED_SCRIPT_NAMES = {
    "audit_host_syncs.py": {"ROOT": "the JAX package's directory (the port's: audit.PACKAGE)"},
    "parity_matrix.py": {"flags": "XLA_FLAGS for a virtual CPU mesh"},
    "trace_report.py": {"load_xspaces": "reads a jax.profiler xplane (the port's trace is Chrome JSON: load_traces)"},
}


def test_every_script_has_a_counterpart_or_a_reason():
    repo = Path(__file__).resolve().parent.parent
    scripts = {f.name for f in (repo / "scripts").glob("*.py")}
    assert not set(PORTED_SCRIPTS) & set(NOT_PORTED_SCRIPTS)
    assert scripts == set(PORTED_SCRIPTS) | set(NOT_PORTED_SCRIPTS)
    script_names = _public_names(repo / "scripts")
    port_names = _public_names(repo / "qwen3_tts_tpu_torch" / "validation")
    missing = {script: script_names[script] - port_names[module] for script, module in PORTED_SCRIPTS.items()}
    assert {s: names for s, names in missing.items() if names} == {
        s: set(reasons) for s, reasons in NOT_PORTED_SCRIPT_NAMES.items()}
