"""The port's quant report (``validation/quant_report.py``) against the JAX
side's ``scripts/quant_report.py`` on the same model (CPU, f32).

``tests/test_pipeline.tiny_model()`` and its weight-only int8 counterpart
(``quantize_int8=True`` on the same trees) in both packages, the port's
built from the JAX trees (``Qwen3TTS.from_numpy``). The JAX int8 model
runs without its stream packs, so that both packages round where the
port's plain versions do (``tests/test_torch_pipeline.py``), under
``pallas_dequant_scope(False)`` (the JAX batched programs' scope): its code
predictor takes the layer scan, whose int8 products round as the port's
plain frame does and, under w8a8, go through the w8a8 matmul as the
port's w8a8 drift does.

* per-projection weight SNR of the talker and the code predictor: every
  layer's within 1e-4 dB, and the reports (rounded) equal;
* logit drift, weight-only and w8a8, over the same 4 steps: KL within
  1e-6, both flip rates equal;
* the promote decision equal, and the port's ``main`` writes the whole
  report (``--variant tiny``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.validation import quant_report as TQ
from scripts import quant_report as JQ
from test_pipeline import TINY_VOC
from test_torch_pipeline import models  # noqa: F401  (the JAX tiny model and the port's, plain f32)

torch.set_num_threads(1)

STEPS = 4


@pytest.fixture(scope="module")
def int8_models(models):  # noqa: F811
    jm, tm = models
    j8 = JQwen3TTS(jm.config, jm.talker_params, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                   vocoder_config=TINY_VOC, quantize_int8=True)
    j8.talker_params.pop("stream_pack")
    j8.cp_params.pop("stream_pack")
    np_trees = [jax.tree.map(np.asarray, t) for t in (jm.talker_params, jm.cp_params, jm.vocoder_params)]
    t8 = type(tm).from_numpy(tm.config, *np_trees, tm.tokenizer, vocoder_config=tm.vocoder_config, device="cpu",
                             quantize_int8=True)
    return jm, j8, tm, t8


@pytest.mark.parametrize("tree", ["talker_params", "cp_params"])
def test_weight_snr_matches_jax(int8_models, tree):
    jm, j8, tm, t8 = int8_models
    jplain = JW.fuse_model_params(getattr(jm, tree))["layers"]
    tp = getattr(tm, tree)
    tplain = (tp if "qkv_proj" in tp["layers"] else W.fuse_model_params(tp))["layers"]
    jq8, tq8 = getattr(j8, tree)["layers"], getattr(t8, tree)["layers"]
    keys = [k for k, v in jq8.items() if jq.is_quantized(v)]
    assert keys and sorted(keys) == sorted(k for k, v in tq8.items() if isinstance(v, dict))
    for key in keys:
        w, q8, scale = (np.asarray(a, np.float32) for a in (jplain[key], jq8[key]["q8"], jq8[key]["scale"]))
        for layer in range(w.shape[0]):
            want = JQ._snr_db(w[layer], q8[layer], scale[layer])
            got = TQ._snr_db(tplain[key][layer], tq8[key]["q8"][layer], tq8[key]["scale"][layer])
            assert abs(got - want) <= 1e-4, (tree, key, layer)
    assert TQ.weight_snr_report(tplain, tq8) == JQ.weight_snr_report(jplain, jq8)


@pytest.fixture(scope="module")
def drifts(int8_models):
    jm, j8, tm, t8 = int8_models
    out = {}
    for w8a8 in (False, True):
        with jq.pallas_dequant_scope(False):
            want = JQ.logit_drift_report(jm, j8, STEPS, w8a8=w8a8)
        out[w8a8] = want, TQ.logit_drift_report(tm, t8, STEPS, w8a8=w8a8)
    return out


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
def test_logit_drift_matches_jax(drifts, w8a8):
    want, got = drifts[w8a8]
    assert got["steps"] == want["steps"] == STEPS
    assert abs(got["mean_logit_kl"] - want["mean_logit_kl"]) <= 1e-6
    assert got["talker_argmax_flip_rate"] == want["talker_argmax_flip_rate"]
    assert got["cp_code_flip_rate"] == want["cp_code_flip_rate"]
    assert got["launches"] == {}  # the CPU runs the plain versions


def test_promote_decision_matches_jax(int8_models, drifts):
    jm, j8, tm, t8 = int8_models
    report = TQ.report(tm, t8, STEPS, "tiny")
    assert report["logit_drift"] == drifts[False][1] and report["logit_drift_w8a8"] == drifts[True][1]
    assert report["device"] == {"platform": "cpu", "card": "cpu"}
    c = JQ.PROMOTE_CRITERION
    assert TQ.PROMOTE_CRITERION == c
    snrs = [v["min_db"] for tree in ("talker_params", "cp_params")
            for v in JQ.weight_snr_report(JW.fuse_model_params(getattr(jm, tree))["layers"],
                                          getattr(j8, tree)["layers"]).values()]
    d = drifts[False][0]
    want = bool(snrs and min(snrs) >= c["min_weight_snr_db"] and d["mean_logit_kl"] <= c["max_mean_logit_kl"]
                and d["talker_argmax_flip_rate"] <= c["max_talker_flip_rate"]
                and d["cp_code_flip_rate"] <= c["max_cp_flip_rate"])
    assert report["promote_int8"] is want


def test_main_writes_the_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert TQ.main(["--variant", "tiny", "--steps", "2", "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert report["source"] == "synthetic:tiny" and isinstance(report["promote_int8"], bool)
    for sec in ("talker_weight_snr", "cp_weight_snr"):
        assert report[sec] and all(s["min_db"] > 35.0 for s in report[sec].values())
    for sec in ("logit_drift", "logit_drift_w8a8"):
        assert report[sec]["steps"] == 2 and report[sec]["mean_logit_kl"] >= 0.0


def test_main_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.main(["--variant", "tiny"])
