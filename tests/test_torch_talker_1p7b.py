"""Kernel 3's reference at full width: the 1.7B talker's decode step, the
JAX package and the port, on the CPU in f32.

Seeded numpy weights at the 1.7B talker's widths, cut to 2 layers
(``qwen3_tts_tpu_torch.talker_fixture``), go to both packages. The JAX
package's ``talker.decode_step`` (its XLA layer scan: the unfused tree
takes no Pallas kernel) runs 4 decode steps on a seeded 16-row cache
prefix; their codec-head argmaxes must equal the committed fixture. The
port's decode step on the fused tree (``talker.decode_step`` ->
``stream_plane_mode`` -> ``fused_layer.talker_step``, which runs
``talker_step_plain`` on a CPU tensor) must give the same argmaxes, its
normed hidden states within 1e-4 of the JAX package's (relative to their
largest value: f32 sums in another order, over 2 layers), and the same
cache rows within 1e-4. The fixture also holds each step's top-2 logit gap,
so that a near-tie flip can be told from a fault; ``chip_smoke.py`` holds
kernel 3 in f32 to the same argmaxes on the card. ~15 s of CPU.

    JAX_PLATFORMS=cpu python tests/test_torch_talker_1p7b.py   # rewrites the fixture
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu.models import talker as jtalker  # noqa: E402
from qwen3_tts_tpu.models.config import TalkerConfig as JTalkerConfig  # noqa: E402
from qwen3_tts_tpu.ops import nn as jnn  # noqa: E402
from qwen3_tts_tpu_torch import talker_fixture  # noqa: E402
from qwen3_tts_tpu_torch.models import talker as ttalker  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as TW  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer as tfl  # noqa: E402
from qwen3_tts_tpu_torch.ops import nn as tnn  # noqa: E402

# Gaps below this (f32 logits of scale ~0.6) could flip under another
# summation order; the fixture's seed has none.
MIN_GAP = 1e-3
TOL = 1e-4


def jax_steps(params: dict, cfg) -> tuple[list, list, np.ndarray, list, tuple]:
    """The JAX package's steps: argmaxes, top-2 gaps, normed hidden states
    [STEPS, H] and the final cache (k, v)."""
    jcfg = JTalkerConfig(**{f: getattr(cfg, f) for f in JTalkerConfig.__dataclass_fields__})
    jp = jax.tree.map(jnp.asarray, params)
    k0, v0, xs = talker_fixture.numpy_inputs(cfg)
    cache = jnn.KVCache(jnp.asarray(k0), jnp.asarray(v0))
    codes, gaps, hidden = [], [], []
    for i, x in enumerate(xs):
        h, logits, cache = jtalker.decode_step(jp, jcfg, jnp.asarray(x), jnp.int32(talker_fixture.START + i), cache)
        lg = np.asarray(logits[0])
        top2 = np.sort(lg)[-2:]
        codes.append(int(np.argmax(lg)))
        gaps.append(float(top2[1] - top2[0]))
        hidden.append(np.asarray(h).reshape(-1))
    return codes, gaps, np.stack(hidden), (np.asarray(cache.k), np.asarray(cache.v))


def port_steps(params: dict, cfg) -> tuple[list, np.ndarray, tuple]:
    """The port's steps on the fused tree, on the CPU: argmaxes, normed
    hidden states and the final cache."""
    fused = TW.fuse_model_params(TW.from_numpy_tree(params, "cpu"))
    k0, v0, xs = talker_fixture.numpy_inputs(cfg)
    cache = tnn.KVCache(torch.from_numpy(k0), torch.from_numpy(v0))
    assert ttalker.stream_plane_mode(fused, cfg, cache)
    before = tfl.talker_step.launches
    codes, hidden = [], []
    for i, x in enumerate(xs):
        h, logits = ttalker.decode_step(fused, cfg, torch.from_numpy(x), talker_fixture.START + i, cache)
        codes.append(int(torch.argmax(logits[0])))
        hidden.append(h.reshape(-1).numpy())
    assert tfl.talker_step.launches == before  # CPU tensors take the plain version
    return codes, np.stack(hidden), (cache.k.numpy(), cache.v.numpy())


@pytest.fixture(scope="module")
def steps():
    torch.set_num_threads(4)
    cfg = talker_fixture.config()
    params = talker_fixture.numpy_params(cfg)
    return cfg, jax_steps(params, cfg), port_steps(params, cfg)


def test_jax_package_gives_the_fixture(steps):
    _, (codes, gaps, _, _), _ = steps
    fixture = talker_fixture.load()
    assert codes == fixture["codes"]
    assert min(fixture["top2_gap"]) >= MIN_GAP
    np.testing.assert_allclose(gaps, fixture["top2_gap"], rtol=0, atol=1e-5)


def test_port_plain_step_gives_the_fixture(steps):
    _, (_, _, jhidden, (jk, jv)), (codes, hidden, (k, v)) = steps
    assert codes == talker_fixture.load()["codes"]
    scale = np.abs(jhidden).max()
    np.testing.assert_allclose(hidden, jhidden, rtol=0, atol=TOL * scale)
    for got, want in ((k, jk), (v, jv)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    # Only the decoded rows changed.
    k0, v0, _ = talker_fixture.numpy_inputs(talker_fixture.config())
    rows = list(range(talker_fixture.START, talker_fixture.START + talker_fixture.STEPS))
    others = [r for r in range(talker_fixture.ROWS) if r not in rows]
    assert np.array_equal(k[:, :, others], k0[:, :, others]) and np.array_equal(v[:, :, others], v0[:, :, others])


if __name__ == "__main__":
    cfg = talker_fixture.config()
    codes, gaps, _, _ = jax_steps(talker_fixture.numpy_params(cfg), cfg)
    assert min(gaps) >= MIN_GAP, f"a near-tied step (top-2 gap {min(gaps):.3e}): pick another seed"
    talker_fixture.FIXTURE.write_text(json.dumps({
        "source": "qwen3_tts_tpu.models.talker.decode_step, f32, XLA layer scan on the CPU",
        "seed": talker_fixture.SEED, "layers": talker_fixture.LAYERS, "rows": talker_fixture.ROWS,
        "start": talker_fixture.START, "steps": talker_fixture.STEPS,
        "codes": codes, "top2_gap": [round(g, 6) for g in gaps],
    }, indent=1) + "\n")
    print(f"wrote {talker_fixture.FIXTURE}: codes {codes}, min top-2 gap {min(gaps):.3e}")
