"""ICL voice cloning, the port against the JAX package (f32, CPU).

``tests/test_torch_voice_clone.py``'s tiny Base model with its encoders and
its ICL prompt (a 1.28 s reference: 16 frames of codes and the reference
text's ids) in both packages. ICL sessions, the text and the reference
codec rows overlaid (the default) and in sequential blocks
(``icl_sequential``), greedy and under seeded PCG sampling: token-exact
frames and, through ``run_to_audio`` (the reference's 16 frames fed to the
streaming vocoder before the first chunk), audio
within atol 1e-5 and 1e-4 of max|audio| of the JAX session's;
``synthesize_voice_clone`` gives the session's audio.
"""

import pytest
import torch

from test_torch_voice_clone import check_session, models, prompts  # noqa: F401  (module fixtures)

torch.set_num_threads(1)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])
@pytest.mark.parametrize("kind", ["icl", "icl_sequential"])
def test_icl_sessions_match_jax(models, prompts, kind, temperature):  # noqa: F811
    check_session(models, prompts, kind, temperature)
