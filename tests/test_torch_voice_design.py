"""Voice design, the port against the JAX package (f32, CPU).

``tests/test_torch_voice_clone.py``'s tiny model in both packages. A voice
described in words: the ChatML user turn around the description, its rows
in front of the 9 suffix rows (a 32-row instruct bucket, 41 prompt rows),
greedy and under seeded PCG sampling: token-exact frames and, through
``run_to_audio`` (``synthesize_voice_design``), audio within atol 1e-5 and
1e-4 of max|audio| of the JAX session's.
"""

import pytest
import torch

from test_torch_voice_clone import check_session, models  # noqa: F401  (a module fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])
def test_design_sessions_match_jax(models, temperature):  # noqa: F811
    check_session(models, (None, None), "design", temperature)
