"""``ops/rows.py``: sums and prefix sums whose order the row alone fixes,
and the decode attention built on them (``nn._step_attention``).

On the CPU ``row_sum``, ``row_mean`` and ``row_cumsum`` are ``sum``,
``mean`` and ``cumsum`` (the JAX parity tests' order); their card forms (chunked sums, a Sklansky
network) are held here to ``sum`` and ``cumsum`` within f32 rounding at
every shape the port gives them (the RMSNorm rows, the sampling's vocabularies and top-k, widths
off the chunk size, one row and many). On the card (``gpu``) a row's result
is bit-equal whatever rows share the call. The decode attention's card
form against ``gqa_attention``'s einsums on the CPU: one bf16 ulp of the
output's scale (bf16), 1e-6 (f32); on the card each stream's rows
bit-equal at every batch size.
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.ops import nn, rows

torch.set_num_threads(1)

WIDTHS = [1, 31, 32, 33, 50, 63, 64, 100, 128, 200, 256, 1000, 1024, 2048, 3072]


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("r", [1, 3, 8])
def test_chunked_forms_match_sum_and_cumsum(r, n):
    x = torch.from_numpy(np.random.RandomState(r * 7 + n).rand(r, n).astype(np.float32))
    torch.testing.assert_close(rows._sum(x), x.sum(-1, keepdim=True), rtol=1e-6, atol=1e-6 * n)
    got = rows._scan(x)
    assert got.shape == (r, n)
    torch.testing.assert_close(got, torch.cumsum(x, -1), rtol=1e-6, atol=1e-6 * n)


def test_cpu_is_sum_and_cumsum():
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4, 3072).astype(np.float32))
    assert torch.equal(rows.row_sum(x), x.sum(-1, keepdim=True))
    assert torch.equal(rows.row_mean(x), x.mean(-1, keepdim=True))
    assert torch.equal(rows.row_cumsum(x), torch.cumsum(x, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [50, 1024, 2048, 3072])
def test_cuda_rows_invariant(n):
    """The first rows of a [128, n] tensor give the bits of the same rows in
    the whole call, at every row count a batch gives them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.rand((128, n), generator=torch.Generator(device="cuda").manual_seed(n), device="cuda")
    whole_sum, whole_scan = rows.row_sum(x), rows.row_cumsum(x)
    for m in (1, 2, 4, 8, 10, 16, 40, 80):
        assert torch.equal(rows.row_sum(x[:m]), whole_sum[:m]), m
        assert torch.equal(rows.row_cumsum(x[:m]), whole_scan[:m]), m


def _attention_inputs(b, seq, dtype, device="cpu", seed=0):
    """One query row a stream (16 heads over 8 KV heads of 64), a cache of
    ``seq`` rows, each stream's mask live up to its own row."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, 1, 16, 64), generator=gen, device=device).to(dtype)
    k = torch.randn((b, seq, 8, 64), generator=gen, device=device).to(dtype)
    v = torch.randn((b, seq, 8, 64), generator=gen, device=device).to(dtype)
    live = torch.tensor([seq - 1 - 3 * i for i in range(b)], device=device)
    mask = (torch.arange(seq, device=device) <= live[:, None])[:, None, None, None]
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq", [17, 146, 274])
def test_step_attention_matches_einsums(seq, dtype):
    q, k, v, mask = _attention_inputs(3, seq, dtype)
    got = nn._step_attention(q, k, v, mask, 0.125)
    want = nn.gqa_attention(q, k, v, mask, 0.125)  # the einsums, on the CPU
    assert got.shape == want.shape == (3, 1, 16, 64) and got.dtype == dtype
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [17, 146, 2624])
def test_cuda_step_attention_rows_invariant(seq):
    """Stream i's attention output is bit-equal at B = 1, 4 and 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = _attention_inputs(8, seq, torch.bfloat16, "cuda", seq)
    whole = nn.gqa_attention(q, k, v, mask, 0.125)
    for b in (1, 4):
        got = nn.gqa_attention(q[:b], k[:b], v[:b], mask[:b], 0.125)
        assert torch.equal(got.view(torch.int16), whole[:b].view(torch.int16)), b
