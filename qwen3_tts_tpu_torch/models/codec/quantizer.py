"""Generic vector quantization utilities (VQ / residual VQ).

PyTorch port of ``qwen3_tts_tpu/models/codec/quantizer.py``: L2-nearest VQ
and residual VQ encode/decode. The pipeline uses the specialised codebooks
inside the vocoder and the Mimi encoder; this module is the reusable
building block for codec experiments. f32 at full precision (the package
turns TF32 off at import).
"""

from __future__ import annotations

import torch

from ...utils.device import device_or_card


def nearest_code(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Euclidean nearest-neighbour indices: x [..., D], codebook [V, D] -> int64 [...].

    ``||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2``, in that order, as the JAX
    package sums it; ties go to the lowest index (``argmin``).
    """
    d2 = (x**2).sum(-1, keepdim=True) - 2.0 * x @ codebook.T + (codebook**2).sum(-1)
    return torch.argmin(d2, dim=-1)


class VectorQuantizer:
    """Single codebook, euclidean nearest-neighbour quantization."""

    def __init__(self, codebook: torch.Tensor):
        """codebook: [codebook_size, dim]."""
        self.codebook = codebook

    @classmethod
    def random(cls, generator: torch.Generator, codebook_size: int, dim: int, scale: float = 1.0,
               device: torch.device | str | None = None) -> "VectorQuantizer":
        """A [codebook_size, dim] codebook of normal draws from ``generator``
        (on the CPU) times ``scale``, placed on ``device`` (the card when
        None)."""
        return cls((torch.randn((codebook_size, dim), generator=generator) * scale).to(device_or_card(device)))

    @property
    def size(self) -> int:
        return self.codebook.shape[0]

    @property
    def dim(self) -> int:
        return self.codebook.shape[1]

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [batch, seq, dim] -> (quantized [B, S, D], indices [B, S])."""
        indices = nearest_code(x, self.codebook)
        return self.decode(indices), indices

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return self.codebook[indices]


class ResidualVectorQuantizer:
    """Stack of VQ layers, each quantizing the previous layer's residual."""

    def __init__(self, codebooks: torch.Tensor):
        """codebooks: [num_quantizers, codebook_size, dim]."""
        self.codebooks = codebooks

    @classmethod
    def random(cls, generator: torch.Generator, num_quantizers: int, codebook_size: int, dim: int,
               device: torch.device | str | None = None) -> "ResidualVectorQuantizer":
        """[num_quantizers, codebook_size, dim] codebooks of normal draws from
        ``generator`` (on the CPU), placed on ``device`` (the card when
        None)."""
        shape = (num_quantizers, codebook_size, dim)
        return cls(torch.randn(shape, generator=generator).to(device_or_card(device)))

    @property
    def num_quantizers(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dim(self) -> int:
        return self.codebooks.shape[2]

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, S, D] -> (quantized sum [B, S, D], indices [B, Q, S])."""
        residual, quantized, indices = x, [], []
        for codebook in self.codebooks:
            q, idx = VectorQuantizer(codebook).encode(residual)
            residual = residual - q
            quantized.append(q)
            indices.append(idx)
        return torch.stack(quantized).sum(0), torch.stack(indices, dim=1)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """indices: [B, Q, S] -> per-layer embeddings [B, S, Q, D]."""
        q = torch.arange(self.num_quantizers, device=indices.device)[None, :, None]
        return self.codebooks[q, indices].transpose(1, 2)

    def decode_sum(self, indices: torch.Tensor) -> torch.Tensor:
        """indices: [B, Q, S] -> summed embeddings [B, S, D]."""
        return self.decode(indices).sum(dim=2)
