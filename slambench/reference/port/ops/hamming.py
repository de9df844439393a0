"""Hamming distance on packed 256-bit descriptors (port of
weiner_slamit_v2_tpu/ops/hamming.py; ORBmatcher::DescriptorDistance,
src/ORBmatcher.cc:1651-1667).

Descriptors are (N, 8) int32 bit patterns of the reference's uint32 words
(torch has no popcount and thin uint32 support); popcount is the same SWAR
bit count the reference uses.
"""

from __future__ import annotations

import torch

INVALID_DIST = 10_000  # larger than any possible 256-bit distance


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR, no overflow)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs distances: (..., N1, 8) x (..., N2, 8) -> (..., N1, N2) int32."""
    x = d1[..., :, None, :] ^ d2[..., None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def packed_min(dist: torch.Tensor):
    """(argmin, min) along the last axis; ties to the smaller index."""
    n2 = dist.shape[-1]
    iota = torch.arange(n2, dtype=torch.int32, device=dist.device)
    m = (dist.to(torch.int32) * n2 + iota).amin(-1)
    return m % n2, m // n2


