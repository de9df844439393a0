"""Data-parallel extraction: a batch of frames split across ranks (port of
weiner_slamit_v2_tpu/parallel/data_parallel.py).

Each frame goes through ``OrbExtractor.__call__`` as on the main path, so
the output equals per-frame extraction bit for bit; kernel A fuses a frame's
8 pyramid levels into one launch, so a batch of B frames is B launches (a
rank's block of them under ``sharded_extract``). The fields come back with a
leading batch axis, as JAX's ``vmap`` gives them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..frontend.extractor import FrameFeatures, OrbExtractor


def batched_extract(extractor: OrbExtractor, images: torch.Tensor) -> FrameFeatures:
    """Features of a batch of frames, images (B, H, W) uint8 or float32."""
    feats = [extractor(img) for img in images]
    return FrameFeatures(**{f.name: torch.stack([getattr(x, f.name) for x in feats])
                            for f in dataclasses.fields(FrameFeatures)})


def sharded_extract(extractor: OrbExtractor, images: torch.Tensor, mesh) -> FrameFeatures:
    """Rank r extracts its contiguous block of B / world_size frames on its
    device; the fields are gathered, so every rank returns all B frames."""
    B = images.shape[0]
    if B % mesh.world_size:
        raise ValueError(f"{B} frames do not split evenly over {mesh.world_size} ranks")
    n = B // mesh.world_size
    local = batched_extract(extractor, images[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device))
    return FrameFeatures(**{f.name: mesh.gather_rows(getattr(local, f.name))
                            for f in dataclasses.fields(FrameFeatures)})
