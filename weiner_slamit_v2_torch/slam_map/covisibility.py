"""Covisibility weights from the observation relation (port of
weiner_slamit_v2_tpu/slam_map/covisibility.py; KeyFrame::UpdateConnections,
src/KeyFrame.cc:296-386)."""

from __future__ import annotations

import torch

from .types import SlamMap, observation_indicator

MIN_COVIS_WEIGHT = 15   # KeyFrame.cc:337-383


def covisibility_matrix(m: SlamMap) -> torch.Tensor:
    """(K, K) int32 shared-point counts, diagonal and invalid KFs zeroed.
    The indicator product is exact in float32 (TF32 is off)."""
    ind = (observation_indicator(m) & m.mp_valid[None, :]).float()
    W = (ind @ ind.T).to(torch.int32)
    W.fill_diagonal_(0)
    vv = m.kf_valid
    return torch.where(vv[:, None] & vv[None, :], W, 0)
