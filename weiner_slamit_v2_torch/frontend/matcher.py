"""Descriptor matching as masked batched reductions (port of
weiner_slamit_v2_tpu/frontend/matcher.py; ORBmatcher, src/ORBmatcher.cc).

Tracking keeps this plain form, as the JAX package does (its
matcher.py:100-104); kernel B serves the mapping fuse stage.
"""

from __future__ import annotations

import math

import torch

from ..ops import hamming
from ..ops.hamming import INVALID_DIST
from ..util import device_const, put

TH_LOW = 50       # ORBmatcher.cc:37
TH_HIGH = 100     # ORBmatcher.cc:38
HISTO_LENGTH = 30  # ORBmatcher.cc:39
_I32_MAX = 2**31 - 1


def rotation_consistency_mask(angle1, angle2_matched, match_valid, n_bins: int = HISTO_LENGTH):
    """Keep matches whose rotation offset is in the 3 dominant histogram bins
    (ComputeThreeMaxima, ORBmatcher.cc:1605-1646; bins 2-3 need >= 0.1x max)."""
    two_pi = device_const("two_pi", angle1.device,
                          lambda d: torch.tensor(2.0 * math.pi, dtype=torch.float32, device=d))
    rot = torch.remainder(angle1 - angle2_matched, two_pi)
    bins = ((rot * n_bins) / two_pi).to(torch.int32).clamp(0, n_bins - 1)
    counts = put(torch.zeros(n_bins, dtype=torch.int32, device=angle1.device),
                 bins, match_valid.to(torch.int32), "add")
    top3 = torch.argsort(-counts, stable=True)[:3]
    c = counts[top3]        # a gather: a 0-d tensor index would be read on the host
    keep1 = torch.where(c[1] >= 0.1 * c[0], top3[1], -1)
    keep2 = torch.where(c[2] >= 0.1 * c[0], top3[2], -1)
    in_top = (bins == top3[0]) | (bins == keep1) | (bins == keep2)
    return match_valid & in_top


def match_with_window(desc1, desc2, valid1, valid2, pred_xy, xy2, window,
                      max_dist=TH_LOW, nn_ratio: float = 0.9, octave2=None,
                      octave_lo=None, octave_hi=None, mutual: bool = False,
                      angle1=None, angle2=None, histo_bins: int = HISTO_LENGTH):
    """For each row i of set 1 the best column j of set 2 with
    |xy2[j] - pred_xy[i]|_inf < window[i] (plus optional octave band, ratio,
    mutual-best and rotation checks). Returns (match_idx (N1,) int32 or -1,
    best_dist (N1,))."""
    n1 = desc1.shape[0]
    if torch.is_tensor(window):
        window = window.to(torch.float32).expand(n1)
    else:
        window = torch.full((n1,), window, dtype=torch.float32, device=desc1.device)
    dxy = (xy2[None, :, :] - pred_xy[:, None, :]).abs()
    pair = (dxy[..., 0] < window[:, None]) & (dxy[..., 1] < window[:, None])
    if octave2 is not None:
        if octave_lo is not None:
            pair &= octave2[None, :] >= octave_lo[:, None]
        if octave_hi is not None:
            pair &= octave2[None, :] <= octave_hi[:, None]
    dist = hamming.masked_distance_matrix(desc1, desc2, valid1, valid2, pair)
    idx, best, second = hamming.best_and_second(dist)
    ok = best <= max_dist
    has_second = second < INVALID_DIST
    ok &= ~has_second | (best.float() < nn_ratio * second.float())
    if mutual:
        bwd = torch.argmin(dist, dim=0)
        ok &= bwd[idx] == torch.arange(n1, device=dist.device)
    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency_mask(angle1, angle2[idx], ok, histo_bins)
    ok &= column_unique_best(idx, best, ok, desc2.shape[0])
    return torch.where(ok, idx, -1), best


def column_unique_best(idx, best, ok, n2: int):
    """True for rows that are the unique minimum-distance claimant of their
    matched column (ties to the lowest row)."""
    d = torch.where(ok, best, INVALID_DIST)
    col_min = put(torch.full((n2,), INVALID_DIST, dtype=d.dtype, device=d.device), idx, d, "min")
    is_min = d == col_min[idx]
    rows = torch.arange(idx.shape[0], dtype=torch.int32, device=d.device)
    claim = torch.where(is_min & ok, rows, _I32_MAX)
    col_row = put(torch.full((n2,), _I32_MAX, dtype=torch.int32, device=d.device), idx, claim, "min")
    return ok & is_min & (col_row[idx] == rows)


def search_for_initialization(feats1, feats2, window: float = 100.0,
                              nn_ratio: float = 0.9, check_rotation: bool = True):
    """Wide-window mutual-best matching for the monocular initializer
    (SearchForInitialization, ORBmatcher.cc:409-524; all octaves)."""
    return match_with_window(
        feats1.desc, feats2.desc, feats1.valid, feats2.valid,
        pred_xy=feats1.xy_und, xy2=feats2.xy_und, window=window,
        max_dist=TH_LOW, nn_ratio=nn_ratio, mutual=True,
        angle1=feats1.angle if check_rotation else None,
        angle2=feats2.angle if check_rotation else None,
    )


def match_by_descriptor(desc1, desc2, valid1, valid2, max_dist=TH_LOW,
                        nn_ratio: float = 0.75, angle1=None, angle2=None,
                        histo_bins: int = HISTO_LENGTH):
    """Unwindowed brute-force matching with ratio test (the array form of
    SearchByBoW's in-node brute force, ORBmatcher.cc:161-292)."""
    dist = hamming.masked_distance_matrix(desc1, desc2, valid1, valid2)
    idx, best, second = hamming.best_and_second(dist)
    ok = (best <= max_dist) & (
        best.float() < nn_ratio * torch.where(second < INVALID_DIST, second, INVALID_DIST).float()
    )
    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency_mask(angle1, angle2[idx], ok, histo_bins)
    ok &= column_unique_best(idx, best, ok, desc2.shape[0])
    return torch.where(ok, idx, -1), best
