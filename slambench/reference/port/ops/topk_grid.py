"""Spatially uniform keypoint selection: per-cell top-k + budgeted global
pick (port of weiner_slamit_v2_tpu/ops/topk_grid.py, the array form of
ORBextractor::DistributeOctTree, src/ORBextractor.cc:494-776).

FAST scores of 8-bit images tie often; ``util.topk`` keeps JAX's
lower-index tie order, so the selected keypoints match exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..util import topk

_HIGH_BONUS = 1024.0   # > any FAST score: high-threshold corners win a cell
_RANK_PENALTY = 4096.0  # > any single priority: rank classes stay ordered


def select_keypoints(score, budget: int, cell_size: int = 32, per_cell_cap: int = 4,
                     high_threshold: float = 20.0, low_threshold: float = 7.0,
                     margin: int = 19):
    """Up to ``budget`` keypoints from a dense (H, W) response map.
    Returns xy (budget, 2) f32 (x, y), resp (budget,) f32, valid (budget,)."""
    h, w = score.shape
    dev = score.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inside = (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)
    score = torch.where(inside & (score > low_threshold), score, 0.0)

    ncy, ncx = -(-h // cell_size), -(-w // cell_size)
    padded = F.pad(score, (0, ncx * cell_size - w, 0, ncy * cell_size - h))
    cells = (
        padded.reshape(ncy, cell_size, ncx, cell_size)
        .permute(0, 2, 1, 3)
        .reshape(ncy * ncx, cell_size * cell_size)
    )
    prio = torch.where(cells > high_threshold, cells + _HIGH_BONUS, cells)
    k = min(per_cell_cap, cell_size * cell_size)
    cell_vals, cell_idx = topk(prio, k)

    cid = torch.arange(ncy * ncx, device=dev)
    gy = (cid // ncx)[:, None] * cell_size + cell_idx // cell_size
    gx = (cid % ncx)[:, None] * cell_size + cell_idx % cell_size
    rank = torch.arange(k, device=dev, dtype=cell_vals.dtype)[None, :]
    global_prio = torch.where(
        cell_vals > 0.0, cell_vals - rank * _RANK_PENALTY, -torch.inf
    )
    flat_prio = global_prio.reshape(-1)
    flat_y, flat_x = gy.reshape(-1), gx.reshape(-1)
    if flat_prio.shape[0] < budget:
        pad = budget - flat_prio.shape[0]
        flat_prio = torch.cat([flat_prio, torch.full((pad,), -torch.inf, device=dev)])
        flat_y = torch.cat([flat_y, flat_y.new_zeros(pad)])
        flat_x = torch.cat([flat_x, flat_x.new_zeros(pad)])
    top_vals, top_idx = topk(flat_prio, budget)
    sel_y, sel_x = flat_y[top_idx], flat_x[top_idx]
    valid = torch.isfinite(top_vals)
    resp = torch.where(valid, padded[sel_y, sel_x], 0.0)
    xy = torch.stack([sel_x.float(), sel_y.float()], -1)
    return xy, resp, valid
