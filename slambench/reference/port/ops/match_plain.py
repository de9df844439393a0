"""Kernel B's plain form (a frozen copy of the port's
``windowed_best2_plain``): the gated windowed Hamming best / second match."""

from __future__ import annotations

import torch

from .hamming import INVALID_DIST, distance_matrix


def windowed_best2_plain(desc1, desc2, valid1, valid2, pred_xy, xy2, window,
                         oct_lo, oct_hi, octave2, chi2_w, chi2_th: float):
    """Shapes: desc1 (B,N1,8) desc2 (B,N2,8) int32; valid1 (B,N1) valid2 (B,N2)
    bool; pred_xy (B,N1,2) xy2 (B,N2,2); window (B,N1); oct_lo/oct_hi (B,N1)
    i32; octave2 (B,N2) i32; chi2_w (B,N2); chi2_th <= 0 disables the chi2
    gate. Returns (best_idx, best_dist, second_dist), each (B, N1) int32."""
    n2 = desc2.shape[1]
    du = xy2[:, None, :, 0] - pred_xy[:, :, None, 0]
    dv = xy2[:, None, :, 1] - pred_xy[:, :, None, 1]
    win = window[:, :, None]
    o2 = octave2[:, None, :]
    ok = (du.abs() < win) & (dv.abs() < win)
    ok &= (o2 >= oct_lo[:, :, None]) & (o2 <= oct_hi[:, :, None])
    ok &= valid1[:, :, None] & valid2[:, None, :]
    if chi2_th > 0:
        ok &= (du * du + dv * dv) * chi2_w[:, None, :] <= chi2_th
    dist = distance_matrix(desc1, desc2)
    iota = torch.arange(n2, dtype=torch.int32, device=dist.device)
    code = torch.where(ok, dist, INVALID_DIST) * n2 + iota
    m = code.amin(-1)
    best_i = m % n2
    masked = torch.where(iota == best_i[..., None], (INVALID_DIST + 1) * n2, code)
    second = torch.clamp(masked.amin(-1) // n2, max=INVALID_DIST)
    return best_i, m // n2, second
