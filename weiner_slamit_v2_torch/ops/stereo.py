"""Rectified stereo matching and RGB-D depth lookup (port of
weiner_slamit_v2_tpu/ops/stereo.py; Frame::ComputeStereoMatches,
src/Frame.cc:591-763, and Frame::ComputeStereoFromRGBD, src/Frame.cc:766-787).

The whole frame is matched at once: one masked (N_l x N_r) Hamming matrix
with row-band, disparity and octave gates, then a batched 11x11 SAD slide
over +-5 px with a parabola fit. Plain PyTorch: the JAX package runs this
under XLA, not Pallas, so it has no hand-written kernel here either.

Exactness: rounding is half to even in both packages (``torch.round``); the
Hamming best and the SAD best take the first index on a tie. On integer
images (uint8 frames) every SAD is an integer below 2^24, exact in float32
in any summation order, so the SAD argmin cannot differ from the JAX
package's.
"""

from __future__ import annotations

import torch

from . import hamming

TH_HIGH = 100  # descriptor gate (ORBmatcher::TH_HIGH, used at Frame.cc:637)
SAD_WIN = 5    # half-window of the 11x11 SAD block (Frame.cc:684: w=5)
SAD_RANGE = 5  # disparity slide +-L (Frame.cc:690: L=5)


def match_stereo(left_feats, right_feats, left_img: torch.Tensor, right_img: torch.Tensor,
                 baseline_fx, min_z_depth, scale_factors: torch.Tensor, n_levels: int):
    """Per-left-keypoint depth and right-image u.

    left_feats / right_feats: FrameFeatures of the rectified pair;
    left_img / right_img: (H, W) level-0 images (float32) for the SAD;
    baseline_fx: bf = baseline * fx; min_z_depth: the smallest depth, the
    baseline (Frame.cc:610); scale_factors: (L,) per-octave scales.
    Returns (depth (N_l,), u_right (N_l,)): -1 where unmatched, as
    Frame::mvDepth / mvuRight.
    """
    dev = left_img.device
    bf, min_z = (v.to(torch.float32) if torch.is_tensor(v)
                 else torch.full((), v, dtype=torch.float32, device=dev)
                 for v in (baseline_fx, min_z_depth))
    max_d = bf / torch.clamp(min_z, min=1e-6)
    xl, yl = left_feats.xy[:, 0], left_feats.xy[:, 1]
    xr, yr = right_feats.xy[:, 0], right_feats.xy[:, 1]

    # row band |y_l - y_r| <= 2 * scale of the right keypoint's octave
    # (Frame.cc:617-627); disparity in [-3, bf / minZ] (Frame.cc:608-610);
    # octaves within one level (Frame.cc:650)
    band = 2.0 * scale_factors[right_feats.octave.clamp(0, n_levels - 1)]
    row_ok = (yl[:, None] - yr[None, :]).abs() <= band[None, :]
    disp = xl[:, None] - xr[None, :]
    disp_ok = (disp >= -3.0) & (disp <= max_d)
    l_oct = left_feats.octave
    oct_ok = (l_oct[:, None] - right_feats.octave[None, :]).abs() <= 1
    dist = hamming.masked_distance_matrix(left_feats.desc, right_feats.desc, left_feats.valid,
                                          right_feats.valid, row_ok & disp_ok & oct_ok)
    best_idx, best = hamming.packed_min(dist)
    matched = best < TH_HIGH

    # SAD refinement around the matched right keypoint (Frame.cc:666-731):
    # an 11x11 block slid over +-5 px, a parabola through the best three
    H, W = left_img.shape
    xr0 = xr[best_idx.long()]
    d = torch.arange(-SAD_WIN, SAD_WIN + 1, device=dev)
    yy = (torch.round(yl).to(torch.int64)[:, None, None] + d[None, :, None]).clamp(0, H - 1)
    xx_l = (torch.round(xl).to(torch.int64)[:, None, None] + d[None, None, :]).clamp(0, W - 1)
    patch_l = left_img[yy, xx_l]                                            # (N, 11, 11)
    patch_l = patch_l - patch_l[:, SAD_WIN:SAD_WIN + 1, SAD_WIN:SAD_WIN + 1]
    offsets = torch.arange(-SAD_RANGE, SAD_RANGE + 1, device=dev)
    xx_r = (torch.round(xr0).to(torch.int64)[:, None, None, None] + offsets[None, :, None, None]
            + d[None, None, None, :]).clamp(0, W - 1)                      # (N, 11, 1, 11)
    patch_r = right_img[yy[:, None], xx_r]                                  # (N, 11, 11, 11)
    patch_r = patch_r - patch_r[:, :, SAD_WIN:SAD_WIN + 1, SAD_WIN:SAD_WIN + 1]
    sads = (patch_l[:, None] - patch_r).abs().sum((2, 3))                   # (N, 11)
    best_o = torch.argmin(sads, 1)
    o_c = best_o.clamp(1, 2 * SAD_RANGE - 1)
    s_m = sads.gather(1, (o_c - 1)[:, None])[:, 0]
    s_0 = sads.gather(1, o_c[:, None])[:, 0]
    s_p = sads.gather(1, (o_c + 1)[:, None])[:, 0]
    denom = torch.clamp(s_m + s_p - 2.0 * s_0, min=1e-6)
    delta = (0.5 * (s_m - s_p) / denom).clamp(-1.0, 1.0)   # out-of-window minima (Frame.cc:717)

    u_r = xr0 + (o_c.to(torch.float32) - SAD_RANGE) + delta
    disparity = xl - u_r
    ok = matched & (disparity > 0.0) & (disparity < max_d)
    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-3), -1.0)
    return depth, torch.where(ok, u_r, -1.0)


def depth_from_depthmap(feats, depth_map: torch.Tensor) -> torch.Tensor:
    """Per-keypoint depth from an RGB-D depth image: the nearest pixel at
    the (distorted) keypoint (Frame::ComputeStereoFromRGBD). -1 where the
    feature is invalid or the depth is not positive."""
    H, W = depth_map.shape
    x = torch.round(feats.xy[:, 0]).to(torch.int64).clamp(0, W - 1)
    y = torch.round(feats.xy[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = depth_map[y, x]
    return torch.where(feats.valid & (d > 0), d, -1.0)
