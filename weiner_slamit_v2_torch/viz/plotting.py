"""Offline trajectory and map plots, matplotlib to PNG (port of
weiner_slamit_v2_tpu/viz/plotting.py; the offline form of the reference's
GL viewer, src/MapDrawer.cc:75-282 and FrameDrawer). matplotlib is imported
when a plot is drawn: the card's machine does not have it."""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, ax, plt, path: str, title: str) -> None:
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_trajectory(path: str, est_Twc, gt_Twc=None, title: str = "trajectory") -> None:
    """Top-down (x, z) trajectory, optionally against ground truth."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    p = _np(est_Twc)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 2], "-", lw=1.2, label="estimate")
    if gt_Twc is not None:
        g = _np(gt_Twc)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    _save(fig, ax, plt, path, title)


def plot_map(path: str, slam_map, title: str = "map") -> None:
    """Map points (dots) and keyframe positions (triangles), top-down
    (MapDrawer::DrawMapPoints / DrawKeyFrames)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    mp = _np(slam_map.mp_pos)[_np(slam_map.mp_valid)]
    ax.scatter(mp[:, 0], mp[:, 2], s=1, alpha=0.4, label="map points")
    Twc = np.linalg.inv(_np(slam_map.kf_pose).astype(np.float64)[_np(slam_map.kf_valid)])
    ax.plot(Twc[:, 0, 3], Twc[:, 2, 3], "^-", ms=4, lw=0.8, color="tab:red", label="keyframes")
    _save(fig, ax, plt, path, title)


def plot_frame_features(path: str, image, feats, title: str = "frame") -> None:
    """Keypoints over the frame (FrameDrawer::DrawFrame)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_np(image), cmap="gray")
    xy = _np(feats.xy)[_np(feats.valid)]
    ax.scatter(xy[:, 0], xy[:, 1], s=6, facecolors="none", edgecolors="lime", lw=0.6)
    ax.set_title(f"{title}: {len(xy)} keypoints")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
