"""Deterministic synthetic sequences (port of the synthetic part of
weiner_slamit_v2_tpu/io/datasets.py: ``make_synthetic_sequence``, the
single-plane ``SyntheticWorld``, the occluding ``MultiPlaneWorld`` with its
depth maps and rectified right views, ``_perlin_texture``,
``_bilinear_sample``). numpy only, with the JAX package's order of random
draws, so the images, depths and right views are bit-equal to its own; the
Rodrigues rotation is evaluated in float32 as the JAX package evaluates it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class FrameData:
    timestamp: float
    image: np.ndarray            # (H, W) float32 grayscale in [0, 255]
    depth: np.ndarray | None = None   # (H, W) float32 meters, RGB-D only
    image_right: np.ndarray | None = None  # (H, W) stereo right view


@dataclass
class Sequence:
    frames: list[FrameData]
    gt_Twc: np.ndarray | None = None  # (N, 4, 4)

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[FrameData]:
        return iter(self.frames)


def _perlin_texture(h: int, w: int, rng: np.random.Generator, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture with plenty of corners for FAST."""
    img = np.zeros((h, w), dtype=np.float32)
    for o in range(octaves):
        step = 2 ** (octaves - o + 2)
        gh, gw = h // step + 2, w // step + 2
        grid = rng.uniform(0, 1, size=(gh, gw)).astype(np.float32)
        img += np.kron(grid, np.ones((step, step), dtype=np.float32))[:h, :w] * (0.5**o)
    for _ in range(160):   # high-contrast blocks for strong corners
        y = rng.integers(8, h - 24)
        x = rng.integers(8, w - 24)
        s = int(rng.integers(6, 18))
        img[y : y + s, x : x + s] = rng.uniform(0, 1)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def _bilinear_sample(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    u0 = np.floor(u).astype(np.int32)
    v0 = np.floor(v).astype(np.int32)
    du = (u - u0).astype(np.float32)
    dv = (v - v0).astype(np.float32)
    u0c = np.clip(u0, 0, w - 2)
    v0c = np.clip(v0, 0, h - 2)
    a, b = img[v0c, u0c], img[v0c, u0c + 1]
    c, e = img[v0c + 1, u0c], img[v0c + 1, u0c + 1]
    out = a * (1 - du) * (1 - dv) + b * du * (1 - dv) + c * (1 - du) * dv + e * du * dv
    inside = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    return np.where(inside, out, 0.0).astype(np.float32)


@dataclass
class SyntheticWorld:
    """A textured plane at z = plane_depth, rendered exactly by ray casting."""

    texture: np.ndarray
    K: np.ndarray
    plane_depth: float
    pixels_per_meter: float

    def render(self, Tcw: np.ndarray, h: int, w: int) -> np.ndarray:
        K = self.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        ray = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], axis=-1)
        R = Tcw[:3, :3].astype(np.float32)
        t = Tcw[:3, 3].astype(np.float32)
        C = -R.T @ t
        ray_w = ray @ R
        lam = (self.plane_depth - C[2]) / np.maximum(ray_w[..., 2], 1e-6)
        Xw = C[None, None, :] + lam[..., None] * ray_w
        th, tw = self.texture.shape
        tu = Xw[..., 0] * self.pixels_per_meter + tw / 2.0
        tv = Xw[..., 1] * self.pixels_per_meter + th / 2.0
        return _bilinear_sample(self.texture, tu, tv)


@dataclass
class MultiPlaneWorld:
    """Several textured fronto-parallel planes at different depths that
    occlude each other, rendered by ray casting (nearest hit wins); with
    ``photometric_noise`` a per-frame gain/bias drift and sensor noise. Can
    render the camera-frame depth map as well."""

    textures: list            # np.ndarray per plane
    K: np.ndarray
    depths: list              # plane z (world), near to far
    centers: list             # (x, y) world center per plane
    extents: list             # (half_x, half_y) meters per plane; None = unbounded
    pixels_per_meter: list

    def render(self, Tcw: np.ndarray, h: int, w: int, gain: float = 1.0, bias: float = 0.0,
               noise_rng: np.random.Generator | None = None, noise_std: float = 0.0,
               with_depth: bool = False):
        K = self.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        ray = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], axis=-1)
        R = Tcw[:3, :3].astype(np.float32)
        t = Tcw[:3, 3].astype(np.float32)
        Rt = R.T
        C = -Rt @ t
        ray_w = ray @ Rt.T
        best_lam = np.full((h, w), np.inf, np.float32)
        img = np.zeros((h, w), np.float32)
        for tex, d, ctr, ext, ppm in zip(self.textures, self.depths, self.centers, self.extents,
                                         self.pixels_per_meter):
            lam = (d - C[2]) / np.where(np.abs(ray_w[..., 2]) > 1e-6, ray_w[..., 2], 1e-6)
            Xw = C[None, None, :] + lam[..., None] * ray_w
            th, tw = tex.shape
            tu = (Xw[..., 0] - ctr[0]) * ppm + tw / 2.0
            tv = (Xw[..., 1] - ctr[1]) * ppm + th / 2.0
            hit = (lam > 0.05) & (lam < best_lam)
            if ext is not None:
                hit &= (np.abs(Xw[..., 0] - ctr[0]) <= ext[0]) & (np.abs(Xw[..., 1] - ctr[1]) <= ext[1])
            img = np.where(hit, _bilinear_sample(tex, tu, tv), img)
            best_lam = np.where(hit, lam, best_lam)
        img = np.clip(img * gain + bias, 0.0, 255.0)
        if noise_std > 0.0 and noise_rng is not None:
            img = np.clip(img + noise_rng.normal(0, noise_std, img.shape), 0.0, 255.0).astype(np.float32)
        img = img.astype(np.float32)
        if not with_depth:
            return img
        # camera-frame depth of the hit (z of R X + t); no hit -> 0
        lamf = np.where(np.isfinite(best_lam), best_lam, 0.0)
        Xw = C[None, None, :] + lamf[..., None] * ray_w
        z = (Xw @ R.T)[..., 2] + t[2]
        return img, np.where(np.isfinite(best_lam), z, 0.0).astype(np.float32)


def _make_multiplane_world(h: int, w: int, K: np.ndarray, rng: np.random.Generator) -> MultiPlaneWorld:
    """One far wall and 4 occluding slabs at staggered depths."""
    fx = float(K[0, 0])
    planes = [   # (depth, center, extent); the wall has no extent bound
        (6.0, (0.0, 0.0), None),
        (4.2, (-0.9, -0.6), (1.1, 0.9)),
        (3.6, (1.0, 0.5), (1.0, 0.8)),
        (3.0, (0.1, 0.9), (0.9, 0.55)),
        (2.6, (-0.4, 0.45), (0.55, 0.45)),
    ]
    textures, depths, centers, extents, ppms = [], [], [], [], []
    for d, ctr, ext in planes:
        ppm = fx / d
        if ext is None:
            th, tw = int(h * 3.0), int(w * 3.0)
        else:
            th = min(int(2 * ext[1] * ppm) + 8, int(h * 3))
            tw = min(int(2 * ext[0] * ppm) + 8, int(w * 3))
        textures.append(_perlin_texture(th, tw, rng))
        depths.append(d)
        centers.append(np.asarray(ctr, np.float32))
        extents.append(ext)
        ppms.append(ppm)
    return MultiPlaneWorld(textures=textures, K=K, depths=depths, centers=centers,
                           extents=extents, pixels_per_meter=ppms)


def _so3_exp_f32(omega: np.ndarray) -> np.ndarray:
    """Rodrigues rotation in float32 (geometry/se3.so3_exp of the JAX package)."""
    w = np.asarray(omega, np.float32)
    f = np.float32
    theta2 = f(np.sum(w * w))
    theta = np.sqrt(theta2 + f(1e-8) * f(1e-8))
    if theta2 > f(1e-8):
        a, b = np.sin(theta) / theta, (f(1.0) - np.cos(theta)) / theta2
    else:
        a, b = f(1.0) - theta2 / f(6.0), f(0.5) - theta2 / f(24.0)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float32)
    return (np.eye(3, dtype=np.float32) + f(a) * K + f(b) * (K @ K)).astype(np.float32)


def make_synthetic_sequence(n_frames: int = 30, h: int = 480, w: int = 640, seed: int = 0,
                            K: np.ndarray | None = None, motion: str = "strafe",
                            plane_depth: float = 4.0, world: str = "plane",
                            photometric_noise: float = 0.0, with_depth: bool = False,
                            stereo_baseline: float | None = None,
                            motion_frames: int | None = None) -> Sequence:
    """Deterministic synthetic sequence with exact ground truth.
    motion: "strafe", "orbit", "loop" or "forward"; world: "plane" (one
    textured plane) or "multi" (occluding planes); photometric_noise: pixel
    noise std, with a slow gain/bias drift; with_depth: exact depth maps
    ("multi" only); stereo_baseline: a rectified right view at this baseline
    (m); motion_frames normalizes the path by that frame count instead of
    n_frames (constant per-frame motion for longer sequences)."""
    rng = np.random.default_rng(seed)
    if K is None:
        K = np.array([[500.0, 0, w / 2 - 0.5], [0, 500.0, h / 2 - 0.5], [0, 0, 1]], dtype=np.float32)
    if world == "multi":
        scene = _make_multiplane_world(h, w, K, rng)
    else:
        scene = SyntheticWorld(
            texture=_perlin_texture(int(h * 2.5), int(w * 2.5), rng), K=K,
            plane_depth=plane_depth, pixels_per_meter=float(K[0, 0]) / plane_depth,
        )
    noise_rng = np.random.default_rng(seed + 77)   # left image first, then right
    T_rl = np.eye(4)   # right camera: X_r = X_l - (b, 0, 0) in the left camera's frame
    if stereo_baseline is not None:
        T_rl[0, 3] = -stereo_baseline
    frames = []
    gt = np.zeros((n_frames, 4, 4))
    denom = max((motion_frames or n_frames) - 1, 1)
    for i in range(n_frames):
        a = i / denom
        if motion == "strafe":
            twc = np.array([0.8 * a, 0.15 * np.sin(2 * np.pi * a), 0.0])
            rot = np.zeros(3)
        elif motion == "orbit":
            twc = np.array([0.6 * np.sin(np.pi * a), 0.1 * a, 0.2 * (1 - np.cos(np.pi * a))])
            rot = np.array([0.02 * np.sin(2 * np.pi * a), -0.08 * np.sin(np.pi * a), 0.01 * a])
        elif motion == "loop":
            twc = np.array([0.9 * np.sin(2 * np.pi * a), 0.08 * np.sin(4 * np.pi * a),
                            0.35 * (1 - np.cos(2 * np.pi * a))])
            rot = np.array([0.0, -0.12 * np.sin(2 * np.pi * a), 0.0])
        elif motion == "forward":
            twc = np.array([0.05 * np.sin(2 * np.pi * a), 0.0, 0.9 * a])
            rot = np.zeros(3)
        else:
            raise ValueError(f"unknown motion {motion!r}")
        Twc = np.eye(4)
        Twc[:3, :3] = _so3_exp_f32(rot)
        Twc[:3, 3] = twc
        gt[i] = Twc
        Tcw = np.linalg.inv(Twc)
        if photometric_noise > 0.0:
            gain = 1.0 + 0.05 * np.sin(2 * np.pi * 1.7 * a)
            bias = 4.0 * np.sin(2 * np.pi * 0.9 * a + 1.0)
            noise_std = photometric_noise
        else:
            gain, bias, noise_std = 1.0, 0.0, 0.0
        depth = img_right = None
        if isinstance(scene, MultiPlaneWorld):
            out = scene.render(Tcw, h, w, gain=gain, bias=bias, noise_rng=noise_rng,
                               noise_std=noise_std, with_depth=with_depth)
            img, depth = out if with_depth else (out, None)
            if stereo_baseline is not None:
                img_right = scene.render(T_rl @ Tcw, h, w, gain=gain, bias=bias,
                                         noise_rng=noise_rng, noise_std=noise_std)
        else:
            img = scene.render(Tcw, h, w)
            if photometric_noise > 0.0:
                img = np.clip(img * gain + bias + noise_rng.normal(0, noise_std, img.shape),
                              0.0, 255.0).astype(np.float32)
            if stereo_baseline is not None:
                img_right = scene.render(T_rl @ Tcw, h, w)
        frames.append(FrameData(timestamp=i / 30.0, image=img, depth=depth, image_right=img_right))
    return Sequence(frames=frames, gt_Twc=gt)
