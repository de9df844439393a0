"""The benchmark's traffic generator: camera paths, kidnap schedules and
textured worlds rendered on the device, as monocular frames, rectified
stereo pairs or frames with their depth.

A traffic file (``slambench/traffic/<name>.json``) holds only parameters;
``build_traffic`` turns it, a sensor and a seed into the frames the window
hands to the program. The seed draws only the worlds' textures: the path, the plane layout, the pace and the kidnap
schedule come from the file, so the work a frame costs depends little on
the seed.

The texture generator and the ray casting are copies of the port's
synthetic generator (``io/datasets.py``: ``_perlin_texture``,
``SyntheticWorld``, ``_so3_exp_f32``), widened so that a world can be as
long as a path of well over a thousand frames and rendered in batches with
torch on the card. The rays may come from a distorted lens:
each pixel of the distorted image casts the ray of its undistorted position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# frames rendered per batch on the device
RENDER_BATCH = 32


def perlin_texture(h: int, w: int, rng: np.random.Generator, octaves: int = 5,
                   n_blocks: int = 160) -> np.ndarray:
    """Multi-octave value noise with high-contrast blocks for FAST corners
    (the port's ``_perlin_texture``; ``n_blocks`` scales the blocks with the
    area of a larger texture, 160 is the original's count)."""
    img = np.zeros((h, w), dtype=np.float32)
    for o in range(octaves):
        step = 2 ** (octaves - o + 2)
        gh, gw = h // step + 2, w // step + 2
        grid = rng.uniform(0, 1, size=(gh, gw)).astype(np.float32)
        img += np.kron(grid, np.ones((step, step), dtype=np.float32))[:h, :w] * (0.5**o)
    for _ in range(n_blocks):
        y = rng.integers(8, h - 24)
        x = rng.integers(8, w - 24)
        s = int(rng.integers(6, 18))
        img[y : y + s, x : x + s] = rng.uniform(0, 1)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def so3_exp_f32(omega: np.ndarray) -> np.ndarray:
    """Rodrigues rotation in float32 (the port's ``_so3_exp_f32``)."""
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


# --- paths and schedules -------------------------------------------------------

def _sines(spec: list, s: np.ndarray) -> np.ndarray:
    """[offset, per-frame rate, [[amplitude, period, phase], ...]] at path
    positions s (frames)."""
    off, rate, terms = spec
    out = off + rate * s
    for amp, period, phase in terms:
        out = out + amp * np.sin(2.0 * np.pi * s / period + phase)
    return out


def path_poses(path: dict, s: np.ndarray) -> np.ndarray:
    """(len(s), 4, 4) float64 camera-to-world poses at path positions s."""
    pos = np.stack([_sines(path["pos"][k], s) for k in range(3)], -1)
    rot = np.stack([_sines(path["rot"][k], s) for k in range(3)], -1)
    Twc = np.tile(np.eye(4), (len(s), 1, 1))
    for i in range(len(s)):
        Twc[i, :3, :3] = so3_exp_f32(rot[i])
        Twc[i, :3, 3] = pos[i]
    return Twc


def kidnap_schedule(kid: dict | None, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(blank (n,) bool, s (n,) path positions) of frames 0..n-1: a pure
    function of the frame index. From frame ``start`` on, frame i is covered
    when (i - start) % period lies in [offset, offset + blank); the path
    position jumps ``jump`` frames ahead at the end of each cover."""
    i = np.arange(n)
    if not kid:
        return np.zeros(n, bool), i.astype(np.float64)
    start, period, offset, blank = kid["start"], kid["period"], kid["offset"], kid["blank"]
    rel = i - start
    blank_mask = (rel >= 0) & ((rel % period) >= offset) & ((rel % period) < offset + blank)
    # covers that ended at or before frame i
    done = np.where(rel >= 0, (rel - offset - blank) // period + 1, 0)
    done = np.maximum(done, 0)
    return blank_mask, i + kid["jump"] * done


# --- worlds -------------------------------------------------------------------

@dataclass
class Plane:
    texture: torch.Tensor      # (th, tw) float32 on the device
    depth: float               # the plane's world coordinate along its axis
    tex_center: tuple          # world (u, v) at the texture's centre
    ppm: float                 # texture pixels per meter
    axis: str = "z"            # the world axis the plane is normal to


# per axis: the world axes along the texture's columns (u) and rows (v)
TEX_AXES = {"x": (2, 1), "y": (0, 2), "z": (0, 1)}
AXIS = {"x": 0, "y": 1, "z": 2}


def _texture_size(spec: dict, path_x: tuple, fx: float, h: int, w: int) -> tuple:
    """(th, tw, centre u, centre v, ppm). A plane with ``extent`` ([[u0, u1],
    [v0, v1]] meters along its texture's axes) and ``ppm`` covers that
    extent. A plane normal to z without them (``depth``) covers the plane
    where any frame of the path can see it, with the view's half width at
    that depth on each side."""
    if "extent" in spec:
        (u0, u1), (v0, v1) = spec["extent"]
        ppm = spec["ppm"]
        return (int((v1 - v0) * ppm) + 8, int((u1 - u0) * ppm) + 8, 0.5 * (u0 + u1),
                0.5 * (v0 + v1), ppm)
    ppm = fx / spec["depth"]
    view_w = (w / fx) * spec["depth"] * spec.get("view_margin", 1.0)
    view_h = (h / fx) * spec["depth"] * spec.get("view_margin", 1.0)
    x0, x1 = path_x[0] - view_w, path_x[1] + view_w
    th = int(2 * (view_h + spec.get("y_span", 0.5)) * ppm) + 8
    return th, int((x1 - x0) * ppm) + 8, 0.5 * (x0 + x1), 0.0, ppm


def make_world(spec: dict, fx: float, h: int, w: int, path_x: tuple, seed: int,
               device) -> list[Plane]:
    """The planes of a world spec, their textures drawn from ``seed``. A
    plane is normal to its ``axis`` (default ``"z"``) at ``at`` (``depth``
    for a plane normal to z)."""
    rng = np.random.default_rng(seed)
    planes = []
    for p in spec["planes"]:
        axis = p.get("axis", "z")
        if axis not in AXIS:
            raise ValueError(f"a plane's axis is x, y or z, not {axis!r}")
        th, tw, cu, cv, ppm = _texture_size(p, path_x, fx, h, w)
        n_blocks = max(1, round(160 * (th * tw) / spec.get("block_area", 1200 * 1600)))
        tex = torch.from_numpy(perlin_texture(th, tw, rng, n_blocks=n_blocks)).to(device)
        planes.append(Plane(tex, p["at"] if "at" in p else p["depth"], (cu, cv), ppm, axis))
    return planes


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The port's ``_bilinear_sample`` in torch: 0 outside [0, W-1) x [0, H-1)."""
    h, w = img.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0c = u0.clamp(0, w - 2).long()
    v0c = v0.clamp(0, h - 2).long()
    a, b = img[v0c, u0c], img[v0c, u0c + 1]
    c, e = img[v0c + 1, u0c], img[v0c + 1, u0c + 1]
    out = a * (1 - du) * (1 - dv) + b * du * (1 - dv) + c * (1 - du) * dv + e * du * dv
    inside = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    return torch.where(inside, out, 0.0)


def pinhole_rays(fx, fy, cx, cy, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 camera rays of a pinhole camera, as the port's
    generator casts them."""
    us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return np.stack([(us - np.float32(cx)) / np.float32(fx), (vs - np.float32(cy)) / np.float32(fy),
                     np.ones_like(us)], axis=-1).astype(np.float32)


def lens_rays(cam: dict, h: int, w: int, iters: int = 40) -> np.ndarray:
    """(h, w, 3) float32 rays of a radial-tangential lens: each distorted
    pixel casts the ray of its undistorted normalized position (the plain
    fixed-point inversion of the distortion, float64)."""
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dx, dy = (us - cam["cx"]) / cam["fx"], (vs - cam["cy"]) / cam["fy"]
    k1, k2, k3, p1, p2 = (cam[k] for k in ("k1", "k2", "k3", "p1", "p2"))
    x, y = dx.copy(), dy.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (dx - tx) / radial, (dy - ty) / radial
    return np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)


def render(planes: list[Plane], Tcw: np.ndarray, rays: torch.Tensor,
           with_depth: bool = False):
    """Images (B, H, W) float32 in [0, 255] of the camera poses Tcw (B, 4, 4),
    nearest hit wins; with ``with_depth`` also each pixel's ray parameter at
    its hit (the camera z where the rays have z = 1), inf where nothing is
    hit."""
    dev = rays.device
    T = torch.from_numpy(np.asarray(Tcw, np.float32)).to(dev)
    R, t = T[:, :3, :3], T[:, :3, 3]
    C = -(R.transpose(1, 2) @ t[..., None])[..., 0]                     # (B, 3)
    ray_w = torch.einsum("hwk,bkj->bhwj", rays, R)                      # ray @ R
    B, H, W = ray_w.shape[:3]
    best = torch.full((B, H, W), math.inf, device=dev)
    img = torch.zeros((B, H, W), device=dev)
    for p in planes:
        a, (iu, iv) = AXIS[p.axis], TEX_AXES[p.axis]
        ra = ray_w[..., a]
        ra = torch.where(ra.abs() > 1e-6, ra, 1e-6)
        lam = (p.depth - C[:, a, None, None]) / ra
        U = C[:, None, None, iu] + lam * ray_w[..., iu]
        V = C[:, None, None, iv] + lam * ray_w[..., iv]
        th, tw = p.texture.shape
        tu = (U - p.tex_center[0]) * p.ppm + tw / 2.0
        tv = (V - p.tex_center[1]) * p.ppm + th / 2.0
        hit = (lam > 0.05) & (lam < best)
        img = torch.where(hit, bilinear(p.texture, tu, tv), img)
        best = torch.where(hit, lam, best)
    return (img, best) if with_depth else img


# --- a cell's frames ---------------------------------------------------------------

@dataclass
class Traffic:
    images: np.ndarray           # (N, H, W) uint8, the frames as handed over (the left view)
    gt_Twc: np.ndarray           # (N, 4, 4) the rendered truth
    blank: np.ndarray            # (N,) bool: covered lens
    timestamps: np.ndarray       # (N,) seconds
    warmup_keyframes: int        # the window starts once the map holds this many
    min_warmup_frames: int       # ... and at least this many frames were tracked
    texture_bytes: int = 0       # the worlds' textures on the device
    right_images: np.ndarray | None = None   # (N, H, W) uint8, stereo: the rectified right view
    depths: np.ndarray | None = None         # (N, H, W) float32 meters, RGB-D; 0 where no hit


LENS = ("k1", "k2", "k3", "p1", "p2")


def build_traffic(spec: dict, camera: dict, sensor: str, seed: int, device,
                  n_frames: int | None = None, scale: float = 1.0) -> Traffic:
    """Render a traffic mix for a camera (CameraConfig fields) and sensor.
    ``n_frames`` / ``scale`` shorten the path and shrink the image for the
    CPU tests (the camera's intrinsics scale with the image).

    ``stereo`` also renders the right view of a rectified pair: the left
    camera moved by the baseline ``baseline_times_fx / fx`` along its own x
    axis, with the same pinhole rays (a stereo camera with a lens is
    refused: ORB-SLAM2's stereo takes rectified pairs). ``rgbd`` also gives
    each pixel's depth in meters, 0 where no plane is hit."""
    n = n_frames or spec["frames"]
    h, w = int(round(camera["height"] * scale)), int(round(camera["width"] * scale))
    fx, fy = camera["fx"] * scale, camera["fy"] * scale
    cx, cy = camera["cx"] * scale, camera["cy"] * scale
    blank, s = kidnap_schedule(spec.get("kidnap"), n)
    Twc = path_poses(spec["path"], s)
    world = spec["worlds"][sensor]
    xs = Twc[:, 0, 3]
    planes = make_world(world, fx, h, w, (float(xs.min()), float(xs.max())), seed, device)
    lens = {"fx": fx, "fy": fy, "cx": cx, "cy": cy, **{k: camera.get(k, 0.0) for k in LENS}}
    distorted = any(lens[k] != 0.0 for k in LENS)
    if sensor == "stereo" and distorted:
        raise ValueError("a stereo camera takes rectified pairs: its lens must be zero")
    if distorted:
        rays = lens_rays(lens, h, w)
    else:
        rays = pinhole_rays(fx, fy, cx, cy, h, w)
    rays = torch.from_numpy(rays).to(device)
    Tcw = np.linalg.inv(Twc)
    images = np.empty((n, h, w), np.uint8)
    right = np.empty((n, h, w), np.uint8) if sensor == "stereo" else None
    depths = np.empty((n, h, w), np.float32) if sensor == "rgbd" else None
    Tcw_r = Tcw.copy()
    # the right camera: X_right = X_left - (baseline, 0, 0)
    Tcw_r[:, 0, 3] -= camera.get("baseline_times_fx", 0.0) / camera["fx"]
    for i0 in range(0, n, RENDER_BATCH):
        sl = slice(i0, min(i0 + RENDER_BATCH, n))
        img, lam = render(planes, Tcw[sl], rays, with_depth=True)
        images[sl] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        if depths is not None:
            depths[sl] = torch.where(torch.isfinite(lam), lam, 0.0).cpu().numpy()
        if right is not None:
            right[sl] = render(planes, Tcw_r[sl], rays).clamp(0, 255).to(torch.uint8).cpu().numpy()
    blank_value = (spec.get("kidnap") or {}).get("blank_value", 128)
    images[blank] = blank_value
    if right is not None:
        right[blank] = blank_value
    if depths is not None:
        depths[blank] = 0.0
    return Traffic(images=images, gt_Twc=Twc, blank=blank,
                   timestamps=np.arange(n) / float(camera.get("fps", 30.0)),
                   warmup_keyframes=spec["warmup_keyframes"],
                   min_warmup_frames=spec.get("min_warmup_frames", 0),
                   texture_bytes=sum(p.texture.numel() * p.texture.element_size() for p in planes),
                   right_images=right, depths=depths)
