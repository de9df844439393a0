"""PoseNet-style human keypoint head (port of
weiner_slamit_v2_tpu/models/posenet.py; the reference's TFLite PoseNet,
jni/ORB_SLAM2/src/Posenet.cc, run on every frame in the Frame ctor,
src/Frame.cc:222-232).

* input (B, 257, 257, 3) in [-1, 1], channels last as in the JAX package;
* outputs heatmaps (B, 9, 9, 17), offsets (B, 9, 9, 34), forward and
  backward displacements (B, 9, 9, 32);
* single-pose decoding: per-keypoint heatmap argmax (the first maximum),
  offset refinement, sigmoid confidence (Posenet.cc:499-637).

The parameter file is the JAX package's npz: '/'-joined flax paths
(``params/Conv_0/kernel``, ``params/_DepthwiseSeparable_0/Conv_0/kernel``,
...), kernels HWIO; torch holds them OIHW (a depthwise (3, 3, 1, C) kernel
is (C, 1, 3, 3) with groups=C). ``posenet_model.tflite`` is not in the
repository, so the head runs with random weights drawn as flax draws them
(lecun_normal kernels, zero biases) from a ``torch.Generator``.

flax's ``padding="SAME"`` pads 1 on each side of a 3x3 window at stride 1
at any size, and at stride 2 on every odd size: this net only meets odd
sizes (257, 129, 65, 33, 17, 9), so the convolutions pad 1 explicitly and
``forward`` refuses an even input.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INPUT_SIZE = 257
OUTPUT_STRIDE = 32
N_KEYPOINTS = 17
BLOCKS = ((48, 2), (96, 2), (96, 1), (192, 2), (192, 1), (384, 1), (384, 2))
HEADS = (N_KEYPOINTS, 2 * N_KEYPOINTS, 32, 32)
# lecun_normal's truncated normal: std sqrt(1 / fan_in) over the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

BODY_PARTS = (
    "NOSE", "LEFT_EYE", "RIGHT_EYE", "LEFT_EAR", "RIGHT_EAR",
    "LEFT_SHOULDER", "RIGHT_SHOULDER", "LEFT_ELBOW", "RIGHT_ELBOW",
    "LEFT_WRIST", "RIGHT_WRIST", "LEFT_HIP", "RIGHT_HIP", "LEFT_KNEE",
    "RIGHT_KNEE", "LEFT_ANKLE", "RIGHT_ANKLE",
)  # include/Posenet.h:15-35


class PoseNet(nn.Module):
    """MobileNetV1-style backbone (a 3x3 stride-2 stem, seven depthwise-
    separable blocks) and the four 1x1 PoseNet heads."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 24, 3, stride=2, padding=1)
        blocks, ch = [], 24
        for feats, stride in BLOCKS:
            blocks.append(nn.ModuleList([nn.Conv2d(ch, ch, 3, stride=stride, padding=1, groups=ch),
                                         nn.Conv2d(ch, feats, 1)]))
            ch = feats
        self.blocks = nn.ModuleList(blocks)
        self.heads = nn.ModuleList([nn.Conv2d(ch, n, 1) for n in HEADS])

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) with H and W odd; returns the four heads, each
        (B, h, w, C) channels last."""
        if x.shape[1] % 2 == 0 or x.shape[2] % 2 == 0:
            raise ValueError(f"input {tuple(x.shape)}: SAME padding is written for odd sizes")
        x = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        for dw, pw in self.blocks:
            x = F.relu(pw(F.relu(dw(x))))
        return tuple(h(x).permute(0, 2, 3, 1) for h in self.heads)

    def flax_names(self) -> list[tuple[str, nn.Conv2d]]:
        """(flax path without the leaf, conv) in flax's creation order."""
        out = [("params/Conv_0", self.stem)]
        for i, (dw, pw) in enumerate(self.blocks):
            out += [(f"params/_DepthwiseSeparable_{i}/Conv_0", dw),
                    (f"params/_DepthwiseSeparable_{i}/Conv_1", pw)]
        out += [(f"params/Conv_{i + 1}", h) for i, h in enumerate(self.heads)]
        return out


def _flax_shapes(net: PoseNet) -> dict[str, tuple]:
    shapes = {}
    for name, conv in net.flax_names():
        o, i, kh, kw = conv.weight.shape
        shapes[name + "/kernel"] = (kh, kw, i, o)
        shapes[name + "/bias"] = (o,)
    return shapes


def _ready(net: PoseNet, device) -> PoseNet:
    return net.to(device).eval().requires_grad_(False)


def init_params(generator: torch.Generator, device=None) -> PoseNet:
    """A PoseNet with flax's default initialization: each kernel from a
    normal truncated to +-2 std with std sqrt(1 / fan_in) / 0.8796
    (lecun_normal; fan_in = kh * kw * input channels per group), biases 0;
    drawn on the CPU from ``generator`` in flax's module order."""
    net = PoseNet()
    with torch.no_grad():
        for _, conv in net.flax_names():
            fan_in = conv.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.bias.zero_()
    return _ready(net, torch.device("cpu") if device is None else device)


def params_from_flax(flat: dict, device=None) -> PoseNet:
    """A PoseNet from flax arrays keyed by '/'-joined paths (the npz layout);
    a wrong array count or shape raises ValueError (JAX :104-117)."""
    net = PoseNet()
    want = _flax_shapes(net)
    if len(flat) != len(want):
        raise ValueError(f"posenet params mismatch: {len(flat)} arrays, expected {len(want)}")
    for key, shape in want.items():
        if key not in flat:
            raise ValueError(f"posenet param {key} missing")
        if tuple(np.shape(flat[key])) != shape:
            raise ValueError(f"posenet param {key}: shape {tuple(np.shape(flat[key]))}, expected {shape}")
    with torch.no_grad():
        for name, conv in net.flax_names():
            conv.weight.copy_(torch.from_numpy(np.asarray(flat[name + "/kernel"], np.float32)
                                               .transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(np.asarray(flat[name + "/bias"], np.float32)))
    return _ready(net, torch.device("cpu") if device is None else device)


def save_params(path: str, net: PoseNet) -> None:
    """Write the weights in the JAX package's npz layout (its load_params
    reads them)."""
    out = {}
    for name, conv in net.flax_names():
        out[name + "/kernel"] = conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)
        out[name + "/bias"] = conv.bias.detach().cpu().numpy()
    np.savez(path, **out)


def load_params(path: str, device=None) -> PoseNet:
    """Load a parameter file written by either package's save_params."""
    with np.load(path) as z:
        return params_from_flax({k: z[k] for k in z.files}, device)


@torch.no_grad()
def estimate_single_pose(net: PoseNet, image_rgb: torch.Tensor):
    """One person's 17 keypoints from a (257, 257, 3) image in [0, 255]:
    (positions (17, 2) as (x, y) in input pixels, scores (17,))."""
    x = image_rgb[None] / 127.5 - 1.0
    heatmaps, offsets, _, _ = net(x)
    hm, off = heatmaps[0], offsets[0]
    g = hm.shape[0]
    flat = hm.reshape(-1, N_KEYPOINTS)
    best = torch.argmax(flat, dim=0)          # the first maximum, as jnp.argmax
    by, bx = best // g, best % g
    kp = torch.arange(N_KEYPOINTS, device=hm.device)
    scores = torch.sigmoid(flat[best, kp])
    # offsets: the first 17 channels y, the next 17 x (Posenet.cc:560-590)
    oy = off[by, bx, kp]
    ox = off[by, bx, kp + N_KEYPOINTS]
    yy = by.to(torch.float32) / (g - 1) * INPUT_SIZE + oy
    xx = bx.to(torch.float32) / (g - 1) * INPUT_SIZE + ox
    return torch.stack([xx, yy], dim=1), scores


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s "linear"
    method along one axis (jax/_src/image/scale.py::compute_weight_mat):
    the triangle kernel, widened by the shrink factor when the axis shrinks
    (antialiasing), each column normalized to sum 1, zero for a sample
    outside the input. Built on ``device`` with its float32 rounding."""
    inv = float(np.float32(1.0 / (n_out / n_in)))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / max(inv, 1.0), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def resize_to_input(image_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (257, 257, 3) float32: ``jax.image.resize(..., "linear")``
    as two weight matrices (the frame is not rounded back to integers), the
    gray value in all three channels."""
    H, W = image_gray.shape
    dev = image_gray.device
    small = _resize_weights(H, INPUT_SIZE, dev).T @ (
        image_gray.to(torch.float32) @ _resize_weights(W, INPUT_SIZE, dev))
    return small[..., None].expand(INPUT_SIZE, INPUT_SIZE, 3)


def person_keypoints_for_frame(net: PoseNet, image_gray: torch.Tensor,
                               score_threshold: float = 0.7):
    """The Frame-ctor helper (src/Frame.cc:222-334): resize to 257x257, run
    the head, and return (positions (17, 2) scaled back to frame pixels,
    scores (17,), scores > score_threshold), all on the frame's device."""
    H, W = image_gray.shape
    pos, scores = estimate_single_pose(net, resize_to_input(image_gray))
    # the float32 scale factors as Python scalars: no host-built tensor
    sx, sy = (float(np.float32(v / INPUT_SIZE)) for v in (W, H))
    return torch.stack([pos[:, 0] * sx, pos[:, 1] * sy], dim=1), scores, scores > score_threshold
