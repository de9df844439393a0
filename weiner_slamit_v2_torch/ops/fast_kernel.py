"""Kernel A: fused FAST score + 3x3 NMS over all pyramid levels of a frame
(replaces the Pallas kernel
weiner_slamit_v2_tpu/ops/fast_pallas.py::fast_score_nms_pallas).

``fast_score_nms_levels`` is the wrapper the extractor calls once per frame:
CPU tensors take the plain version level by level, CUDA tensors launch
csrc/fast_score_nms.cu once for every level (or raise). ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .fast import fast_score, nms_3x3

launches = 0
MAX_LEVELS = 16   # csrc/fast_score_nms.cu MAX_LEVELS


def fast_score_nms_plain(image: torch.Tensor) -> torch.Tensor:
    """Plain twin: NMS'd FAST score at threshold 0 (3-px border is 0)."""
    return nms_3x3(fast_score(image, 0.0))


def fast_score_nms_levels_plain(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    return [fast_score_nms_plain(img) for img in levels]


def fast_score_nms_levels(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """(H_l, W_l) float32 level images -> their NMS'd FAST-9/16 score maps,
    one launch for all levels (the outputs are views of one allocation)."""
    global launches
    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_score_nms_levels: needs 1..{MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    for img in levels:
        if img.dtype != torch.float32 or img.dim() != 2 or img.device != dev:
            raise ValueError(f"fast_score_nms_levels: needs 2-D float32 tensors on one device, "
                             f"got {img.dtype} {tuple(img.shape)} on {img.device}")
    if dev.type == "cpu":
        return fast_score_nms_levels_plain(levels)
    if dev.type != "cuda" or not all(img.is_contiguous() for img in levels):
        raise ValueError(f"fast_score_nms_levels: needs contiguous CUDA or CPU tensors, got {dev}")
    sizes = [img.numel() for img in levels]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = [v.view(img.shape) for v, img in zip(flat.split(sizes), levels)]
    if sum(sizes) == 0:
        return outs
    n = len(levels)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))  # noqa: E731
    ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
    # C order: n_levels, imgs[], outs[], heights[], widths[], stream
    err = cuda_build.lib().fast_score_nms_levels_launch(
        n, ptrs(levels), ptrs(outs), ints(img.shape[0] for img in levels),
        ints(img.shape[1] for img in levels), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "fast_score_nms_levels")
    launches += 1
    return outs


def fast_score_nms(image: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 level image -> (H, W) NMS'd FAST-9/16 score map."""
    return fast_score_nms_levels([image])[0]
