"""Kernel A: fused FAST score + 3x3 NMS (replaces the Pallas kernel
weiner_slamit_v2_tpu/ops/fast_pallas.py::fast_score_nms_pallas).

``fast_score_nms`` is the wrapper the extractor calls at every pyramid level:
a CPU tensor takes the plain version, a CUDA tensor launches
csrc/fast_score_nms.cu (or raises). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .fast import fast_score, nms_3x3

launches = 0


def fast_score_nms_plain(image: torch.Tensor) -> torch.Tensor:
    """Plain twin: NMS'd FAST score at threshold 0 (3-px border is 0)."""
    return nms_3x3(fast_score(image, 0.0))


def fast_score_nms(image: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 level image -> (H, W) NMS'd FAST-9/16 score map."""
    global launches
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            f"fast_score_nms: needs a 2-D float32 tensor, got {image.dtype} {tuple(image.shape)}")
    if image.device.type == "cpu":
        return fast_score_nms_plain(image)
    if image.device.type != "cuda" or not image.is_contiguous():
        raise ValueError(f"fast_score_nms: needs a contiguous CUDA or a CPU tensor, got "
                         f"{image.device} contiguous={image.is_contiguous()}")
    h, w = image.shape
    out = torch.empty_like(image)
    err = cuda_build.lib().fast_score_nms_launch(
        image.data_ptr(), out.data_ptr(), h, w,
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    cuda_build.check(err, "fast_score_nms")
    launches += 1
    return out
