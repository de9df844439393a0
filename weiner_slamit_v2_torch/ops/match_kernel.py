"""Kernel B: gated windowed Hamming best/second matcher, batched over
targets (replaces the Pallas kernel
weiner_slamit_v2_tpu/ops/match_pallas.py::windowed_best2_pallas, whose
call site vmaps it over fuse targets; here the batch is a leading dim).

``windowed_best2`` is the wrapper: a CPU tensor takes ``windowed_best2_plain``,
a CUDA tensor launches csrc/windowed_best2.cu (or raises). ``launches``
counts kernel launches. Descriptors are int32 bit patterns (N, 8).
"""

from __future__ import annotations

import torch

from . import cuda_build
from .hamming import INVALID_DIST, distance_matrix

launches = 0


def windowed_best2_plain(desc1, desc2, valid1, valid2, pred_xy, xy2, window,
                         oct_lo, oct_hi, octave2, chi2_w, chi2_th: float):
    """Batched plain twin. Shapes: desc1 (B,N1,8) desc2 (B,N2,8) int32;
    valid1 (B,N1) valid2 (B,N2) bool; pred_xy (B,N1,2) xy2 (B,N2,2) f32;
    window (B,N1) f32; oct_lo/oct_hi (B,N1) i32; octave2 (B,N2) i32;
    chi2_w (B,N2) f32; chi2_th <= 0 disables the chi2 gate.
    Returns (best_idx, best_dist, second_dist), each (B, N1) int32."""
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


def windowed_best2(desc1, desc2, valid1, valid2, pred_xy, xy2, window,
                   oct_lo, oct_hi, octave2, chi2_w, chi2_th: float):
    """Kernel wrapper; same arguments and results as windowed_best2_plain."""
    global launches
    args = (desc1, desc2, valid1, valid2, pred_xy, xy2, window, oct_lo, oct_hi,
            octave2, chi2_w)
    dev = desc1.device
    B, N1 = desc1.shape[:2]
    N2 = desc2.shape[1]
    spec = {
        "desc1": (torch.int32, (B, N1, 8)), "desc2": (torch.int32, (B, N2, 8)),
        "valid1": (torch.bool, (B, N1)), "valid2": (torch.bool, (B, N2)),
        "pred_xy": (torch.float32, (B, N1, 2)), "xy2": (torch.float32, (B, N2, 2)),
        "window": (torch.float32, (B, N1)), "oct_lo": (torch.int32, (B, N1)),
        "oct_hi": (torch.int32, (B, N1)), "octave2": (torch.int32, (B, N2)),
        "chi2_w": (torch.float32, (B, N2)),
    }
    for (name, (dtype, shape)), t in zip(spec.items(), args):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"windowed_best2: {name} must be a {dtype} {shape} tensor on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if dev.type == "cpu":
        return windowed_best2_plain(*args, chi2_th)
    if dev.type != "cuda" or not all(t.is_contiguous() for t in args):
        raise ValueError(f"windowed_best2: needs contiguous CUDA or CPU tensors, got {dev}")
    if min(B, N1, N2) == 0:
        raise ValueError(f"windowed_best2: empty problem {(B, N1, N2)}")
    outs = [torch.empty((B, N1), dtype=torch.int32, device=dev) for _ in range(3)]
    # C order: the row data (d1, v1, pxy, win, lo, hi), the column data (d2,
    # v2, xy2, oct2, w2), th, chi2_on, the outputs (best_idx, best_dist,
    # second_dist), B, N1, N2, stream
    row_col = (desc1, valid1, pred_xy, window, oct_lo, oct_hi, desc2, valid2, xy2, octave2, chi2_w)
    chi2_on = chi2_th > 0   # decided in double precision, as the plain version does
    err = cuda_build.lib().windowed_best2_launch(
        *(t.data_ptr() for t in row_col), float(chi2_th) if chi2_on else 0.0, int(chi2_on),
        *(o.data_ptr() for o in outs), B, N1, N2,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "windowed_best2")
    launches += 1
    return tuple(outs)
