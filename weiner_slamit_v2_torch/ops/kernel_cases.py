"""Inputs that probe the edges of the two kernels, made from numpy seeds.

``chip_smoke.py`` (phases 3-4) and the ``cuda`` tests of
tests/test_torch_kernels.py hold each kernel against its plain version on
every case here. The cases are data, not tests: nothing here checks a
result.
"""

from __future__ import annotations

import numpy as np
import torch


def fast_level_sets(device) -> dict[str, list[torch.Tensor]]:
    """Level lists for ``fast_score_nms_levels``: shapes that are not
    multiples of any tile size, levels narrower than the tile, a level too
    small to hold an interior pixel, a constant image and a checkerboard
    plateau (every NMS tie rule fires)."""
    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    yy, xx = np.mgrid[0:97, 0:131]
    plateau = (((yy // 5) + (xx // 5)) % 2) * 100.0
    plateau[40:60, 50:90] = 100.0
    return {
        "ragged": [t(rng.uniform(0, 255, s)) for s in ((231, 309), (61, 33), (34, 66), (8, 9), (5, 6))],
        "constant": [t(np.full((120, 150), 77.0)), t(np.full((33, 47), 0.0))],
        "checkerboard_plateau": [t(plateau), t(plateau[:31, :65]), t(np.round(rng.uniform(0, 3, (70, 130))))],
    }


def random_matcher_args(B: int, N1: int, N2: int, seed: int, device, win=(3.0, 60.0), near_px=2.0):
    """Random ``windowed_best2`` arguments; every row's predicted position
    lies within ``near_px`` of some column, as projected points do."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 6, (B, N1)).astype(np.int32)
    xy2 = rng.uniform(0, 640, (B, N2, 2)).astype(np.float32)
    near = np.take_along_axis(xy2, rng.integers(0, N2, (B, N1, 1)), axis=1)
    arrays = [
        rng.integers(0, 2**32, (B, N1, 8), dtype=np.uint32).view(np.int32),
        rng.integers(0, 2**32, (B, N2, 8), dtype=np.uint32).view(np.int32),
        rng.random((B, N1)) > 0.1, rng.random((B, N2)) > 0.1,
        (near + rng.normal(0, near_px, (B, N1, 2))).astype(np.float32), xy2,
        rng.uniform(win[0], win[1], (B, N1)).astype(np.float32),
        lo, lo + 1, rng.integers(0, 8, (B, N2)).astype(np.int32),
        rng.uniform(0.2, 1.0, (B, N2)).astype(np.float32),
    ]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def matcher_cases(device) -> list[tuple[str, list[torch.Tensor], float]]:
    """(name, args, chi2_th) for ``windowed_best2``. Argument slots: 0 desc1,
    1 desc2, 2 valid1, 3 valid2, 4 pred_xy, 5 xy2, 6 window, 7 oct_lo,
    8 oct_hi, 9 octave2, 10 chi2_w."""
    cases = []
    f32 = torch.float32

    def add(name, args, ths=(0.0, 5.991)):
        for th in ths:
            cases.append((f"{name}/th={th}", [a.contiguous() for a in args], th))

    # columns on an exact lattice (cell borders of any power-of-two grid over
    # [0, 640]) and rows on the same lattice with |du| == win for some columns
    a = random_matcher_args(2, 300, 1024, 1, device)
    g = torch.arange(1024, device=device)
    a[5] = torch.stack([(g % 32).to(f32) * 20.0, (g // 32).to(f32) * 15.0], -1)[None].repeat(2, 1, 1)
    r = torch.arange(300, device=device)
    a[4] = torch.stack([(r % 32).to(f32) * 20.0 + (r % 3).to(f32) * 10.0,
                        (r % 29).to(f32) * 15.0], -1)[None].repeat(2, 1, 1)
    a[6] = torch.tensor([20.0, 10.0, 15.0, 30.0], device=device)[r % 4][None].repeat(2, 1)
    a[7], a[8] = torch.zeros_like(a[7]), torch.full_like(a[8], 7)
    add("cell_borders_and_du_equals_win", a, (-1.0, 0.0, 5.991, 1e4))

    # windows: <= 0, -0.0, NaN, +inf, -inf, huge; predictions NaN / +-inf
    a = random_matcher_args(3, 256, 777, 2, device)
    w = a[6].clone()
    w[:, 0:10] = 0.0
    w[:, 10:20] = -5.0
    w[:, 20:30] = -0.0
    w[:, 30:40] = float("nan")
    w[:, 40:60] = float("inf")
    w[:, 60:70] = -float("inf")
    w[:, 70:80] = 3e38
    a[6] = w
    p = a[4].clone()
    p[:, 80:90, 0] = float("nan")
    p[:, 90:100, 1] = float("inf")
    p[:, 100:110, 0] = -float("inf")
    p[:, 110:120] = 1e30
    p[:, 45:50, 1] = float("nan")      # infinite window with a NaN prediction
    a[4] = p
    add("nonfinite_windows_and_predictions", a)

    # columns outside the image, far away, or non-finite
    a = random_matcher_args(2, 400, 1024, 3, device)
    x = a[5].clone()
    x[:, 0:50] -= 700.0
    x[:, 50:100] += 700.0
    x[:, 100:110, 0] = float("nan")
    x[:, 110:120, 1] = float("inf")
    x[:, 120:130, 0] = -float("inf")
    x[:, 130:140] = 3e38
    x[:, 140:150] = -3e38
    a[5] = x
    a[4][:, :40] = x[:, :40] + 0.5        # rows aimed at outside columns
    a[6][:, 300:320] = float("inf")
    add("columns_outside_image", a)

    a = random_matcher_args(2, 128, 777, 4, device)
    a[2] = torch.zeros_like(a[2])
    add("all_rows_invalid", a)
    a = random_matcher_args(2, 128, 777, 5, device)
    a[3] = torch.zeros_like(a[3])
    add("all_columns_invalid", a)

    # duplicate columns: the tie goes to the smaller j
    a = random_matcher_args(2, 512, 1024, 6, device)
    for s in (1, 5, 9):
        for k in (1, 3, 5, 9, 10):
            a[k][:, s::16] = a[k][:, 0::16][:, : a[k][:, s::16].shape[1]]
    a[3][:, 0::16] = True
    add("duplicate_columns", a)

    # one column; every column at one point (a zero-extent grid); N2 larger
    # than one staged chunk
    add("n2_is_1", random_matcher_args(3, 200, 1, 7, device, win=(1e3, 1e4)))
    a = random_matcher_args(2, 200, 300, 8, device)
    a[5] = torch.full_like(a[5], 123.25)
    a[4] = a[5][:, :1].expand(2, 200, 2) + torch.linspace(-2, 2, 200, device=device)[None, :, None]
    add("all_columns_at_one_point", a)
    add("n2_larger_than_a_chunk", random_matcher_args(2, 300, 5000, 9, device))
    add("fuse_like_small_windows", random_matcher_args(4, 1024, 1024, 10, device, win=(3.0, 10.75)))
    return cases
