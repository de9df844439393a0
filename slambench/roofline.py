"""The yardstick of the kernels' roofline shares: the published peaks of one
NVIDIA H100 SXM (data sheet, dense, at the 700 W limit) and the operations
and bytes that each kernel call's own inputs need, whatever implements them
(the counts of the port's PERF.md kernel table, worked out in
``chip_smoke.py``).

A share is the least time the chip could take for the calls (the larger of
bytes over bandwidth and operations over the float32 rate) over their time
on the device, as a percentage.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# kernel A per pixel: 2 x 57 arc min/max, 2 subtractions, the polarity max,
# the threshold, 8 NMS compares and the select; a float32 read and write
FAST_OPS_PER_PX = 127
FAST_BYTES_PER_PX = 8

# kernel B: gate operations per (valid row, column in its window) pair, and
# the XOR/popcount/add work of a pair that passes every gate
GATE_OPS_PER_PAIR = 8
DIST_OPS_PER_PAIR = 24
# a usable row (valid1, a window > 0, a finite prediction) reads its
# descriptor, flag, xy, window and octave range and writes 3 ints; a row with
# valid1 but no usable window reads its flag, xy and window and writes; a row
# without valid1 reads its flag and writes. A valid column is read whole, any
# other only for its flag
ROW_BYTES = 32 + 1 + 8 + 4 + 4 + 4 + 12
ROW_UNUSABLE_BYTES = 1 + 8 + 4 + 12
ROW_INVALID_BYTES = 1 + 12
COL_BYTES, COL_INVALID_BYTES = 32 + 1 + 8 + 4 + 4, 1


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def fast_pixels(level_shapes: list[tuple[int, int]]) -> int:
    return sum(h * w for h, w in level_shapes)


def fast_call_seconds(level_shapes: list[tuple[int, int]]) -> float:
    """Kernel A, one call over a frame's pyramid."""
    px = fast_pixels(level_shapes)
    return least_seconds(FAST_BYTES_PER_PX * px, FAST_OPS_PER_PX * px)


def best2_counts(args, chi2_th: float) -> tuple[int, int]:
    """(bytes, operations) kernel B's call with these inputs needs."""
    _, _, v1, v2, pxy, xy2, win, lo, hi, o2, w2 = args
    B, N1, N2 = v1.shape[0], v1.shape[1], v2.shape[1]
    usable = v1 & (win > 0) & torch.isfinite(pxy).all(-1)
    n_rows, n_use, n_cols = int(v1.sum()), int(usable.sum()), int(v2.sum())
    n_bytes = (n_use * ROW_BYTES + (n_rows - n_use) * ROW_UNUSABLE_BYTES
               + (B * N1 - n_rows) * ROW_INVALID_BYTES
               + n_cols * COL_BYTES + (B * N2 - n_cols) * COL_INVALID_BYTES)
    du = xy2[:, None, :, 0] - pxy[:, :, None, 0]
    dv = xy2[:, None, :, 1] - pxy[:, :, None, 1]
    box = (du.abs() < win[..., None]) & (dv.abs() < win[..., None]) & v2[:, None, :] & v1[..., None]
    n_box = int(box.sum())
    o = o2[:, None, :]
    gate = box & (o >= lo[..., None]) & (o <= hi[..., None])
    if chi2_th > 0:
        gate &= (du * du + dv * dv) * w2[:, None, :] <= chi2_th
    return n_bytes, GATE_OPS_PER_PAIR * n_box + DIST_OPS_PER_PAIR * int(gate.sum())


def best2_call_seconds(args, chi2_th: float) -> float:
    return least_seconds(*best2_counts(args, chi2_th))
