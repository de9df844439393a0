"""Trajectory files in TUM and KITTI formats (port of
weiner_slamit_v2_tpu/io/trajectory.py: save_tum / save_kitti / load_tum;
System::SaveTrajectoryTUM, src/System.cc:401-454: "timestamp tx ty tz qx qy
qz qw"; SaveTrajectoryKITTI, src/System.cc:493-541: a 3x4 row-major pose per
line)."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..geometry import se3


def save_tum(path: str | os.PathLike, timestamps: Sequence[float], Twc: np.ndarray) -> None:
    """Write camera-to-world poses (N,4,4) in TUM format."""
    Twc = np.asarray(Twc, dtype=np.float64)
    qs = se3.quat_from_rot(torch.from_numpy(Twc[:, :3, :3].astype(np.float32))).numpy()
    with open(path, "w") as f:
        for ts, T, q in zip(timestamps, Twc, qs):
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_kitti(path: str | os.PathLike, Twc: np.ndarray) -> None:
    """Write camera-to-world poses (N,4,4) in KITTI 3x4 row-major format."""
    Twc = np.asarray(Twc, dtype=np.float64)
    with open(path, "w") as f:
        for T in Twc:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")


def load_tum(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (timestamps (N,), Twc (N, 4, 4) float64; the
    rotation from the float32 quaternion, as the JAX package computes it)."""
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 8:
                data.append(vals[:8])
    arr = np.asarray(data, dtype=np.float64)
    R = se3.rot_from_quat(torch.from_numpy(arr[:, 4:8].astype(np.float32))).numpy()
    Twc = np.tile(np.eye(4), (len(arr), 1, 1))
    Twc[:, :3, :3] = R
    Twc[:, :3, 3] = arr[:, 1:4]
    return arr[:, 0], Twc
