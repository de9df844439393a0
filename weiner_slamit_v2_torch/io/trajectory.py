"""Trajectory export in TUM and KITTI formats (port of
weiner_slamit_v2_tpu/io/trajectory.py::save_tum / save_kitti;
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
