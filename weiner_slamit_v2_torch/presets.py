"""Per-dataset calibration presets (a copy of weiner_slamit_v2_tpu/presets.py:
the port imports nothing of the JAX package).

The reference hardcodes ONE device's calibration (Google Pixel 4, the
HARDCODE block at jni/ORB_SLAM2/src/Tracking.cc:76-105) because its YAML
reader broke on-device; running any public dataset through it uses wrong
intrinsics. Here every supported dataset family gets a named preset with the
standard published calibration (the same numbers ORB-SLAM2's example YAMLs
ship for these datasets); `preset(name)` returns a ready SlamConfig and the
CLI exposes `--preset`.
"""

from __future__ import annotations

import dataclasses

from .config import CameraConfig, SlamConfig, TrackingConfig

# name -> CameraConfig kwargs
_CAMERAS: dict[str, dict] = {
    # the reference's own hardcoded device (Tracking.cc:76-105)
    "pixel4": dict(
        fx=526.69, fy=540.36, cx=313.07, cy=238.39,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480, fps=30.0,
    ),
    # TUM RGB-D freiburg1/2/3 (standard dataset calibration)
    "tum_fr1": dict(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480, fps=30.0,
        baseline_times_fx=40.0, depth_threshold=40.0, depth_map_factor=5000.0,
    ),
    "tum_fr2": dict(
        fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
        k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205,
        width=640, height=480, fps=30.0,
        baseline_times_fx=40.0, depth_threshold=40.0, depth_map_factor=5208.0,
    ),
    "tum_fr3": dict(
        fx=535.4, fy=539.2, cx=320.1, cy=247.6,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=640, height=480, fps=30.0,
        baseline_times_fx=40.0, depth_threshold=40.0, depth_map_factor=5000.0,
    ),
    # KITTI odometry grayscale (sequences 00-02, 03, 04-12)
    "kitti_00": dict(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=1241, height=376, fps=10.0,
        baseline_times_fx=386.1448, depth_threshold=135.0,
    ),
    "kitti_03": dict(
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=1241, height=376, fps=10.0,
        baseline_times_fx=387.5744, depth_threshold=135.0,
    ),
    "kitti_04": dict(
        fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=1226, height=370, fps=10.0,
        baseline_times_fx=379.8145, depth_threshold=135.0,
    ),
    # EuRoC MAV cam0
    "euroc": dict(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, k3=0.0,
        width=752, height=480, fps=20.0,
        baseline_times_fx=47.90639384, depth_threshold=35.0,
    ),
}

# aliases: dataset-kind defaults and KITTI sequence ranges. Only ranges with
# a shared published calibration are aliased (00-02 and 04-12, the ranges
# ORB-SLAM2 ships KITTI00-02/KITTI04-12.yaml for). Test sequences 13-21 come
# from multiple recording dates with differing intrinsics — the CLI reads
# the sequence's own calib.txt for those (io/datasets.load_kitti_calib)
# instead of silently applying a wrong preset.
_ALIASES = {
    "tum": "tum_fr1",
    "kitti": "kitti_00",
    **{f"kitti_{i:02d}": "kitti_00" for i in (1, 2)},
    **{f"kitti_{i:02d}": "kitti_04" for i in range(5, 13)},
}


def preset_names() -> list[str]:
    return sorted(set(_CAMERAS) | set(_ALIASES))


def preset(name: str, **overrides) -> SlamConfig:
    """SlamConfig with the named dataset calibration. Extra keyword args
    override top-level SlamConfig fields (e.g. orb=..., capacity=...)."""
    key = _ALIASES.get(name, name)
    if key not in _CAMERAS:
        raise KeyError(f"unknown preset {name!r}; choose from {preset_names()}")
    cam = CameraConfig(**_CAMERAS[key])
    cfg = SlamConfig(camera=cam, **overrides)
    # mMaxFrames = fps (Tracking.cc:123-131)
    tracking = dataclasses.replace(
        cfg.tracking, max_frames_between_kf=int(cam.fps)
    )
    return cfg.replace(tracking=tracking)
