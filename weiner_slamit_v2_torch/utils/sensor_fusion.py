"""IMU sensor-fusion helpers (port of
weiner_slamit_v2_tpu/utils/sensor_fusion.py; the reference app's
ORBSLAMForCameraModeActivity.java:126-202, 409-456, 807-896). The SLAM core
never uses them; they are priors for the constant-velocity model or a
metric scale."""

from __future__ import annotations

import torch


def rotation_from_gravity_magnetic(gravity: torch.Tensor, geomagnetic: torch.Tensor) -> torch.Tensor:
    """World->device rotation from a gravity and a magnetic field vector, as
    Android's SensorManager.getRotationMatrix builds it (rows east, north,
    up). Batched over leading dims."""
    g = gravity / torch.clamp(torch.linalg.norm(gravity, dim=-1, keepdim=True), min=1e-9)
    e = torch.linalg.cross(geomagnetic, g)       # east = m x g
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-9)
    n = torch.linalg.cross(g, e)                 # north = g x east
    return torch.stack([e, n, g], dim=-2)


def integrate_verlet(pos: torch.Tensor, vel: torch.Tensor, accel: torch.Tensor,
                     dt: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One velocity-Verlet step (the Java integrator at :126-150)."""
    return pos + vel * dt + 0.5 * accel * dt * dt, vel + accel * dt


def integrate_accel_sequence(accels: torch.Tensor, dt: float, pos0=None,
                             vel0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate a (T, 3) acceleration sequence step by step: (positions
    (T, 3), velocities (T, 3))."""
    p = torch.zeros(3, dtype=accels.dtype, device=accels.device) if pos0 is None else pos0
    v = torch.zeros(3, dtype=accels.dtype, device=accels.device) if vel0 is None else vel0
    ps, vs = [], []
    for a in accels:
        p, v = integrate_verlet(p, v, a, dt)
        ps.append(p)
        vs.append(v)
    return torch.stack(ps), torch.stack(vs)


def metric_scale_from_walk(slam_positions: torch.Tensor, walked_meters: float) -> torch.Tensor:
    """The app's "2 m walk" scale calibration (:409-456): the SLAM-unit
    distance between the first and last positions maps to walked_meters."""
    d = torch.linalg.norm(slam_positions[-1] - slam_positions[0])
    return walked_meters / torch.clamp(d, min=1e-9)
