"""Configuration system: dataclasses + YAML (PyTorch port).

A copy of weiner_slamit_v2_tpu/config.py: importing that package pulls in
JAX, and its module-level ``import yaml`` is not available everywhere the
port runs, so ``yaml`` is imported inside load_config/save_config only.

Replaces the reference's broken-on-device ``cv::FileStorage`` YAML reader and
its HARDCODE fallbacks (jni/ORB_SLAM2/src/Tracking.cc:76-105,148-153 — see
SURVEY.md §5 "Config/flag system"). Every algorithm constant the reference
hardcodes is a field here with the reference value as default (SURVEY.md
Appendix A is the source of truth for the numbers).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 526.69          # Tracking.cc:77-80 (HARDCODE block)
    fy: float = 540.36
    cx: float = 313.07
    cy: float = 238.39
    k1: float = 0.262383        # Tracking.cc:100-105
    k2: float = -0.953104
    p1: float = -0.005358
    p2: float = 0.002628
    k3: float = 1.163314
    width: int = 640
    height: int = 480
    fps: float = 30.0           # Tracking.cc:123-131
    baseline_times_fx: float = 0.0  # "Camera.bf" for stereo/RGB-D
    depth_threshold: float = 35.0   # ThDepth * baseline (stereo far-point gate)
    depth_map_factor: float = 5000.0  # TUM RGB-D depth scaling


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1024      # ref 1000 (Tracking.cc:148); padded to a power of two
    scale_factor: float = 1.2   # Tracking.cc:150-151
    n_levels: int = 8
    fast_threshold: float = 20.0   # ORBextractor.cc:827 (ini)
    fast_min_threshold: float = 7.0  # ORBextractor.cc:833 (min fallback)
    cell_size: int = 32         # ref uses 30x30 px cells (ORBextractor.cc:784); 32 tiles evenly
    init_features_mult: int = 2  # 2x features during initialization (Tracking.cc:162)


@dataclass(frozen=True)
class MatcherConfig:
    th_low: int = 50            # ORBmatcher.cc:37
    th_high: int = 100          # ORBmatcher.cc:38
    histo_length: int = 30      # ORBmatcher.cc:39
    nn_ratio_motion: float = 0.9     # Tracking.cc:1096
    nn_ratio_refkf: float = 0.7      # Tracking.cc:984
    nn_ratio_bow: float = 0.75       # Tracking.cc:1649 / LoopClosing.cc:255
    nn_ratio_triangulation: float = 0.6  # LocalMapping.cc:235
    nn_ratio_localmap: float = 0.8   # Tracking.cc:1451


@dataclass(frozen=True)
class TrackingConfig:
    init_min_keypoints: int = 100   # Tracking.cc:757
    init_min_matches: int = 100     # Tracking.cc:800-803
    init_window: float = 100.0      # search window px (Tracking.cc:799)
    min_matches_refkf: int = 15     # Tracking.cc:989
    min_matches_motion: int = 20    # Tracking.cc:1125
    # post-optimization inlier floor — 10 on BOTH the motion-model and
    # ref-KF paths (Tracking.cc:1023, :1160)
    min_inliers_motion: int = 10
    min_inliers_localmap: int = 30  # Tracking.cc:1206
    min_inliers_localmap_reloc: int = 50  # Tracking.cc:1200
    motion_search_window: float = 15.0    # mono th (Tracking.cc:1108)
    local_map_kf_cap: int = 80      # Tracking.cc:1572
    keyframe_min_ratio: float = 0.9  # NeedNewKeyFrame c2 (Tracking.cc:1278)
    max_frames_between_kf: int = 30  # mMaxFrames = fps (Tracking.cc:123)
    min_frames_between_kf: int = 0   # mMinFrames (Tracking.cc:124)
    reloc_min_inliers: int = 50     # Tracking.cc:1816
    auto_reset_max_kfs: int = 5     # Tracking.cc:649
    # Minimum frames the mapper is considered busy after a keyframe — the
    # synchronous-device analogue of the reference's LocalMapping thread
    # latency that gates c1b (bLocalMappingIdle, Tracking.cc:1267). The
    # reference mapper takes ~3-10 camera frames per keyframe on its target
    # hardware; c1a still forces insertion past max_frames_between_kf.
    mapping_latency_frames: int = 3
    # Frames tracked per device->host synchronization. 1 = resolve the
    # state machine every frame (fully deterministic, the reference's
    # synchronous Track() semantics). N>1 pipelines N fused steps on the
    # device and resolves LOST/keyframe decisions up to N-1 frames late —
    # the decisions the reference's own async threads also make late. The
    # port launches each batch with no host synchronization and resolves it
    # one batch later (tracking/tracker.py).
    frames_per_sync: int = 1
    # With frames_per_sync > 1, resolve every frame anyway until the map has
    # this many keyframes: keyframe-timing lateness hurts exactly while the
    # map is young; a mature map tolerates it (the reference's asynchronous
    # mapper imposes the same lateness on keyframe processing).
    pipeline_warmup_kfs: int = 8
    # Abortable local BA (mbAbortBA — src/LocalMapping.cc:127,681-684): the
    # mapping pass runs as separate stage programs (structure pass, LM
    # chunks of ba_chunk_iters, write-back) so a forced keyframe insertion
    # (c1a/c1c) skips the not-yet-issued chunks and adopts best-so-far
    # instead of blocking on the full LM schedule. False = one fused
    # mapping pass (uninterruptible).
    abortable_ba: bool = True
    ba_chunk_iters: int = 5


@dataclass(frozen=True)
class MappingConfig:
    culling_found_ratio: float = 0.25   # LocalMapping.cc:190
    culling_min_obs: int = 3            # obs<=2 culled (mono) LocalMapping.cc:199
    triangulation_neighbors: int = 20   # LocalMapping.cc:224 (mono nn)
    min_baseline_depth_ratio: float = 0.01  # LocalMapping.cc:278
    kf_culling_redundancy: float = 0.9  # LocalMapping.cc:689
    kf_culling_min_obs: int = 3         # seen by >=3 other KFs
    chi2_mono: float = 5.991            # 2-dof 95% gate used everywhere
    chi2_stereo: float = 7.815


@dataclass(frozen=True)
class LoopConfig:
    min_kfs_between_loops: int = 10     # LoopClosing.cc:124
    covisibility_consistency_th: int = 3  # LoopClosing.cc:50
    min_bow_matches: int = 20           # LoopClosing.cc:283
    min_sim3_inliers: int = 20          # LoopClosing.cc:374
    min_total_matches: int = 40         # LoopClosing.cc:401
    essential_min_covis_weight: int = 100  # Optimizer.cc:794 (minFeat)
    sim3_chi2: float = 10.0             # OptimizeSim3 th2 (Optimizer.cc:1100)


@dataclass(frozen=True)
class OptimConfig:
    pose_opt_rounds: int = 4        # Optimizer.cc:300 (4 rounds)
    pose_opt_iters: int = 10        # 10 LM iters each
    local_ba_iters1: int = 5        # Optimizer.cc:626
    local_ba_iters2: int = 10       # Optimizer.cc:672
    global_ba_iters: int = 20       # LoopClosing.cc:662
    essential_graph_iters: int = 20  # Optimizer.cc:987
    # Huber deltas are sqrt(chi2_mono) / sqrt(chi2_stereo) everywhere in the
    # reference (Optimizer.cc:287,295) — derived from MappingConfig.chi2_*,
    # not separate knobs.
    lm_lambda_init: float = 1e-4
    essential_lambda_init: float = 1e-16  # Optimizer.cc:806


@dataclass(frozen=True)
class MapCapacityConfig:
    """Static array capacities (fixed-capacity pools; SURVEY.md §7 hard part b)."""

    max_keyframes: int = 256
    max_map_points: int = 16384
    max_obs_per_point: int = 32
    # Local BA extent: the reference optimizes all covisible keyframes
    # (typically 10-30 on TUM-scale maps) + fixed boundary cameras. 16+16
    # cam slots and 2048 point slots cover that while keeping the per-KF
    # solve ~2x cheaper than the previous 32/4096 bounds.
    local_ba_window: int = 16   # max active cams in a local BA solve
    local_ba_points: int = 2048  # max points in a local BA solve


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    capacity: MapCapacityConfig = field(default_factory=MapCapacityConfig)
    sensor: str = "monocular"   # monocular | stereo | rgbd
    seed: int = 0               # replaces DUtils::Random::SeedRandOnce(0)
    # Pre-trained DBoW2-format vocabulary (the ORBvoc.txt the reference
    # loads at src/System.cc:124-129); None = train online from keyframes
    vocabulary_path: str | None = None

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


def _build(cls, data: dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
            "camera", "orb", "matcher", "tracking", "mapping", "loop",
            "optim", "capacity",
        ):
            sub = {
                "camera": CameraConfig, "orb": OrbConfig,
                "matcher": MatcherConfig, "tracking": TrackingConfig,
                "mapping": MappingConfig, "loop": LoopConfig,
                "optim": OptimConfig, "capacity": MapCapacityConfig,
            }[f.name]
            kwargs[f.name] = _build(sub, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path: str) -> SlamConfig:
    """Load a YAML config file; missing keys fall back to reference defaults."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _build(SlamConfig, data)


def save_config(cfg: SlamConfig, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
