"""The front end's ORB settings, frozen from the port's ``config.py``: only
the class the frozen extractor reads. Every default is the ORB-SLAM2 value
it cites."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1024      # ref 1000 (Tracking.cc:148); padded to a power of two
    scale_factor: float = 1.2   # Tracking.cc:150-151
    n_levels: int = 8
    fast_threshold: float = 20.0   # ORBextractor.cc:827 (ini)
    fast_min_threshold: float = 7.0  # ORBextractor.cc:833 (min fallback)
    cell_size: int = 32         # ref uses 30x30 px cells (ORBextractor.cc:784); 32 tiles evenly
    init_features_mult: int = 2  # 2x features during initialization (Tracking.cc:162)
