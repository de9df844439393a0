"""Map checkpoints: the whole map in one npz file (port of
weiner_slamit_v2_tpu/slam_map/checkpoint.py, the same layout: one array per
``SlamMap`` field, descriptors as uint32, extra arrays under ``extra__<name>``).
A map saved by either package loads into the other. The reference leaves
SaveMap/LoadMap as a TODO (include/System.h:119-121)."""

from __future__ import annotations

import numpy as np

from .convert import map_from_numpy, map_to_numpy
from .types import SlamMap


def save_map(path: str, m: SlamMap, extra: dict | None = None) -> None:
    """Write the map (and optional extra arrays) to an .npz file."""
    data = map_to_numpy(m)
    for k, v in (extra or {}).items():
        data[f"extra__{k}"] = np.asarray(v)
    np.savez_compressed(path, **data)


def load_map(path: str, device=None) -> tuple[SlamMap, dict]:
    """Read a map checkpoint onto ``device`` (the card by default). Returns
    (map, extra arrays)."""
    with np.load(path) as z:
        extra = {k[len("extra__"):]: z[k] for k in z.files if k.startswith("extra__")}
        m = map_from_numpy({k: z[k] for k in z.files if not k.startswith("extra__")}, device)
    return m, extra
