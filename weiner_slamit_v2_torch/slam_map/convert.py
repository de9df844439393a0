"""State carried between the JAX package and the port, as numpy arrays.

``map_from_numpy`` / ``map_to_numpy`` go field by field with the names of
weiner_slamit_v2_tpu/slam_map/checkpoint.py (a JAX map checkpoint npz loads
directly); ``features_from_numpy`` does the same for ``FrameFeatures``.
Descriptors are uint32 on the JAX side and int32 bit patterns in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..frontend.extractor import FrameFeatures
from ..util import resolve_device
from .types import SlamMap

_DESC_FIELDS = ("kf_desc", "mp_desc", "desc")


def _to_torch(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS:
        a = np.ascontiguousarray(a).view(np.int32)
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def map_from_numpy(arrays: dict, device=None) -> SlamMap:
    """SlamMap from a dict (or npz) of numpy arrays named like its fields."""
    return SlamMap(**{
        f.name: _to_torch(f.name, arrays[f.name], device) for f in dataclasses.fields(SlamMap)
    })


def map_to_numpy(m: SlamMap) -> dict[str, np.ndarray]:
    """Field-by-field numpy arrays; descriptors back to uint32."""
    out = {}
    for f in dataclasses.fields(m):
        a = getattr(m, f.name).detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    return out


def features_from_numpy(feats, device=None) -> FrameFeatures:
    """FrameFeatures from any object (or dict) with the same field names."""
    get = feats.__getitem__ if isinstance(feats, dict) else lambda k: getattr(feats, k)
    return FrameFeatures(**{
        f.name: _to_torch(f.name, get(f.name), device) for f in dataclasses.fields(FrameFeatures)
    })
