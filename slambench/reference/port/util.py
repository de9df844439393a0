"""Tensor idioms the JAX reference leans on, written once for the port.

* ``topk``: ``jax.lax.top_k`` — ties go to the lower index, which
  ``torch.topk`` does not promise; a stable descending sort does.
* ``fma``: ``a * b + c`` rounded once, the form XLA:CPU emits for a fused
  multiply-add. The exact product of two float32 values fits a float64, so
  the sum rounded to float32 is the fused result.
* ``device_const``: a constant tensor built once per device. A tensor built
  from host data on every call is a copy from pageable memory and a stream
  synchronization on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

_CONSTS: dict = {}


def device_const(key, device, make: Callable):
    """``make(device)``, built on the first call for (key, device) and
    returned as is afterwards. The result is shared: callers never write to
    it."""
    k = (key, torch.device(device))
    if k not in _CONSTS:
        _CONSTS[k] = make(torch.device(device))
    return _CONSTS[k]


def topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``; ties to the lower
    index, like ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def fma(a, b, c, value: float = 1.0) -> torch.Tensor:
    """``value * a * b + c`` (value 1 or -1) with one rounding to float32.
    With float32 tensors a and b it is one float64 ``addcmul``: the operands
    widen inside the kernel, their product is exact, and only the sum rounds
    (three launches where the general form below takes six)."""
    d = torch.float64
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and isinstance(c, torch.Tensor)
            and a.dtype == b.dtype == torch.float32):
        return torch.addcmul(c.to(d), a, b, value=value).to(torch.float32)
    a, b, c = (torch.as_tensor(v) for v in (a, b, c))
    return (value * a.to(d) * b.to(d) + c.to(d)).to(torch.float32)
