"""Tensor idioms the JAX reference leans on, written once for the port.

* ``put``: the ``x.at[idx].set/add/min/max(v, mode="drop")`` scatter. Out of
  range indices are dropped, not raised (JAX's "drop" mode): the scatter goes
  into a copy with one sentinel row that is sliced off afterwards, so no
  index ever needs a host-side filter (no device sync). ``put_last`` is
  the set whose indices repeat, resolved as XLA:CPU resolves it.
* ``index_add``: ``x.at[idx].add(v)`` over rows with the same sums on every
  run (the card's ``index_add_`` adds with float atomics).
* ``launched_event`` / ``event_done``: ``is_ready`` polling, as a CUDA event
  recorded after a launch and polled with ``query()``.
* ``topk``: ``jax.lax.top_k`` — ties go to the lower index, which
  ``torch.topk`` does not promise; a stable descending sort does.
* ``fma``: ``a * b + c`` rounded once, the form XLA:CPU emits for a fused
  multiply-add. The exact product of two float32 values fits a float64, so
  the sum rounded to float32 is the fused result.
* ``nanmedian``: numpy/JAX semantics (the mean of the two middle values for
  an even count; ``torch.nanmedian`` returns the lower one).
* ``resolve_device``: the entry points' device argument; ``None`` means the
  card, with no fallback to the CPU.
"""

from __future__ import annotations

import torch


def put(arr: torch.Tensor, idx, vals, op: str = "set") -> torch.Tensor:
    """Return ``arr`` with ``vals`` scattered at ``idx`` (a tensor or a tuple
    of tensors over the leading dims); indices outside ``[0, size)`` drop."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    lead = len(idx)
    shape = arr.shape
    tail = tuple(shape[lead:])
    idx = torch.broadcast_tensors(*[torch.as_tensor(i, device=arr.device) for i in idx])
    ok = torch.ones(idx[0].shape, dtype=torch.bool, device=arr.device)
    lin = torch.zeros(idx[0].shape, dtype=torch.int64, device=arr.device)
    n = 1
    for d, i in enumerate(idx):
        i = i.long()
        ok = ok & (i >= 0) & (i < shape[d])
        lin = lin * shape[d] + i.clamp(0, shape[d] - 1)
        n *= shape[d]
    lin = torch.where(ok, lin, n).reshape(-1)
    flat = arr.reshape((n,) + tail)
    ext = torch.cat([flat, flat.new_zeros((1,) + tail)])
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    vals = vals.broadcast_to(idx[0].shape + tail).reshape((-1,) + tail)
    if op == "set":
        ext.index_put_((lin,), vals)
    elif op == "add":
        ext.index_put_((lin,), vals, accumulate=True)
    elif op in ("min", "max"):
        index = lin.reshape((-1,) + (1,) * len(tail)).expand_as(vals)
        ext.scatter_reduce_(0, index, vals, reduce="a" + op, include_self=True)
    else:
        raise ValueError(op)
    return ext[:n].reshape(shape)


def put_last(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` for a 1-D ``idx`` whose indices
    may repeat: per slot the update at the largest position wins, the order
    XLA:CPU applies them in (``index_put_`` on the card keeps an arbitrary
    one)."""
    n = idx.shape[0]
    pos = put(torch.full((arr.shape[0],), -1, dtype=torch.int64, device=arr.device), idx,
              torch.arange(n, device=arr.device), "max")
    hit = (pos >= 0).reshape((-1,) + (1,) * (arr.dim() - 1))
    return torch.where(hit, vals[pos.clamp(min=0)], arr)


def index_add(out: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, src)``, summed in the same order on every run.
    On the card ``index_add_`` adds with float atomics in the order they land,
    so a sum changes in its last bits from run to run, a BA amplifies that
    and a session parts from its rerun. There the accumulating ``index_put_``
    is used instead: it sorts the rows stably and adds each row's values in
    index order, one after another, so a row that a great many values go to
    is slow. The CPU's ``index_add_`` adds in index order already."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


def launched_event(device: torch.device):
    """A CUDA event recorded after the work just enqueued on ``device``; None
    on the CPU, where that work has already run."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def event_done(ev) -> bool:
    """Readiness of ``launched_event``'s work (JAX's ``is_ready``)."""
    return ev is None or ev.query()


def topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``; ties to the lower
    index, like ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32."""
    d = torch.float64
    a, b, c = (torch.as_tensor(v) for v in (a, b, c))
    return (a.to(d) * b.to(d) + c.to(d)).to(torch.float32)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor (NaN if none)."""
    n = (~torch.isnan(x)).sum()
    s = torch.sort(torch.where(torch.isnan(x), torch.inf, x)).values
    lo = s[((n - 1) // 2).clamp(min=0)]
    hi = s[(n // 2).clamp(max=x.shape[0] - 1)]
    med = torch.where(n % 2 == 1, lo, 0.5 * lo + 0.5 * hi)
    return torch.where(n > 0, med, torch.nan)


def resolve_device(device) -> torch.device:
    """``torch.device("cuda")`` for ``None``, else ``torch.device(device)``:
    the port runs on the card unless the caller asks for the CPU."""
    return torch.device("cuda") if device is None else torch.device(device)
