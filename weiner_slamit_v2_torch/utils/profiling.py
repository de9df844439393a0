"""Per-stage timing and device traces (port of
weiner_slamit_v2_tpu/utils/profiling.py: ``jax.block_until_ready`` becomes
``torch.cuda.synchronize`` on the tensor's card, ``jax.profiler`` becomes
``torch.profiler``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _synchronize(block_on) -> None:
    """Wait for the card of every CUDA tensor in ``block_on`` (a tensor or a
    nested tuple/list/dict of them); CPU tensors are already done."""
    if torch.is_tensor(block_on):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (tuple, list)):
        for v in block_on:
            _synchronize(v)


class StageTimer:
    """Host time per named stage; with ``block_on`` the stage ends only when
    the card has computed it, so the numbers are work, not enqueue."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": round(self.totals[k], 4), "count": self.counts[k],
                "mean_ms": round(1000.0 * self.totals[k] / max(self.counts[k], 1), 3)}
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = [f"{'stage':30s} {'count':>6s} {'mean ms':>10s} {'total s':>9s}"]
        for k, v in self.summary().items():
            lines.append(f"{k:30s} {v['count']:6d} {v['mean_ms']:10.3f} {v['total_s']:9.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and the card when there
    is one), written as a Chrome trace under ``log_dir``; yields the
    profiler (``key_averages()`` for the table)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
