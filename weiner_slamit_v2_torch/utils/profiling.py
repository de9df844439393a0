"""The port's span recorder: named, nested host spans at the layer
boundaries of the per-frame path (``slam.system.frame``,
``slam.frontend.extract``, ``slam.tracker.step``, ``slam.mapping.pass`` and
their parts), kept in memory and opened as
``torch.profiler.record_function`` ranges, so that under the profiler each
span is a range on the trace's own timeline.

Tracing is on only while a recorder is installed (``install`` /
``uninstall``). Without one, ``span`` tests one module global and returns
one shared object that does nothing: no clock read, no profiler range, no
allocation, no device call. No span ever synchronizes the card, and no span
sits inside a loop that runs more than a few times a frame.

The stamps are on the profiler's clock. Kineto stamps its host events in
Unix time (ns); the recorder reads ``time.perf_counter_ns()`` and adds the
offset to ``time.time_ns()`` it measures when it is installed.

One recorder serves one thread: the port tracks and maps on the thread
that calls the System.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int     # on the profiler's clock
    end_ns: int       # -1 while the span is open
    parent: int       # index of the enclosing span in Recorder.spans; -1 at the top
    frame: int        # the id (Tracker.frame_id) of the frame the span belongs to


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few reads of the Unix clock between two monotonic ones."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class Recorder:
    """The spans recorded while installed, in the order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self.frame = -1          # the frame the spans opening now belong to
        self.offset_ns = 0       # set by install()
        self._open: list[int] = []

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self.offset_ns

    def summary(self) -> dict[str, dict]:
        """Per span name: ``calls``, ``total_ms`` and ``self_ms`` (each span
        less the part its children cover), on the host's clock; open spans
        are left out."""
        child_ns = [0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0 and s.end_ns >= 0:
                child_ns[s.parent] += s.end_ns - s.start_ns
        out: dict[str, dict] = {}
        for s, c in zip(self.spans, child_ns):
            if s.end_ns < 0:
                continue
            d = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
            d["calls"] += 1
            d["total_ms"] += (s.end_ns - s.start_ns) * 1e-6
            d["self_ms"] += (s.end_ns - s.start_ns - c) * 1e-6
        return out


class _Recording:
    """One span of an installed recorder, as a context manager."""

    __slots__ = ("rec", "name", "tracker", "index", "range")

    def __init__(self, rec: Recorder, name: str, tracker):
        self.rec, self.name, self.tracker = rec, name, tracker

    def __enter__(self):
        rec = self.rec
        if self.tracker is not None:
            rec.frame = self.tracker.frame_id + 1
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.index = len(rec.spans)
        rec.spans.append(Span(self.name, rec.now_ns(), -1, rec._open[-1] if rec._open else -1,
                              rec.frame))
        rec._open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.index].end_ns = rec.now_ns()
        rec._open.pop()
        self.range.__exit__(*exc)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_recorder: Recorder | None = None


def span(name: str, tracker=None):
    """A span named ``name`` (a context manager). ``tracker``: the span opens
    a frame, and it and the spans inside it carry the id of the frame that
    tracker tracks next (``tracker.frame_id + 1``); other spans carry the id
    of the frame open around them."""
    if _recorder is None:
        return _NO_SPAN
    return _Recording(_recorder, name, tracker)


def install(recorder: Recorder) -> Recorder:
    """Record every span from now on into ``recorder``, with its clock
    offset measured now."""
    global _recorder
    recorder.offset_ns = clock_offset_ns()
    _recorder = recorder
    return recorder


def uninstall() -> Recorder | None:
    """Stop recording; returns the recorder that was installed."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec
