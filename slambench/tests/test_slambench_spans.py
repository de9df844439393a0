"""The program spans' account (trace.py, spans.py) on hand-built profiler
events, and the readers of it on built Contexts."""

import pytest

from slambench import harness, spans, trace


class _Ev:
    def __init__(self, name, t0, dur, cuda=False, annotation=False, kind=""):
        self._n, self._t0, self._d = name, t0, dur
        self._cuda, self._ann, self._kind = cuda, annotation, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def activity_type(self):
        return self._kind


class _Prof:
    def __init__(self, events):
        kr = type("KR", (), {"events": lambda self_: events})()
        self.profiler = type("P", (), {"kineto_results": kr})()


def _range(name, t0, t1):
    return [_Ev(name, t0, t1 - t0, annotation=True),
            _Ev(name, t0, t1 - t0, cuda=True, annotation=True, kind="gpu_user_annotation")]


def _launch(t):
    return _Ev("cudaLaunchKernel", t, 1)


def _sync(t):
    return _Ev("cudaStreamSynchronize", t, 1)


def _kernel(t0, t1, name="k"):
    return _Ev(name, t0, t1 - t0, cuda=True, kind="kernel")


def _events(program=True):
    """A window 0-1000 ns: a frame span 10-900 holding a step 100-500 with a
    pose LM 200-300 inside; the benchmark's own range around the LM;
    launches and syncs at every level and outside; kernels leaving idle gaps
    in each span and outside them."""
    ev = _range(trace.WINDOW_SPAN, 0, 1000) + _range("pose_opt.optimize_pose", 190, 310)
    if program:
        ev += (_range("slam.system.frame", 10, 900) + _range("slam.tracker.step", 100, 500)
               + _range("slam.pose_opt.optimize_pose", 200, 300))
    ev += [_launch(t) for t in (5, 20, 150, 210, 220, 250, 450, 950)]
    ev += [_sync(t) for t in (30, 260, 480, 990)]
    ev += [_kernel(0, 20), _kernel(40, 120), _kernel(140, 210), _kernel(240, 600), _kernel(700, 960)]
    return ev


def test_launches_syncs_and_idle_go_to_the_innermost_program_span():
    r = trace.reduce(_Prof(_events()))
    by = r["by_span"]
    assert list(by) == ["slam.pose_opt.optimize_pose", "slam.system.frame", "slam.tracker.step"]
    assert {n: (s["calls"], s["launches"], s["syncs"]) for n, s in by.items()} == {
        "slam.system.frame": (1, 1, 1), "slam.tracker.step": (1, 2, 1),
        "slam.pose_opt.optimize_pose": (1, 3, 1)}
    assert (r["launches_unspanned"], r["syncs_unspanned"]) == (2, 1)
    # idle gaps 20-40, 120-140, 210-240, 600-700 and 960-1000, each by its middle
    assert by["slam.system.frame"]["idle_s"] == pytest.approx(20e-9 + 100e-9)
    assert by["slam.tracker.step"]["idle_s"] == pytest.approx(20e-9)
    assert by["slam.pose_opt.optimize_pose"]["idle_s"] == pytest.approx(30e-9)
    assert r["idle_unspanned_s"] == pytest.approx(40e-9)


def test_the_account_adds_up_to_the_traces_totals():
    prof = _Prof(_events())
    r = t = trace.reduce(prof)
    by = r["by_span"].values()
    assert sum(s["launches"] for s in by) + r["launches_unspanned"] == t["launches"] == 8
    assert sum(s["syncs"] for s in by) + r["syncs_unspanned"] == t["syncs"] == 4
    assert (sum(s["idle_s"] for s in by) + r["idle_unspanned_s"]
            == pytest.approx(t["window_s"] - t["busy_s"]))
    # the program's ranges are no device work, and the benchmark's gap rule
    # now names the program's innermost spans
    assert t["busy_s"] == pytest.approx(20e-9 + 80e-9 + 70e-9 + 360e-9 + 260e-9)
    assert dict(t["idle_gaps"])["slam.system.frame"] == pytest.approx(120e-9)


def test_a_trace_without_program_spans_is_all_unspanned():
    prof = _Prof(_events(program=False))
    r = t = trace.reduce(prof)
    assert r["by_span"] == {}
    assert (r["launches_unspanned"], r["syncs_unspanned"]) == (t["launches"], t["syncs"])
    assert r["idle_unspanned_s"] == pytest.approx(t["window_s"] - t["busy_s"])
    with_spans = trace.reduce(_Prof(_events()))
    for k in ("window_s", "busy_s", "launches", "syncs", "device_ops", "kernel_calls"):
        assert t[k] == with_spans[k], k
    assert not any(n.startswith(spans.PREFIX) for n, _ in t["idle_gaps"])
    with pytest.raises(RuntimeError):
        trace.reduce(_Prof(_events()[2:]))


def test_line_names_every_span_and_the_rest():
    r = trace.reduce(_Prof(_events()))
    s = spans.line(r, {"slam.tracker.step": {"calls": 1, "total_ms": 2.0, "self_ms": 1.5}})
    assert "\n" not in s and all(n in s for n in r["by_span"])
    assert "host 2.00 / 1.50 ms" in s and "in no span: 2 launches, 1 syncs" in s


def _ctx(by_span=None, **kw):
    t = {"window_s": 10.0, "busy_s": 1.0, "launches": 1000, "syncs": 40}
    if by_span is not None:
        t.update(by_span=by_span, launches_unspanned=10, syncs_unspanned=2,
                 idle_unspanned_s=0.45)
    return harness.Context(**{"frames": 50, "passes": 5, "lost": 0, "spans": {}, "trace": t,
                              "traced_frames": 10, **kw})


def _s(calls, launches, syncs=0, idle_s=0.0):
    return {"calls": calls, "launches": launches, "syncs": syncs, "idle_s": idle_s}


BY_SPAN = {
    "slam.system.frame": _s(10, 30, 5, 0.2), "slam.frontend.extract": _s(10, 4000, 10, 0.9),
    "slam.tracker.step": _s(10, 500, 0, 0.1), "slam.tracker.motion_match": _s(10, 300),
    "slam.tracker.refkf_match": _s(10, 100), "slam.tracker.local_map": _s(10, 200),
    "slam.tracker.step_tail": _s(10, 50), "slam.pose_opt.optimize_pose": _s(20, 200000, 0, 6.0),
    "slam.mapping.pass": _s(1, 10, 1), "slam.mapping.triangulate": _s(1, 900, 2),
    "slam.mapping.fuse": _s(1, 90, 3), "slam.mapping.local_ba": _s(1, 1000, 4),
}


def test_the_readers_of_the_program_spans():
    ctx = _ctx(BY_SPAN, deferred_adoptions=2)
    got = {n: harness.read_metric(n, ctx) for n in (
        "frontend.launches_per_extract", "tracker.self_launches_per_step",
        "pose_opt.launches_per_call", "mapping.launches_per_pass", "mapping.syncs_per_pass",
        "device.idle_unspanned_share", "system.deferred_adoptions_per_100")}
    assert got == {"frontend.launches_per_extract": 400.0,
                   "tracker.self_launches_per_step": 115.0,
                   "pose_opt.launches_per_call": 10000.0,
                   "mapping.launches_per_pass": 2000.0,
                   "mapping.syncs_per_pass": 10.0,
                   "device.idle_unspanned_share": pytest.approx(5.0),
                   "system.deferred_adoptions_per_100": 4.0}


@pytest.mark.parametrize("ctx", [
    _ctx(), _ctx({}), _ctx({k: v for k, v in BY_SPAN.items() if not k.startswith("slam.mapping.")}),
    harness.Context(frames=0, passes=0, lost=0, spans={})], ids=["parent", "empty", "no_pass", "bare"])
def test_the_readers_give_none_where_they_find_nothing(ctx):
    names = ["mapping.launches_per_pass", "mapping.syncs_per_pass",
             "system.deferred_adoptions_per_100"]
    if not (ctx.trace or {}).get("by_span"):
        names += ["frontend.launches_per_extract", "tracker.self_launches_per_step",
                  "pose_opt.launches_per_call", "device.idle_unspanned_share"]
    for n in names:
        assert harness.read_metric(n, ctx) is None, n


class _Once(list):
    """Events that count how often they are walked."""

    walks = 0

    def __iter__(self):
        _Once.walks += 1
        return super().__iter__()


def test_the_reduction_walks_the_events_once():
    events = _Once(_events())
    calls = []

    class KR:
        def events(self):
            calls.append(1)
            return events

    prof = type("P", (), {"profiler": type("PP", (), {"kineto_results": KR()})()})()
    _Once.walks = 0
    t = trace.reduce(prof)
    assert (len(calls), _Once.walks) == (1, 1)
    # and it holds the program spans' account beside the trace's own totals
    assert len(t["by_span"]) == 3 and t["launches"] == 8 and t["launches_unspanned"] == 2
