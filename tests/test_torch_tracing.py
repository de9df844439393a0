"""The span recorder (utils/profiling.py): nothing at all without a
recorder, the span tree and its summary, the stamps on the profiler's clock
(the ``cuda`` case on the card), and a session traced and untraced giving
the same bits. Imports no JAX: the ``cuda`` case runs on the card with
``--noconftest -m cuda``."""

import time

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch.config import CameraConfig, MapCapacityConfig, OrbConfig, SlamConfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_torch.optim.pose_opt import optimize_pose
from weiner_slamit_v2_torch.tracking.system import System
from weiner_slamit_v2_torch.utils import profiling
from weiner_slamit_v2_torch.utils.profiling import Recorder, Span, install, span, uninstall

torch.set_num_threads(1)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def device_or_skip(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


@pytest.fixture
def recorder():
    rec = install(Recorder())
    yield rec
    uninstall()


class _Frames:
    frame_id = 6


def _raise(*a, **k):
    raise AssertionError("called with no recorder installed")


def test_no_recorder_reads_no_clock_and_opens_no_range(monkeypatch):
    assert profiling._recorder is None
    for owner, name in ((torch.profiler, "record_function"), (time, "perf_counter_ns"),
                        (time, "time_ns")):
        monkeypatch.setattr(owner, name, _raise)
    assert span("slam.x") is span("slam.y", _Frames()) is profiling._NO_SPAN
    with span("slam.x", _Frames()) as s, span("slam.y"):
        assert s is profiling._NO_SPAN
    # a spanned layer of the program runs through its span untouched
    g = torch.Generator().manual_seed(0)
    X = torch.rand((40, 3), generator=g) + torch.tensor([0.0, 0.0, 4.0])
    uv = X[:, :2] / X[:, 2:] * 300.0 + 160.0
    K = torch.tensor([[300.0, 0, 160.0], [0, 300.0, 160.0], [0, 0, 1]])
    Tcw, inl, n = optimize_pose(torch.eye(4), X, uv, torch.ones(40), torch.ones(40, dtype=torch.bool),
                                K, n_rounds=1, n_iters=2)
    assert int(n) == 40 and torch.allclose(Tcw, torch.eye(4), atol=1e-4)


def test_spans_nest_with_parents_and_frame_ids(recorder):
    with span("slam.a", _Frames()):
        with span("slam.b"):
            with span("slam.c"):
                pass
        with span("slam.d"):
            pass
    with span("slam.e"):
        pass
    got = [(s.name, s.parent, s.frame) for s in recorder.spans]
    assert got == [("slam.a", -1, 7), ("slam.b", 0, 7), ("slam.c", 1, 7), ("slam.d", 0, 7),
                   ("slam.e", -1, 7)]
    for s in recorder.spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = recorder.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert uninstall() is recorder and span("slam.f") is profiling._NO_SPAN
    install(recorder)


def test_summary_self_times_on_a_built_tree():
    rec = Recorder()
    ms = 1_000_000
    rec.spans = [Span("slam.frame", 0, 100 * ms, -1, 0),
                 Span("slam.step", 10 * ms, 60 * ms, 0, 0),
                 Span("slam.lm", 20 * ms, 30 * ms, 1, 0),
                 Span("slam.lm", 40 * ms, 55 * ms, 1, 0),
                 Span("slam.read", 70 * ms, 71 * ms, 0, 0),
                 Span("slam.frame", 200 * ms, 250 * ms, -1, 1),
                 Span("slam.open", 240 * ms, -1, 5, 1)]
    s = rec.summary()
    assert set(s) == {"slam.frame", "slam.step", "slam.lm", "slam.read"}
    assert s["slam.frame"] == {"calls": 2, "total_ms": pytest.approx(150.0),
                               "self_ms": pytest.approx(150.0 - 50.0 - 1.0)}
    assert s["slam.step"] == {"calls": 1, "total_ms": pytest.approx(50.0),
                              "self_ms": pytest.approx(25.0)}
    assert s["slam.lm"]["calls"] == 2 and s["slam.lm"]["self_ms"] == pytest.approx(25.0)
    assert s["slam.read"]["self_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("device", DEVICES)
def test_stamps_are_on_the_profilers_clock(device, recorder):
    dev = device_or_skip(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    x = torch.ones((256, 256), device=dev)
    with torch.profiler.profile(activities=acts) as prof:
        with span("slam.outer", _Frames()):
            for i in range(3):
                with span(f"slam.inner{i}"):
                    x = x @ x / 256.0
                    time.sleep(0.004)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("slam.") and "CUDA" not in str(e.device_type())}
    assert set(ranges) == {s.name for s in recorder.spans} and len(ranges) == 4
    for s in recorder.spans:
        r0, r1 = ranges[s.name]
        assert abs(r0 - s.start_ns) < 1_000_000 and abs(r1 - s.end_ns) < 1_000_000, (s, r0, r1)


H, W = 240, 320
SESSION_FRAMES = 4   # two-view initialization, a keyframe and the first stages of its pass


def _session(traced: bool):
    cfg = SlamConfig(orb=OrbConfig(n_features=256),
                     camera=CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0,
                                         p2=0, k3=0, width=W, height=H),
                     capacity=MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                                max_obs_per_point=16, local_ba_window=8,
                                                local_ba_points=512))
    K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
    seq = make_synthetic_sequence(n_frames=SESSION_FRAMES, h=H, w=W, seed=23, motion="orbit", K=K)
    system = System(cfg, Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H), device="cpu")
    rec = install(Recorder()) if traced else None
    try:
        outs = [system.track_monocular(f.image, f.timestamp) for f in seq.frames]
    finally:
        uninstall()
    return outs, system.tracker.m, rec


def test_a_traced_session_gives_the_same_bits_and_its_spans():
    plain, m_plain, _ = _session(False)
    traced, m_traced, rec = _session(True)
    for a, b in zip(plain, traced):
        assert (a.state, a.n_inliers, a.created_kf, a.deferred) == (b.state, b.n_inliers,
                                                                      b.created_kf, b.deferred)
        for x, y in ((a.Tcw, b.Tcw), (a.T_cr, b.T_cr)):
            assert (x is None) == (y is None) and (x is None or torch.equal(x, y))
    for f in ("kf_pose", "kf_valid", "mp_pos", "mp_valid", "kf_obs"):
        assert torch.equal(getattr(m_plain, f), getattr(m_traced, f)), f
    assert [s.name for s in rec.spans if s.parent < 0] == ["slam.system.frame"] * SESSION_FRAMES
    assert [s.frame for s in rec.spans if s.parent < 0] == list(range(SESSION_FRAMES))
    pairs = {(s.name, rec.spans[s.parent].name if s.parent >= 0 else None) for s in rec.spans}
    assert {("slam.system.pre_frame", "slam.system.frame"),
            ("slam.frontend.extract", "slam.system.frame"),
            ("slam.tracker.step", "slam.system.frame"),
            ("slam.tracker.motion_match", "slam.tracker.step"),
            ("slam.tracker.refkf_match", "slam.tracker.step"),
            ("slam.pose_opt.optimize_pose", "slam.tracker.step"),
            ("slam.tracker.local_map", "slam.tracker.step"),
            ("slam.tracker.step_tail", "slam.tracker.step"),
            ("slam.tracker.read", "slam.system.frame"),
            ("slam.tracker.new_keyframe", "slam.system.frame"),
            ("slam.bow.register", "slam.tracker.new_keyframe"),
            ("slam.mapping.pass", "slam.tracker.new_keyframe"),
            ("slam.mapping.triangulate", "slam.mapping.pass"),
            ("slam.mapping.fuse", "slam.mapping.pass"),
            ("slam.mapping.extract_ba", "slam.mapping.pass")} <= pairs
    # every span lies inside its parent and carries its parent's frame
    for s in rec.spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.frame == s.frame
    n_step = sum(s.name == "slam.tracker.step" for s in rec.spans)
    assert sum(s.name == "slam.pose_opt.optimize_pose" for s in rec.spans) == 2 * n_step > 0
