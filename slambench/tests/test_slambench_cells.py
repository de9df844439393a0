"""Each cell end to end at a tiny size on the CPU: the harness's whole run but
its look for a card, with the program's CPU path. Then the bfloat16 control
and the planted faults, each of which the comparison has to reject."""

import json

import pytest

from slambench import harness

# 320x240, 512 features, small pools; the window opens at 4 keyframes
TINY = dict(device="cpu", scale=0.5, warmup_keyframes=4,
            capacity=dict(n_features=512, max_keyframes=64, max_map_points=4096,
                          local_ba_points=512, local_ba_window=8))
# the kidnap schedule brought forward so that a tiny window holds a cover; the
# map holds more than 5 keyframes by then, so a loss does not reset it
KIDNAP = dict(kidnap={"start": 50, "period": 12, "offset": 6, "blank": 2, "jump": 37,
                      "blank_value": 128},
              min_warmup_frames=55)
SEED = 2**31 + 977


# the kidnap cell is kept as files (its traffic, limits, readers and the PnP
# check) but is not among BENCHMARK.json's cells: a checkout whose
# BENCHMARK.json adds it, with its relocalization metrics
KIDNAP_CELL = {"name": "tum_fr1_mono.kidnap", "config": "tum_fr1_mono", "traffic": "kidnap",
               "chips": 1, "why": "laps of a mapped loop with the lens covered"}
KIDNAP_METRICS = [
    {"name": n, "unit": u, "better": "lower", "source": s, "layer": "tracking/tracker.py",
     "moves": "frame_ms", "workloads": ["tum_fr1_mono.kidnap"]}
    for n, u, s in (("tracker.reloc_ms", "ms", "program_span"),
                    ("tracker.lost_per_100", "frames/100", "program_counter"))]


def _root_with_kidnap(tmp_path):
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(KIDNAP_CELL)
    spec["per_layer"] += KIDNAP_METRICS
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "slambench").symlink_to(harness.HERE)
    return tmp_path


def _run(workload, seconds=6.0, trace=False, traffic_overrides=None, **kw):
    kid = workload.endswith("kidnap")
    over = {**(KIDNAP if kid else {}), **(traffic_overrides or {})}
    return harness.run_cell(workload, SEED, seconds, trace, n_frames=90, traffic_overrides=over,
                            **{**TINY, "warmup_keyframes": 6 if kid else 4, **kw})


@pytest.mark.parametrize("workload", ["tum_fr1_mono.explore", "tum_fr1_mono.kidnap"])
def test_cell_runs_end_to_end(workload, tmp_path):
    kw = {"root": _root_with_kidnap(tmp_path)} if workload.endswith("kidnap") else {}
    r = _run(workload, **kw)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"frame_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "compared" and r["compared"]["frontend_diff"]["value"] == 0


def test_traced_run_reads_its_span_metrics():
    # three traced frames or more, until a mapping pass ran in them; the
    # spans are read in the window before them
    r = _run("tum_fr1_mono.explore", seconds=8.0, trace=True,
             traffic_overrides={"trace": {"frames": 3, "until": "pass"}})
    assert r["correct"] is True
    m = r["metrics"]
    for name in ("frontend.extract_ms", "tracker.track_ms", "pose_opt.lm_ms",
                 "system.passes_per_100", "device.launches_per_frame"):
        assert name in m and m[name]["value"] >= 0, name
    # the readers of the program's own spans and counters (the CPU launches
    # nothing, so the launch counts read 0)
    for name in ("pose_opt.launches_per_call", "tracker.self_launches_per_step",
                 "frontend.launches_per_extract", "mapping.launches_per_pass",
                 "mapping.syncs_per_pass", "device.idle_unspanned_share",
                 "system.deferred_adoptions_per_100"):
        assert name in m and m[name]["value"] is not None and m[name]["value"] >= 0, name
    assert "frame_ms" not in m and "breakdown" in r
    # the idle gaps now name the program's own spans
    assert any(n.startswith("slam.") for n, _ in r["breakdown"]["idle_gaps"])


def test_the_bfloat16_control_is_not_correct():
    r = _run("tum_fr1_mono.explore", control=True)
    assert r["correct"] is False
    c = r["compared"]
    assert c["frontend_diff"]["value"] > 0
    assert c["pose_cost_excess"]["value"] > c["pose_cost_excess"]["limit"]


class _Switch:
    on = False


def test_a_pose_lm_that_returns_its_start_is_caught(monkeypatch):
    from weiner_slamit_v2_torch.tracking import tracker

    orig, sw = tracker.optimize_pose, _Switch()

    def unchanged(Tcw0, X, uv, inv_sigma2, valid, K, **kw):
        out = orig(Tcw0, X, uv, inv_sigma2, valid, K, **kw)
        return (Tcw0, out[1], out[2]) if sw.on else out

    monkeypatch.setattr(tracker, "optimize_pose", unchanged)
    r = _run("tum_fr1_mono.explore", before_window=lambda s: setattr(sw, "on", True))
    assert r["correct"] is False and r["failed"] > 0
    assert r["compared"]["pose_cost_excess"]["value"] > r["compared"]["pose_cost_excess"]["limit"]


def test_an_altered_descriptor_is_caught(monkeypatch):
    from weiner_slamit_v2_torch.tracking.tracker import Tracker

    orig, sw = Tracker._extract, _Switch()

    def altered(self, image, initializing):
        f = orig(self, image, initializing)
        if not sw.on:
            return f
        desc = f.desc.clone()
        desc[0, 0] ^= 1
        return f.replace(desc=desc)

    monkeypatch.setattr(Tracker, "_extract", altered)
    r = _run("tum_fr1_mono.explore", before_window=lambda s: setattr(sw, "on", True))
    assert r["correct"] is False and r["compared"]["frontend_diff"]["value"] > 0


def test_a_bundle_adjustment_that_returns_its_start_is_caught(monkeypatch):
    from weiner_slamit_v2_torch.tracking import local_mapping

    orig, sw = local_mapping.solve_ba, _Switch()

    def unchanged(prob, *a, **k):
        res = orig(prob, *a, **k)
        if sw.on:
            res.cam_pose, res.points = prob.cam_pose, prob.points
        return res

    monkeypatch.setattr(local_mapping, "solve_ba", unchanged)
    r = _run("tum_fr1_mono.explore", seconds=12.0,
             before_window=lambda s: setattr(sw, "on", True))
    assert r["compared"]["ba_cost_excess"]["value"] > r["compared"]["ba_cost_excess"]["limit"]
    assert r["correct"] is False
