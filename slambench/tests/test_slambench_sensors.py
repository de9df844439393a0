"""A stereo and an RGB-D session through the harness's whole run (but its
look for a card) at a tiny size on the CPU, from a checkout whose
BENCHMARK.json adds the two cells: both correct, the right view judged on
every frame, and the faults planted under the timed path, and the bfloat16
control, caught."""

import json

import pytest
import torch

from slambench import harness

SEED = 2**31 + 1613
# a KITTI 00-02 stereo rig (ORB-SLAM2 Examples/Stereo/KITTI00-02.yaml; the
# far-point gate ThDepth 35 x the 0.537 m baseline) and a TUM fr3 RGB-D
# camera (TUM3.yaml), each run at half size with 512 features
STEREO_CFG = {
    "name": "street_stereo", "sensor": "stereo",
    "camera": {"fx": 718.856, "fy": 718.856, "cx": 607.1928, "cy": 185.2157, "k1": 0.0, "k2": 0.0,
               "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 1241, "height": 376, "fps": 10.0,
               "baseline_times_fx": 386.1448, "depth_threshold": 18.7999, "depth_map_factor": 1.0},
    "orb": {"n_features": 2048, "scale_factor": 1.2, "n_levels": 8, "fast_threshold": 20.0,
            "fast_min_threshold": 7.0},
    "tracking": {"abortable_ba": False, "mapping_latency_frames": 8, "frames_per_sync": 1,
                 "max_frames_between_kf": 10},
    "capacity": {"max_keyframes": 256, "max_map_points": 16384},
    "enable_mapping": True, "enable_loop_closing": False, "reduced": [], "assumed": ["synthetic"],
}
RGBD_CFG = {
    **STEREO_CFG, "name": "room_rgbd", "sensor": "rgbd",
    "camera": {"fx": 535.4, "fy": 539.2, "cx": 320.1, "cy": 247.6, "k1": 0.0, "k2": 0.0, "p1": 0.0,
               "p2": 0.0, "k3": 0.0, "width": 640, "height": 480, "fps": 30.0,
               "baseline_times_fx": 40.0, "depth_threshold": 2.9848, "depth_map_factor": 5000.0},
    "orb": {**STEREO_CFG["orb"], "n_features": 1024},
    "tracking": {**STEREO_CFG["tracking"], "max_frames_between_kf": 30},
}
WOBBLE = {"rot": [[0.0, 0.0, [[0.02, 163.0, 0.0]]], [0.0, 0.0, [[-0.08, 326.0, 0.0]]],
                  [0.0, 0.0, [[0.01, 652.0, 0.0]]]]}
# a street: the road 1.65 m below the cameras, facades at x = +-8 m, a wall
# closing it, driven at 0.82 m a frame along z
STREET = {
    "frames": 60, "warmup_keyframes": 4, "min_warmup_frames": 0,
    "path": {"pos": [[0.0, 0.0, [[0.1, 326.0, 0.0]]], [0.0, 0.0, [[0.1, 326.0, -1.5707963267948966]]],
                     [0.0, 0.82, []]], **WOBBLE},
    "worlds": {"stereo": {"planes": [
        {"axis": "y", "at": 1.65, "ppm": 25, "extent": [[-8.0, 8.0], [-20.0, 120.0]]},
        {"axis": "x", "at": -8.0, "ppm": 25, "extent": [[-20.0, 120.0], [-10.0, 1.65]]},
        {"axis": "x", "at": 8.0, "ppm": 25, "extent": [[-20.0, 120.0], [-10.0, 1.65]]},
        {"axis": "z", "at": 120.0, "ppm": 25, "extent": [[-8.0, 8.0], [-10.0, 1.65]]}]}},
    "trace": {"frames": 2, "until": "pass"},
}
# a room: explore's pace before a textured wall at 4 m and a floor 1.2 m below
ROOM = {
    "frames": 70, "warmup_keyframes": 4, "min_warmup_frames": 0,
    "path": {"pos": [[0.0, 0.0116, []], [0.0, 0.0, [[0.1, 326.0, 0.0]]],
                     [0.1, 0.0, [[0.1, 326.0, -1.5707963267948966]]]], **WOBBLE},
    "worlds": {"rgbd": {"planes": [
        {"depth": 4.0},
        {"axis": "y", "at": 1.2, "ppm": 120, "extent": [[-3.0, 4.0], [0.0, 4.5]]}]}},
    "trace": {"frames": 2, "until": "pass"},
}
LIMITS = {"frontend_diff": 0, "pose_cost_excess": 0.1, "ba_cost_excess": 0.01,
          "ba_inlier_diff": 0.01, "fuse_diff": 0, "pnp_deficit": 0.1}
CELLS = {
    "street_stereo.drive": (STEREO_CFG, "drive", STREET,
                            {**LIMITS, "stereo_match_diff": 0, "stereo_ur_err": 0.001}),
    "room_rgbd.explore": (RGBD_CFG, "room", ROOM, {**LIMITS, "rgbd_depth_diff": 0}),
}
TINY = dict(device="cpu", scale=0.5, n_frames=None,
            capacity=dict(n_features=512, max_keyframes=64, max_map_points=4096,
                          local_ba_points=512, local_ba_window=8))


def root_with_cells(tmp_path, cells=CELLS, metrics=None):
    """A checkout whose BENCHMARK.json adds ``cells`` ({name: (config,
    traffic name, traffic, limits)}), with this benchmark's files linked
    in beside the cells' own, and ``metrics`` ({name: reader source}) as
    readers of its own."""
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / harness.HERE.name
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True)
        for f in (harness.HERE / sub).iterdir():
            (bench / sub / f.name).symlink_to(f)
    for f in harness.HERE.iterdir():
        if not (bench / f.name).exists():
            (bench / f.name).symlink_to(f)
    for name, (cfg, traffic_name, traffic, limits) in cells.items():
        (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (bench / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic))
        (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
        if cfg["name"] not in {c["name"] for c in spec["configs"]}:
            spec["configs"].append({"name": cfg["name"], "source": "test",
                                    "file": f"{harness.HERE.name}/configs/{cfg['name']}.json",
                                    "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": cfg["name"], "traffic": traffic_name,
                                  "chips": 1, "why": "test"})
        for m in spec["per_layer"]:
            m["workloads"] = m["workloads"] + [name]
    spec["per_layer"].append({"name": "frontend.right_extract_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "test", "moves": "frame_ms",
                              "workloads": [n for n in cells if cells[n][0]["sensor"] == "stereo"]})
    for mname, src in (metrics or {}).items():
        (bench / "metrics" / f"{mname}.py").write_text(src)
        spec["per_layer"].append({"name": mname, "unit": "n", "better": "lower",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "frame_ms", "workloads": list(cells)})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return root_with_cells(tmp_path_factory.mktemp("sensors"))


def run(root, workload, seconds=6.0, **kw):
    return harness.run_cell(workload, SEED, seconds, kw.pop("trace", False), root=root,
                            **{**TINY, **kw})


def probes_of(monkeypatch):
    """The probes' Recorder of the next run (kept by a wrapped constructor)."""
    from slambench import probes

    kept, orig = [], probes.Recorder

    class Kept(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept.append(self)

    monkeypatch.setattr(probes, "Recorder", Kept)
    return kept


@pytest.mark.parametrize("workload", list(CELLS))
def test_a_depth_session_runs_and_is_correct(root, workload, monkeypatch):
    kept = probes_of(monkeypatch)
    r = run(root, workload)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["compared"]
    c = r["compared"]
    stereo = workload.startswith("street")
    assert set(c) == set(CELLS[workload][3])
    assert c["frontend_diff"]["value"] == 0
    rec = kept[0]
    judged = {f for f, _ in rec.extracts}
    if stereo:
        # the right view of every window frame went through the match and was judged
        assert {f for f, _, _ in rec.stereos} == judged and len(rec.stereos) == len(judged)
        assert c["stereo_match_diff"]["value"] == 0 and c["stereo_ur_err"]["value"] <= 1e-3
        assert sum(int((o[0] >= 0).sum()) for _, _, o in rec.stereos) > 50 * len(rec.stereos)
    else:
        assert {f for f, _, _ in rec.depths} == judged
        assert c["rgbd_depth_diff"]["value"] == 0
        assert sum(int((o >= 0).sum()) for _, _, o in rec.depths) > 50 * len(rec.depths)


def test_the_bfloat16_control_is_not_correct_on_either(root):
    for workload in CELLS:
        r = run(root, workload, control=True)
        assert r["correct"] is False, workload
        c = r["compared"]
        assert c["frontend_diff"]["value"] > 0
        key = "stereo_match_diff" if workload.startswith("street") else "rgbd_depth_diff"
        assert c[key]["value"] > c[key]["limit"], (workload, c[key])


class _Switch:
    on = False


def _planted(monkeypatch, name, alter):
    """Wrap the tracker's ``name`` so that, once the window opens, its
    output goes through ``alter(args, out)``."""
    from weiner_slamit_v2_torch.tracking import tracker

    orig, sw = getattr(tracker, name), _Switch()

    def wrapped(*args):
        out = orig(*args)
        return alter(args, out) if sw.on else out

    monkeypatch.setattr(tracker, name, wrapped)
    return lambda system: setattr(sw, "on", True)


def _moved_1px(args, out):
    depth, ur = out
    ok = depth >= 0
    ur = ur + ok.float()
    bf = args[4]
    return torch.where(ok, bf / (args[0].xy[:, 0] - ur).clamp(min=1e-3), depth), ur


def _one_dropped(args, out):
    depth, ur = out
    i = int(torch.nonzero(depth >= 0)[0, 0])
    return depth.index_fill(0, torch.tensor([i]), -1.0), ur.index_fill(0, torch.tensor([i]), -1.0)


def _one_depth_altered(args, depth):
    i = int(torch.nonzero(depth >= 0)[0, 0])
    return depth.index_fill(0, torch.tensor([i]), float(depth[i]) + 0.01)


@pytest.mark.parametrize("workload, stage, alter, number", [
    ("street_stereo.drive", "match_stereo", _moved_1px, "stereo_ur_err"),
    ("street_stereo.drive", "match_stereo", _one_dropped, "stereo_match_diff"),
    ("room_rgbd.explore", "depth_from_depthmap", _one_depth_altered, "rgbd_depth_diff"),
], ids=["u_right_moved_1px", "one_match_dropped", "one_depth_altered"])
def test_a_planted_fault_is_caught(root, monkeypatch, workload, stage, alter, number):
    r = run(root, workload, before_window=_planted(monkeypatch, stage, alter))
    assert r["correct"] is False and r["failed"] > 0
    assert r["compared"][number]["value"] > r["compared"][number]["limit"]


COUNTER_READER = '''"""Keyframes the session created, read from the session itself."""


def read(ctx):
    return ctx.system.tracker.n_kf_host if ctx.system is not None else None
'''


def test_a_reader_reads_a_program_counter_through_the_session(tmp_path):
    root = root_with_cells(tmp_path, {"street_stereo.drive": CELLS["street_stereo.drive"]},
                           metrics={"test.keyframes_created": COUNTER_READER})
    r = run(root, "street_stereo.drive", seconds=8.0, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    assert m["test.keyframes_created"]["value"] >= 4
    assert m["frontend.right_extract_ms"]["value"] > 0
