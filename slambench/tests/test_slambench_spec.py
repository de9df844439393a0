"""BENCHMARK.json against the benchmark's contract, the files it names, the
imports of the benchmark's modules and the roofline arithmetic."""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from slambench import harness, roofline
from slambench.reference.port.ops.pyramid import level_shapes

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["slambench"] and SPEC["command"] == ["python3", "slambench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[k]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[k]]
        assert len(got) == len(set(got))
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for text in ([c["source"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_the_contract_keys_and_their_files():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"frame_ms", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_configs_are_the_presets_with_the_stated_tracking():
    from weiner_slamit_v2_torch import presets

    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        cfg = harness.slam_config(f, 0)
        ref = presets.preset(f["preset"])
        assert cfg.camera == ref.camera and cfg.orb == ref.orb and cfg.capacity == ref.capacity
        assert not cfg.tracking.abortable_ba and cfg.tracking.frames_per_sync == 1
        assert cfg.tracking.mapping_latency_frames == 8
        assert cfg.tracking.max_frames_between_kf == ref.tracking.max_frames_between_kf


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "weiner_slamit_v2_tpu"}
        assert not bad, (f, bad)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert "weiner_slamit_v2_torch" not in _imports(f), f
    for f in ("check.py", "roofline.py", "world.py", "evaluation.py"):
        assert "weiner_slamit_v2_torch" not in _imports(BENCH / f), f


def test_kernel_a_counts_reproduce_the_kernel_table():
    shapes = level_shapes(480, 640, 8, 1.2)
    px = roofline.fast_pixels(shapes)
    assert px == 950_532
    assert roofline.FAST_BYTES_PER_PX * px == 7_604_256       # 7.6 MB
    assert roofline.fast_call_seconds(shapes) == pytest.approx(7_604_256 / 3.35e12)


def _best2_args(B, N1, N2, v1, v2, win):
    g = torch.Generator().manual_seed(0)
    d1 = torch.randint(-2**31, 2**31 - 1, (B, N1, 8), dtype=torch.int32, generator=g)
    d2 = torch.randint(-2**31, 2**31 - 1, (B, N2, 8), dtype=torch.int32, generator=g)
    pxy = torch.rand((B, N1, 2), generator=g) * 100
    xy2 = torch.rand((B, N2, 2), generator=g) * 100
    lo = torch.zeros((B, N1), dtype=torch.int32)
    return (d1, d2, v1, v2, pxy, xy2, win, lo, lo + 7, torch.zeros((B, N2), dtype=torch.int32),
            torch.ones((B, N2)))


def test_kernel_b_bytes_follow_the_kernel_tables_rule():
    B, N1, N2 = 20, 1024, 1024
    v1 = torch.zeros((B, N1), dtype=torch.bool)
    v1[:, :300] = True
    win = torch.zeros((B, N1))
    win[:, :200] = 10.0                    # 200 usable rows, 100 valid without a window
    v2 = torch.zeros((B, N2), dtype=torch.bool)
    v2[:, :700] = True
    args = _best2_args(B, N1, N2, v1, v2, win)
    n_bytes, _ = roofline.best2_counts(args, 5.991)
    want = B * (200 * 65 + 100 * 25 + (N1 - 300) * 13 + 700 * 49 + (N2 - 700) * 1)
    assert n_bytes == want
    # every row and column valid and usable: the whole (20, 1024, 1024) problem
    full = _best2_args(B, N1, N2, torch.ones((B, N1), dtype=torch.bool),
                       torch.ones((B, N2), dtype=torch.bool), torch.full((B, N1), 10.0))
    assert roofline.best2_counts(full, 5.991)[0] == B * N1 * 65 + B * N2 * 49
