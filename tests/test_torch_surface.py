"""The port's surface against the JAX package's: the CLI (tests/test_aux.py::
TestCLI and test_cli_flag_enables_head, run in-process on the CPU), the
real-dataset loaders on fake TUM / KITTI / EuRoC trees, the native C++ I/O,
the plots, the stage timer and device trace, and the sensor-fusion
helpers."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from weiner_slamit_v2_tpu.io import datasets as jds
from weiner_slamit_v2_tpu.models import posenet as jposenet
from weiner_slamit_v2_tpu.native import load_dbow2_text_native as jax_voc_native
from weiner_slamit_v2_tpu.slam_map.checkpoint import load_map as jax_load_map
from weiner_slamit_v2_tpu.utils import sensor_fusion as jsf
from weiner_slamit_v2_torch import cli, native
from weiner_slamit_v2_torch.bow.vocabulary import load_dbow2_text
from weiner_slamit_v2_torch.io import datasets as tds
from weiner_slamit_v2_torch.models import posenet as tposenet
from weiner_slamit_v2_torch.tracking.tracker import Tracker
from weiner_slamit_v2_torch.utils import sensor_fusion as tsf
from weiner_slamit_v2_torch.utils.profiling import StageTimer, device_trace
from weiner_slamit_v2_torch.viz import plotting

torch.set_num_threads(1)


# --- the CLI ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CPU replay with TestCLI's flags (10 synthetic frames, seed 11,
    --out, --checkpoint, --eval) and every other output flag, the head
    running on JAX-saved params: (directory, summary, the params
    enable_posenet received). One run: 10 frames at the default 1024
    features take ~2 minutes on one core."""
    d = tmp_path_factory.mktemp("cli")
    params = jposenet.init_params(jax.random.PRNGKey(5))
    jposenet.save_params(str(d / "pn.npz"), params)
    got, real = [], Tracker.enable_posenet

    def spy(self, p=None):
        got.append(p)
        real(self, p)

    Tracker.enable_posenet = spy
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--dataset", "synthetic", "--frames", "10", "--seed", "11",
                           "--device", "cpu", "--out", str(d / "traj.txt"),
                           "--out-kitti", str(d / "traj_kitti.txt"),
                           "--checkpoint", str(d / "map.npz"), "--plot", str(d / "map.png"),
                           "--posenet-params", str(d / "pn.npz"), "--eval", "--no-loop-closing"])
    finally:
        Tracker.enable_posenet = real
    assert rc == 0
    return d, json.loads(out.getvalue().strip().splitlines()[-1]), got


def test_cli_synthetic_run(cli_run):
    """TestCLI: replay + export + eval + checkpoint (the JAX package reads
    the checkpoint)."""
    d, summary, _ = cli_run
    assert summary["frames"] == 10 and summary["tracked_ok"] > 5 and summary["device"] == "cpu"
    assert np.isfinite(summary["ate_rmse"])
    for name in ("traj.txt", "traj_kitti.txt", "map.npz"):
        assert (d / name).exists(), name
    assert (d / "map.png").stat().st_size > 1000
    rows = np.loadtxt(d / "traj.txt")
    assert rows.shape[1] == 8 and len(rows) == summary["tracked_ok"]   # one line per OK frame
    m, _ = jax_load_map(str(d / "map.npz"))
    assert int(np.asarray(m.kf_valid).sum()) == summary["keyframes"]


def test_cli_flag_enables_head(cli_run):
    """--posenet-params loads the file (JAX's save_params layout) into the
    head that runs on every frame."""
    d, _, got = cli_run
    assert len(got) == 1 and isinstance(got[0], tposenet.PoseNet)
    ref = jposenet.load_params(str(d / "pn.npz"))
    np.testing.assert_array_equal(got[0].stem.weight.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(ref["params"]["Conv_0"]["kernel"]))


def test_cli_defaults_to_the_card():
    args = cli.build_parser().parse_args(["--dataset", "synthetic"])
    assert args.device == "cuda" and not args.posenet


# --- dataset loaders ----------------------------------------------------------------

def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def fake_tum(root, rng):
    """rgb.txt with a comment, depth.txt offset 5 ms (one depth missing past
    20 ms), groundtruth.txt at its own rate."""
    rgb, depth, gt = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(4):
        ts = 100.0 + 0.033 * i
        _png(f"{root}/rgb/{i}.png", rng.integers(0, 256, (12, 16), dtype=np.uint8))
        rgb.append(f"{ts:.6f} rgb/{i}.png")
        if i != 2:
            _png(f"{root}/depth/{i}.png", rng.integers(0, 60000, (12, 16)).astype(np.uint16))
            depth.append(f"{ts + 0.005:.6f} depth/{i}.png")
    for j in range(10):
        t, q = rng.normal(size=3), _quat(rng)
        gt.append(f"{99.99 + 0.015 * j:.6f} " + " ".join(f"{v:.6f}" for v in (*t, *q)))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", depth), ("groundtruth.txt", gt)):
        with open(f"{root}/{name}", "w") as f:
            f.write("\n".join(lines) + "\n")


def fake_kitti(root, rng):
    seq = f"{root}/sequences/00"
    for i in range(3):
        for cam in ("image_0", "image_1"):
            _png(f"{seq}/{cam}/{i:06d}.png", rng.integers(0, 256, (10, 14), dtype=np.uint8))
    with open(f"{seq}/times.txt", "w") as f:
        f.write("0.000000e+00\n1.037359e-01\n2.073381e-01\n")
    with open(f"{seq}/calib.txt", "w") as f:
        f.write("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
                "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    os.makedirs(f"{root}/poses")
    np.savetxt(f"{root}/poses/00.txt", rng.normal(size=(4, 12)))


def fake_euroc(root, rng):
    cam = f"{root}/mav0/cam0"
    lines = ["#timestamp [ns],filename"]
    for i in range(3):
        ns = 1403636579763555584 + 50_000_000 * i
        _png(f"{cam}/data/{ns}.png", rng.integers(0, 256, (8, 12), dtype=np.uint8))
        lines.append(f"{ns},{ns}.png")
    with open(f"{cam}/data.csv", "w") as f:
        f.write("\n".join(lines) + "\n")
    gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x"]
    for j in range(8):
        ns = 1403636579758555392 + 20_000_000 * j
        gt.append(f"{ns}," + ",".join(f"{v:.6f}" for v in (*rng.normal(size=3), *_quat(rng), 0.1)))
    os.makedirs(f"{root}/mav0/state_groundtruth_estimate0")
    with open(f"{root}/mav0/state_groundtruth_estimate0/data.csv", "w") as f:
        f.write("\n".join(gt) + "\n")


def assert_same_sequence(a, b):
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.timestamp == fb.timestamp
        np.testing.assert_array_equal(fa.image, fb.image)
        for x, y in ((fa.depth, fb.depth), (fa.image_right, fb.image_right)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    assert (a.gt_Twc is None) == (b.gt_Twc is None)
    if a.gt_Twc is not None:
        # the float32 quaternion -> rotation, one ulp apart between the packages
        np.testing.assert_allclose(a.gt_Twc, b.gt_Twc, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["tum", "kitti", "euroc"])
def test_loaders_match_jax(tmp_path, kind):
    rng = np.random.default_rng(["tum", "kitti", "euroc"].index(kind))
    root = str(tmp_path)
    {"tum": fake_tum, "kitti": fake_kitti, "euroc": fake_euroc}[kind](root, rng)
    if kind == "tum":
        a, b = jds.load_tum_rgbd(root, max_frames=3), tds.load_tum_rgbd(root, max_frames=3)
        assert [f.depth is None for f in b.frames] == [False, False, True]
        # both packages' open fault (ROADMAP C): the 16-bit depth PNG goes
        # through the gray decoder, which scales it to 0-255 first
        raw = np.asarray(Image.open(f"{root}/depth/0.png"), np.float64)
        np.testing.assert_allclose(b.frames[0].depth, raw * 255.0 / 65535.0 / 5000.0, rtol=1e-6)
    elif kind == "kitti":
        a, b = jds.load_kitti_odometry(root, "00"), tds.load_kitti_odometry(root, "00")
        assert jds.load_kitti_calib(root, "00") == tds.load_kitti_calib(root, "00")
        assert tds.load_kitti_calib(root, "00")["baseline_times_fx"] == pytest.approx(386.1448)
        assert tds.load_kitti_calib(root, "01") is None
    else:
        a, b = jds.load_euroc(root, max_frames=2), tds.load_euroc(root, max_frames=2)
    assert b.gt_Twc is not None and len(b.frames) >= 2
    assert_same_sequence(a, b)


# --- native I/O ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ could not build the native library"
    assert os.path.dirname(native.LIB_PATH).endswith(os.path.join("weiner_slamit_v2_torch", "_build"))
    return lib


def test_native_png_pgm_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "g.png")
    np.testing.assert_array_equal(native.load_image_gray_native(str(tmp_path / "g.png")), img)
    with open(tmp_path / "g.pgm", "wb") as f:
        f.write(b"P5\n64 48\n255\n" + img.tobytes())
    np.testing.assert_array_equal(native.load_image_gray_native(str(tmp_path / "g.pgm")), img)
    rgb = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "c.png")
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    np.testing.assert_allclose(native.load_image_gray_native(str(tmp_path / "c.png")), luma, atol=1.0)
    assert native.load_image_gray_native(str(tmp_path / "missing.png")) is None
    Image.fromarray(img).save(tmp_path / "g.jpg")
    assert native.load_image_gray_native(str(tmp_path / "g.jpg")) is None
    np.testing.assert_array_equal(tds._load_gray(str(tmp_path / "g.jpg")),
                                  jds._load_gray(str(tmp_path / "g.jpg")))   # PIL's path


def test_native_vocabulary_matches_python_and_jax(lib, tmp_path):
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 256, (12, 32))
    lines = ["10 6 0 0"] + [f"{i // 3} {i % 2} " + " ".join(map(str, descs[i])) + f" {0.25 * i:.6f}"
                            for i in range(12)]
    (tmp_path / "voc.txt").write_text("\n".join(lines) + "\n")
    k, L, d = native.load_dbow2_text_native(str(tmp_path / "voc.txt"))
    kp, Lp, dp = load_dbow2_text(str(tmp_path / "voc.txt"))
    kj, Lj, dj = jax_voc_native(str(tmp_path / "voc.txt"))
    assert (k, L) == (kp, Lp) == (kj, Lj) == (10, 6)
    for key in ("parent", "desc", "weight"):
        np.testing.assert_array_equal(d[key], dp[key])
        np.testing.assert_array_equal(d[key], dj[key])
    np.testing.assert_array_equal(d["is_leaf"], dp["is_leaf"].astype(bool))
    assert native.load_dbow2_text_native(str(tmp_path / "nope.txt")) is None


# --- plots, profiling, sensor fusion ------------------------------------------------------

def test_plots_write_files(tmp_path):
    n = 10
    Twc = np.tile(np.eye(4), (n, 1, 1))
    Twc[:, 0, 3] = np.linspace(0, 1, n)
    plotting.plot_trajectory(str(tmp_path / "t.png"), torch.from_numpy(Twc), Twc)
    feats = type("F", (), dict(xy=torch.rand(20, 2) * 30, valid=torch.rand(20) > 0.3))
    plotting.plot_frame_features(str(tmp_path / "f.png"), np.zeros((32, 32)), feats)
    for name in ("t.png", "f.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_stage_timer_and_trace_on_cpu(tmp_path):
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("matmul", block_on=(torch.ones(4) @ torch.ones(4), {"x": torch.zeros(1)})):
            pass
    s = timer.summary()
    assert s["matmul"]["count"] == 3 and s["matmul"]["total_s"] >= 0
    assert "matmul" in timer.report()
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert os.listdir(tmp_path / "trace")


def test_sensor_fusion_matches_jax():
    rng = np.random.default_rng(6)
    g = rng.normal(size=(5, 3)).astype(np.float32)
    m = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tsf.rotation_from_gravity_magnetic(torch.from_numpy(g), torch.from_numpy(m)).numpy(),
                               np.asarray(jsf.rotation_from_gravity_magnetic(jnp.asarray(g), jnp.asarray(m))),
                               atol=1e-6, rtol=0)
    acc = rng.normal(size=(20, 3)).astype(np.float32)
    tp, tv = tsf.integrate_accel_sequence(torch.from_numpy(acc), 0.01)
    jpos, jvel = jsf.integrate_accel_sequence(jnp.asarray(acc), 0.01)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jpos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jvel), atol=1e-6, rtol=0)
    assert float(tsf.metric_scale_from_walk(tp, 2.0)) == pytest.approx(
        float(jsf.metric_scale_from_walk(jpos, 2.0)), rel=1e-6)
