"""The distributed BA and data-parallel extraction of the port
(weiner_slamit_v2_torch/parallel/) on the CPU with gloo.

The JAX package's sharded BA runs once per module in a subprocess with 2
virtual CPU devices (tests/test_parallel.py::run_in_subprocess), on the
problem of tests/test_parallel.py (mono and its stereo variant); the port's
runs over 2 gloo ranks started with torch.multiprocessing.spawn on the same
partition. This module imports no JAX: the spawned ranks import it."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from weiner_slamit_v2_torch.config import (CameraConfig, MapCapacityConfig, OrbConfig,
                                           SlamConfig)
from weiner_slamit_v2_torch.frontend.extractor import OrbExtractor
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_torch.io.evaluation import ate_rmse
from weiner_slamit_v2_torch.optim.ba_extract import extract_global_ba
from weiner_slamit_v2_torch.optim.local_ba import BAProblem, solve_ba
from weiner_slamit_v2_torch.parallel import multihost
from weiner_slamit_v2_torch.parallel.data_parallel import batched_extract, sharded_extract
from weiner_slamit_v2_torch.parallel.sharded_ba import (BAMesh, make_ba_mesh, shard_problem,
                                                        solve_ba_sharded)
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W = 240, 320
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
ITERS = (3, 3)      # tests/test_parallel.py's schedule
N_EXTRACT = 4

JAX_CODE = """
import sys; sys.path.insert(0, %(repo)r)
import jax, numpy as np, jax.numpy as jnp
from tests.test_optim import make_ba_problem
from weiner_slamit_v2_tpu.geometry import se3
from weiner_slamit_v2_tpu.parallel.sharded_ba import make_ba_mesh, shard_problem, solve_ba_sharded

assert len(jax.devices()) == 2
prob, gt_poses, X_gt = make_ba_problem(n_cams=4, n_pts=64, max_obs=6, seed=0)
# the stereo variant of tests/test_parallel.py::TestShardedBAStereo
bf = 50.0
cams = np.maximum(np.asarray(prob.obs_cam), 0)
Pc = np.asarray(se3.apply(gt_poses[jnp.asarray(cams)], jnp.asarray(X_gt)[:, None, :]))
z = np.maximum(Pc[..., 2], 1e-6)
ur = (500.0 * Pc[..., 0] / z + 320.0 - bf / z).astype(np.float32)
stereo = prob.replace(obs_ur=jnp.asarray(ur), obs_has_ur=jnp.asarray(np.asarray(prob.obs_valid)),
                      bf=jnp.asarray(bf, jnp.float32))
mesh = make_ba_mesh(jax.devices())
for name, p in (("mono", prob), ("stereo", stereo)):
    res = solve_ba_sharded(shard_problem(p, mesh), mesh, iters1=%(i1)d, iters2=%(i2)d)
    out = {"prob_" + k: np.asarray(v) for k, v in vars(p).items() if v is not None}
    out.update({"res_" + k: np.asarray(v) for k, v in vars(res).items()})
    np.savez(%(out)r + "/" + name + ".npz", **out)
print("OK")
"""


def problem_from(z) -> BAProblem:
    return BAProblem(**{f.name: torch.from_numpy(z["prob_" + f.name]) if "prob_" + f.name in z
                        else None for f in dataclasses.fields(BAProblem)})


def extract_frames():
    seq = make_synthetic_sequence(n_frames=N_EXTRACT, h=H, w=W, seed=11, motion="orbit", K=K)
    return torch.from_numpy(np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in seq.frames]))


def extractor():
    return OrbExtractor(OrbConfig(n_features=256), (H, W))


def _rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank: the sharded BA on both problems and the sharded
    extraction; rank 0 writes the results (every rank holds all of them)."""
    torch.set_num_threads(1)
    dev = multihost.initialize("cpu", init_method=f"file://{store}", world_size=world, rank=rank)
    mesh = multihost.global_mesh(dev)
    assert multihost.is_multihost() and mesh.world_size == world and mesh.rank == rank
    out = {}
    for name in ("mono", "stereo"):
        with np.load(os.path.join(out_dir, name + ".npz")) as z:
            local = shard_problem(problem_from(z), mesh)
        assert local.points.shape[0] == 64 // world
        assert (local.obs_ur is not None) == (name == "stereo")
        res = solve_ba_sharded(local, mesh, *ITERS)
        out.update({f"{name}_{k}": v.numpy() for k, v in vars(res).items()})
    out["all_reduces"] = np.asarray(mesh.all_reduces)
    feats = sharded_extract(extractor(), extract_frames(), mesh)
    out.update({"feat_" + k: v.numpy() for k, v in vars(feats).items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's sharded solves, started in a subprocess from a thread (its
    compile overlaps the sessions below); (directory, future)."""
    from tests.test_parallel import run_in_subprocess

    d = str(tmp_path_factory.mktemp("sharded"))
    code = JAX_CODE % dict(repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           i1=ITERS[0], i2=ITERS[1], out=d)
    with ThreadPoolExecutor(1) as pool:
        yield d, pool.submit(run_in_subprocess, code, 2)


@pytest.fixture(scope="module")
def runs(jax_run):
    """JAX's sharded results (2 virtual devices) and the port's (2 gloo
    ranks), written to one directory."""
    d, future = jax_run
    assert "OK" in future.result()
    mp.spawn(_rank, args=(2, os.path.join(d, "store"), d), nprocs=2, join=True)
    return d


@pytest.fixture
def world1():
    """A world-size-1 gloo group (make_ba_mesh's own), torn down after."""
    mesh = make_ba_mesh("cpu")
    assert mesh.world_size == 1 and mesh.device.type == "cpu" and dist.get_backend() == "gloo"
    yield mesh
    dist.destroy_process_group()


def session_config():
    """tests/test_parallel.py::TestSystemDistributedGBA's configuration."""
    return SlamConfig(
        orb=OrbConfig(n_features=256),
        camera=CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=W, height=H),
        capacity=MapCapacityConfig(max_keyframes=32, max_map_points=2048, max_obs_per_point=16,
                                   local_ba_window=8, local_ba_points=512),
    )


@pytest.fixture(scope="module")
def sessions(jax_run):
    """The 28-frame session of test_parallel.py, mapped on the session's
    device and with mapping_device="cpu" (the snapshot moved per keyframe)."""
    seq = make_synthetic_sequence(n_frames=28, h=H, w=W, seed=11, motion="orbit", K=K)
    out = []
    for mapping_device in (None, "cpu"):
        sys_ = System(session_config(), Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H),
                      device="cpu", mapping_device=mapping_device)
        for f in seq.frames:
            sys_.track_monocular(f.image, f.timestamp)
        sys_.finish()
        out.append(sys_)
    return seq, out


def test_mapping_device_gives_the_same_map(sessions):
    _, (plain, moved) = sessions
    assert moved.mapping_passes == plain.mapping_passes > 0
    for f in dataclasses.fields(plain.tracker.m):
        assert torch.equal(getattr(moved.tracker.m, f.name), getattr(plain.tracker.m, f.name)), f.name


def test_distributed_gba_improves_ate(sessions, world1):
    """test_parallel.py's TestSystemDistributedGBA at world size 1: perturb
    every non-gauge keyframe and every point by N(0, 0.01), then
    distributed_gba lowers the ATE and agrees with solve_ba on the same
    extraction to 1e-3 (its poses), the JAX test's bound."""
    seq, (sys_, _) = sessions
    t = sys_.tracker
    assert t.n_kf_host >= 4
    rng = np.random.default_rng(3)
    m = t.m
    nkf = m.kf_pose.shape[0]
    noise_t = torch.from_numpy(rng.normal(0, 0.01, (nkf, 3)).astype(np.float32))
    move = ((torch.arange(nkf) > 0) & m.kf_valid)[:, None]
    pose = m.kf_pose.clone()
    pose[:, :3, 3] += torch.where(move, noise_t, 0.0)
    pts = m.mp_pos + torch.from_numpy(rng.normal(0, 0.01, m.mp_pos.shape).astype(np.float32)) \
        * m.mp_valid[:, None]
    t.m = m.replace(kf_pose=pose, mp_pos=pts)
    _, Twc = t.trajectory_Twc()
    ate_before = ate_rmse(Twc, seq.gt_Twc[-len(Twc):])
    gauge = int(torch.nonzero(t.m.kf_valid)[0])
    prob, _, _ = extract_global_ba(t.m, t.K, t.inv_sigma2, gauge_kf=gauge)
    ref = solve_ba(prob, 5, 10)
    res = sys_.distributed_gba(world1, iters=15)
    _, Twc2 = t.trajectory_Twc()
    ate_after = ate_rmse(Twc2, seq.gt_Twc[-len(Twc2):])
    assert np.isfinite(ate_after) and ate_after < ate_before, (ate_before, ate_after)
    torch.testing.assert_close(res.cam_pose, ref.cam_pose, atol=1e-3, rtol=0)
    assert t.velocity is None and torch.isfinite(t.last_Tcw).all()
    valid = t.m.kf_valid
    torch.testing.assert_close(t.m.kf_pose[valid], res.cam_pose[valid], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["mono", "stereo"])
def test_sharded_matches_jax_sharded(runs, name):
    """The port's 2-rank BA against the JAX package's 2-device BA on the same
    partition (each rank damps its own camera blocks before the sum, so both
    differ from solve_ba alike): poses within 1e-4, points within 1e-3 (the
    two packages' summation orders), inlier flags and the final cost's
    sum equal to 1e-4 relative; the stereo problem keeps its 3-dof rows."""
    with np.load(os.path.join(runs, name + ".npz")) as z, \
            np.load(os.path.join(runs, "port.npz")) as p:
        np.testing.assert_allclose(p[f"{name}_cam_pose"], z["res_cam_pose"], atol=1e-4)
        np.testing.assert_allclose(p[f"{name}_points"], z["res_points"], atol=1e-3)
        np.testing.assert_array_equal(p[f"{name}_obs_inlier"], z["res_obs_inlier"])
        assert float(p[f"{name}_final_cost"]) == pytest.approx(float(z["res_final_cost"]), rel=1e-4)
        # 2 all_reduces per LM step (the reduced system; costs + bad count),
        # then the final cost; both problems ran on one mesh
        assert int(p["all_reduces"]) == 2 * (2 * sum(ITERS) + 1)
        if name == "stereo":
            mono = np.load(os.path.join(runs, "mono.npz"))["res_points"]
            assert np.abs(p["stereo_points"] - mono).max() > 1e-4, "stereo rows dropped"


@pytest.mark.parametrize("name", ["mono", "stereo"])
def test_world_size_one_equals_solve_ba(runs, world1, name):
    """With one rank the sums are identities: solve_ba's poses and points to
    1e-6, and its inlier flags."""
    with np.load(os.path.join(runs, name + ".npz")) as z:
        prob = problem_from(z)
    res = solve_ba_sharded(shard_problem(prob, world1), world1, *ITERS)
    ref = solve_ba(prob, *ITERS)
    torch.testing.assert_close(res.cam_pose, ref.cam_pose, atol=1e-6, rtol=0)
    torch.testing.assert_close(res.points, ref.points, atol=1e-6, rtol=0)
    assert torch.equal(res.obs_inlier, ref.obs_inlier)


def test_uneven_split_raises(runs):
    """64 point slots over 3 ranks: refused, as shard_map refuses it."""
    with np.load(os.path.join(runs, "mono.npz")) as z:
        prob = problem_from(z)
    with pytest.raises(ValueError):
        shard_problem(prob, BAMesh(group=None, rank=0, world_size=3, device=torch.device("cpu")))


def test_extraction_batched_and_sharded_bit_equal(runs):
    """batched_extract and the 2-rank sharded_extract equal per-frame
    extraction, every field bit for bit."""
    ex, images = extractor(), extract_frames()
    per = [ex(img) for img in images]
    batched = batched_extract(ex, images)
    with np.load(os.path.join(runs, "port.npz")) as p:
        for f in dataclasses.fields(batched):
            want = torch.stack([getattr(x, f.name) for x in per])
            assert torch.equal(getattr(batched, f.name), want), f.name
            assert np.array_equal(p["feat_" + f.name], want.numpy()), f.name


def test_make_ba_mesh_without_a_group_is_world_one(world1):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    s, n = world1.all_sum(t, torch.tensor(3))
    assert torch.equal(s, t) and n.dtype == torch.int64 and int(n) == 3
    assert world1.all_reduces == 1 and torch.equal(world1.gather_rows(t), t)
    assert not multihost.is_multihost()
