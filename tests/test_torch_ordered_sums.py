"""util.index_add, the scatter-add of the BA's normal equations and of the
pose graph: the same sums on every run. On the CPU it is ``index_add_``
(which adds in index order); on the card it is the accumulating
``index_put_`` (a stable sort, then each row's values in index order), where
``index_add_`` adds with float atomics in the order they land. The card's
cases are marked ``cuda`` and skip without one; JAX is not imported, so they
also run on a machine with a card and no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_ordered_sums.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch import util
from weiner_slamit_v2_torch.geometry import se3
from weiner_slamit_v2_torch.optim import local_ba

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def device_or_skip(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


def ba_problem(device, seed=0, C=6, P=128, O=8) -> local_ba.BAProblem:
    """Cameras on a short arc and points in front (tests/test_optim.py's
    geometry), each point seen by 2..C cameras; the other slots are empty
    (camera -1). Poses and points perturbed, pixels with 0.5 px noise."""
    rng = np.random.default_rng(seed)
    xi = np.asarray([[0.15 * i, 0.02 * np.sin(i), 0.0, 0.0, -0.02 * i, 0.0] for i in range(C)],
                    np.float32)
    gt = se3.exp(torch.from_numpy(xi))
    X = np.stack([rng.uniform(-2, 3, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)],
                 1).astype(np.float32)
    obs_cam = np.full((P, O), -1, np.int32)
    for p, n in enumerate(rng.integers(2, C + 1, P)):
        obs_cam[p, :n] = rng.permutation(C)[:n]
    T = gt[torch.from_numpy(np.maximum(obs_cam, 0)).long()]
    Xc = (T[..., :3, :3] @ torch.from_numpy(X)[:, None, :, None])[..., 0] + T[..., :3, 3]
    uv = Xc[..., :2] / Xc[..., 2:] * 500.0 + torch.tensor([320.0, 240.0])
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, tuple(uv.shape)).astype(np.float32))
    pose = gt.clone()
    pose[1:, :3, 3] += torch.from_numpy(rng.normal(0, 0.05, (C - 1, 3)).astype(np.float32))
    fixed = torch.zeros(C, dtype=torch.bool)
    fixed[0] = True
    prob = local_ba.BAProblem(
        cam_pose=pose, cam_fixed=fixed, cam_valid=torch.ones(C, dtype=torch.bool),
        points=torch.from_numpy(X + rng.normal(0, 0.05, X.shape).astype(np.float32)),
        point_valid=torch.ones(P, dtype=torch.bool), obs_cam=torch.from_numpy(obs_cam),
        obs_uv=uv, obs_inv_sigma2=torch.ones(P, O), obs_valid=torch.from_numpy(obs_cam >= 0),
        K=torch.tensor([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]]))
    return local_ba.BAProblem(**{f.name: None if getattr(prob, f.name) is None
                                 else getattr(prob, f.name).to(device)
                                 for f in dataclasses.fields(prob)})


def test_index_add_on_cpu_is_index_add_():
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 7, (5000,), generator=g)
    src = torch.randn(5000, 36, generator=g)
    want = torch.zeros(7, 36).index_add_(0, idx, src)
    assert torch.equal(util.index_add(torch.zeros(7, 36), idx, src), want)


@pytest.mark.cuda
def test_index_add_on_card_is_ordered():
    """Equal from run to run and to the accumulating index_put_; within
    float32 rounding of the CPU's sums (1e-4 of the largest)."""
    dev = device_or_skip("cuda")
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 7, (20000,), generator=g)
    src = torch.randn(20000, 36, generator=g)
    i, s = idx.to(dev), src.to(dev)
    a = util.index_add(torch.zeros(7, 36, device=dev), i, s)
    b = util.index_add(torch.zeros(7, 36, device=dev), i, s)
    assert torch.equal(a, b)
    assert torch.equal(a, torch.zeros(7, 36, device=dev).index_put_((i,), s, accumulate=True))
    cpu = util.index_add(torch.zeros(7, 36), idx, src)
    assert float((a.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


@pytest.mark.parametrize("device", DEVICES)
def test_empty_observation_slots_add_nothing(device):
    """The empty slots go to spare rows; routed to camera 0 with their zero
    weight, as the layout had it, every block is the same bit for bit."""
    prob = ba_problem(device_or_skip(device))
    w = prob.obs_valid.to(torch.float32)
    args = (prob.cam_pose, prob.points, prob.K)
    got = local_ba.build_normal_equations(*args, prob.obs_cam, prob.obs_uv, w)
    at_zero = local_ba.build_normal_equations(*args, prob.obs_cam.clamp(min=0), prob.obs_uv, w)
    for a, b in zip(got, at_zero):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", DEVICES)
def test_solve_ba_is_the_same_on_every_run(device):
    """Two solves of one problem are equal bit for bit (on the card the
    atomic index_add_ made two runs part)."""
    prob = ba_problem(device_or_skip(device))
    a, b = local_ba.solve_ba(prob, 5, 10), local_ba.solve_ba(prob, 5, 10)
    for f in ("cam_pose", "points", "obs_inlier", "final_cost"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool(torch.isfinite(a.cam_pose).all()) and bool(torch.isfinite(a.points).all())
