"""Distributed bundle adjustment: the Schur reduction summed over ranks (port
of weiner_slamit_v2_tpu/parallel/sharded_ba.py).

The map's points and their observation planes are split into equal
contiguous blocks, one per rank; cameras, K and bf are replicated. Each rank
builds its block's normal equations and marginalizes its points; the reduced
camera system ``S`` and ``b_red`` are summed with one ``all_reduce`` (JAX:
``psum`` inside ``shard_map``), every rank solves the small camera system
itself, and the point steps stay local. The two costs and the count of
non-finite point steps are summed in a second ``all_reduce`` per LM step,
so every rank takes the same accept decision; ``final_cost`` is summed once
at the end, and the points and inlier flags are gathered, so every rank
returns the whole ``BAResult``.

Each rank adds the clamped Marquardt damping of its own camera blocks before
the sum, as the JAX package does: the sharded result equals ``solve_ba``
only to the JAX tests' tolerance (tests/test_parallel.py:57), and JAX's
sharded result on the same partition much more closely.
"""

from __future__ import annotations

import atexit
import dataclasses
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..geometry import se3
from ..optim.local_ba import (
    CHI2_MONO, BAProblem, BAResult, _base_obs, _lm_phase, _per_obs_chi2_th, _total_cost,
)
from ..util import resolve_device

# the point-major fields that are split across ranks; the others replicate
_POINT_FIELDS = ("points", "point_valid", "obs_cam", "obs_uv", "obs_inv_sigma2", "obs_valid",
                 "obs_ur", "obs_has_ur")


@dataclass
class BAMesh:
    """The ranks a distributed BA runs over: a process group (None: the
    default one), this process's rank, the world size and its device."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    all_reduces: int = 0     # all_reduce calls made through all_sum

    def all_sum(self, *tensors):
        """The sums over ranks of ``tensors``, in one ``all_reduce`` of a
        packed float32 buffer (counts stay exact below 2^24)."""
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return tuple(out)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, concatenated in rank order."""
        if self.world_size == 1:
            return x
        send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.world_size)]
        dist.all_gather(parts, send, group=self.group)
        out = torch.cat(parts)
        return out.bool() if x.dtype == torch.bool else out


def make_ba_mesh(device=None) -> BAMesh:
    """A mesh over the default process group; with none initialized, a
    world-size-1 group on a file store in a temporary directory (so a single
    process needs no launcher), NCCL on the card, gloo on the CPU."""
    from . import multihost

    if not dist.is_initialized():
        store = tempfile.mkdtemp(prefix="ba_mesh_")
        atexit.register(shutil.rmtree, store, True)
        device = multihost.initialize(device, init_method=f"file://{store}/store",
                                      world_size=1, rank=0)
    return multihost.global_mesh(device)


def shard_problem(prob: BAProblem, mesh: BAMesh) -> BAProblem:
    """This rank's problem: its contiguous block of P / world_size point rows
    (and their observation planes, stereo ones included), the camera arrays,
    K and bf whole, all on the mesh's device."""
    P = prob.points.shape[0]
    if P % mesh.world_size:
        raise ValueError(f"{P} point slots do not split evenly over {mesh.world_size} ranks")
    n = P // mesh.world_size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    kw = {}
    for f in dataclasses.fields(prob):
        v = getattr(prob, f.name)
        if v is not None:
            v = (v[rows] if f.name in _POINT_FIELDS else v).to(mesh.device)
        kw[f.name] = v
    return BAProblem(**kw)


def solve_ba_sharded(prob: BAProblem, mesh: BAMesh, iters1: int = 5, iters2: int = 10,
                     chi2_th: float = CHI2_MONO, lambda_init: float = 1e-4) -> BAResult:
    """Two-phase LM BA over ``prob``, this rank's block (``shard_problem``):
    ``solve_ba``'s schedule with the sums above. Returns the whole result on
    every rank; ``final_cost`` is the summed non-robust cost over the
    refinement's inlier set, as the JAX package's sharded solver computes it."""
    reduce = mesh.all_sum
    base = _base_obs(prob)
    th = _per_obs_chi2_th(prob, chi2_th)
    cam_pose, points, _ = _lm_phase(prob, prob.cam_pose, prob.points, base, True, iters1,
                                    lambda_init, reduce)
    _, chi2, z = _total_cost(cam_pose, points, prob, base, True)
    inlier = base & (chi2 <= th) & (z > 0)
    # the refinement restarts its damping at lambda_init
    cam_pose, points, _ = _lm_phase(prob, cam_pose, points, inlier, False, iters2, lambda_init,
                                    reduce)
    cam_pose = se3.orthonormalize(cam_pose)
    final_cost, chi2, z = _total_cost(cam_pose, points, prob, inlier, False)
    obs_inlier = base & (chi2 <= th) & (z > 0)
    (final_cost,) = reduce(final_cost)
    return BAResult(cam_pose=cam_pose, points=mesh.gather_rows(points),
                    obs_inlier=mesh.gather_rows(obs_inlier), final_cost=final_cost)
