"""The motion-only pose LM (optim/pose_opt.py::optimize_pose) as one launch
of csrc/pose_lm.cu: n_rounds x n_iters Levenberg-Marquardt iterations, the
6x6 solves and the chi2 reclassifications in one thread block.

It replaces no TPU kernel: the JAX package's pose LM is one jit program
with no Pallas kernel. On the card the plain form
(``pose_opt.optimize_pose_plain``) is ~8,400 launches a call, each a few us
of device time, enqueued one by one by the host. The kernel is bound by the
serial chain of its 40 dependent iterations (two block-wide reductions and
one thread's solve each), not by bytes or operations (~28 KB and ~6.5 MFLOP
a call at N = 1024).

``pose_lm`` is the wrapper ``optimize_pose`` calls for CUDA tensors;
``launches`` counts its launches.
"""

from __future__ import annotations

import torch

from . import cuda_build

launches = 0
MAX_N = 6144   # csrc/pose_lm.cu MAX_N: the observations staged in shared memory


def pose_lm(Tcw0, X, uv, inv_sigma2, valid, K, n_rounds: int, n_iters: int, chi2_th: float,
            lambda_init: float, ur=None, bf: float = 0.0):
    """optimize_pose's arguments and results (Tcw (4,4) float32, inliers (N,)
    bool, n_inliers () int64), on contiguous CUDA tensors; ``ur`` None for a
    monocular problem. Launches on the current stream, no synchronization."""
    global launches
    n = X.shape[0] if X.dim() == 2 else -1
    spec = {"Tcw0": (Tcw0, torch.float32, (4, 4)), "X": (X, torch.float32, (n, 3)),
            "uv": (uv, torch.float32, (n, 2)), "inv_sigma2": (inv_sigma2, torch.float32, (n,)),
            "valid": (valid, torch.bool, (n,)), "K": (K, torch.float32, (3, 3))}
    if ur is not None:
        spec["ur"] = (ur, torch.float32, (n,))
    for name, (t, dtype, shape) in spec.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"pose_lm: {name} must be a contiguous {dtype} {shape} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}"
                             f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    dev = X.device
    if dev.type != "cuda" or any(t.device != dev for t, _, _ in spec.values()):
        raise ValueError(f"pose_lm: needs every tensor on one CUDA device, got "
                         f"{sorted({str(t.device) for t, _, _ in spec.values()})}")
    if n > MAX_N:
        raise ValueError(f"pose_lm: at most {MAX_N} observations, got {n}")
    Tcw = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty((n,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    # C order: T0, X, uv, inv_sigma2, valid, K, ur, N, n_rounds, n_iters,
    # chi2_th, lambda_init, bf, the outputs (Tcw, inliers, n_inliers), stream
    err = cuda_build.lib().pose_lm_launch(
        Tcw0.data_ptr(), X.data_ptr(), uv.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(),
        K.data_ptr(), None if ur is None else ur.data_ptr(), n, n_rounds, n_iters,
        float(chi2_th), float(lambda_init), float(bf), Tcw.data_ptr(), inliers.data_ptr(),
        n_inliers.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "pose_lm")
    launches += 1
    return Tcw, inliers, n_inliers
