"""Essential-graph optimization over Sim3 keyframe poses (port of
weiner_slamit_v2_tpu/optim/pose_graph.py; Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:781-1044).

Every edge residual r_e = log(S_meas^-1 S_j S_i^-1) is evaluated in one
batch; its two (7, 7) Jacobians come from forward-mode autodiff, one
``jvp`` per tangent direction over all edges at once (each residual depends
on its own edge's 7-vectors only), the 14 directions batched by ``vmap``.
The normal equations are solved dense (Cholesky of the (7K, 7K) system) or by
block-Jacobi preconditioned CG on the block-sparse system (two
``util.index_add`` scatters per product); ``solver="auto"`` picks dense up to
320 keyframe slots. The LM accept / reject and the damping stay on the
device: no host read per iteration.
"""

from __future__ import annotations

import torch
from torch.func import jvp, vmap

from ..geometry import sim3
from ..util import index_add


def _solve_dense(D, Hij, ei, ej, off_ok, b):
    """Materialize the (7K, 7K) system and solve it by Cholesky."""
    K = D.shape[0]
    Ho = Hij * off_ok[:, None, None]
    H = torch.zeros((K * K, 7, 7), dtype=D.dtype, device=D.device)
    ar = torch.arange(K, device=D.device)
    H[ar * K + ar] = D
    index_add(H, ei * K + ej, Ho)
    index_add(H, ej * K + ei, Ho.transpose(-1, -2))
    Hd = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    Hd = Hd + 1e-8 * torch.eye(K * 7, dtype=D.dtype, device=D.device)
    L, _ = torch.linalg.cholesky_ex(Hd)
    return torch.cholesky_solve(b.reshape(-1, 1), L).reshape(K, 7)


def _solve_pcg(D, Hij, ei, ej, off_ok, b, cg_iters: int):
    """Block-Jacobi preconditioned CG; H is never materialized. The loop
    always runs cg_iters steps, freezing the state once converged."""
    Ho = Hij * off_ok[:, None, None]
    HoT = Ho.transpose(-1, -2)

    def matvec(x):
        y = (D @ x[..., None])[..., 0]
        y = index_add(y, ei, (Ho @ x[ej][..., None])[..., 0])
        return index_add(y, ej, (HoT @ x[ei][..., None])[..., 0])

    Minv = torch.linalg.inv_ex(D + 1e-8 * torch.eye(7, dtype=D.dtype, device=D.device))[0]
    precond = lambda r: (Minv @ r[..., None])[..., 0]  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    rz = (r * z).sum()
    b2 = torch.clamp((b * b).sum(), min=1e-30)
    for _ in range(cg_iters):
        done = (r * r).sum() <= 1e-12 * b2
        Ap = matvec(p)
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
        x_n, r_n = x + alpha * p, r - alpha * Ap
        z_n = precond(r_n)
        rz_n = (r_n * z_n).sum()
        p_n = z_n + rz_n / torch.clamp(rz, min=1e-30) * p
        x, r, p, rz = (torch.where(done, old, new) for new, old in
                       ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return x


def _edge_residual(xi_i, xi_j, Si, Sj, Sm_inv):
    """r = log(S_meas^-1 exp(xi_j) Sj (exp(xi_i) Si)^-1), batched over edges."""
    return sim3.log(Sm_inv @ (sim3.exp(xi_j) @ Sj) @ sim3.inv(sim3.exp(xi_i) @ Si))


def optimize_pose_graph(S_init, kf_valid, fixed, edge_i, edge_j, edge_S_ji, edge_valid,
                        n_iters: int = 20, lambda_init: float = 1e-6, fix_scale: bool = False,
                        solver: str = "auto", cg_iters: int = 64) -> torch.Tensor:
    """Optimized (K, 4, 4) Sim3 poses (world -> keyframe). ``fixed`` marks
    the gauge; edges (E,) carry the measured relative Sim3 S_j S_i^-1.
    fix_scale freezes every vertex's log-scale (stereo / RGB-D maps are
    metric, src/Optimizer.cc:818). solver: "dense", "pcg" or "auto"."""
    if solver == "auto":
        solver = "dense" if S_init.shape[0] <= 320 else "pcg"
    K = S_init.shape[0]
    E = edge_i.shape[0]
    dev, dt = S_init.device, S_init.dtype
    ei, ej = edge_i.clamp(min=0).long(), edge_j.clamp(min=0).long()
    ev = edge_valid & (edge_i >= 0) & (edge_j >= 0) & kf_valid[ei] & kf_valid[ej]
    Sm_inv = sim3.inv(edge_S_ji)
    free = kf_valid & ~fixed
    zero = torch.zeros((E, 7), dtype=dt, device=dev)
    # the 14 tangent directions: d/dxi_i (7), then d/dxi_j (7), each for all edges
    basis = torch.eye(7, dtype=dt, device=dev)[:, None, :].expand(7, E, 7)
    tan_i = torch.cat([basis, torch.zeros_like(basis)])
    tan_j = torch.cat([torch.zeros_like(basis), basis])

    def cost_of(S):
        r = _edge_residual(zero, zero, S[ei], S[ej], Sm_inv)
        return torch.where(ev[:, None], r * r, 0.0).sum()

    S = S_init
    lam = torch.full((), lambda_init, dtype=dt, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    sel = torch.arange(7, device=dev) == 6
    kill = sel[None, :, None] | sel[None, None, :]
    for _ in range(n_iters):
        Si, Sj = S[ei], S[ej]
        f = lambda a, b: _edge_residual(a, b, Si, Sj, Sm_inv)  # noqa: E731
        r = f(zero, zero)
        dirs = vmap(lambda ti, tj: jvp(f, (zero, zero), (ti, tj))[1])(tan_i, tan_j)  # (14, E, 7)
        w = ev.to(dt)
        Ji = dirs[:7].permute(1, 2, 0) * w[:, None, None]          # (E, 7 residual, 7 dof)
        Jj = dirs[7:].permute(1, 2, 0) * w[:, None, None]

        Hii = Ji.transpose(-1, -2) @ Ji
        Hjj = Jj.transpose(-1, -2) @ Jj
        Hij = Ji.transpose(-1, -2) @ Jj
        rw = (r * w[:, None])[..., None]
        bi = -(Ji.transpose(-1, -2) @ rw)[..., 0]
        bj = -(Jj.transpose(-1, -2) @ rw)[..., 0]
        D = index_add(index_add(torch.zeros((K, 7, 7), dtype=dt, device=dev), ei, Hii), ej, Hjj)
        b = index_add(index_add(torch.zeros((K, 7), dtype=dt, device=dev), ei, bi), ej, bj)

        # LM damping on the diagonal blocks
        damp = lam * torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-6)
        D = D + damp[:, :, None] * eye7
        # fixed / invalid vertices: identity block, zero rhs, no off-diagonal
        D = torch.where(free[:, None, None], D, eye7)
        b = torch.where(free[:, None], b, 0.0)
        off_ok = (free[ei] & free[ej]).to(dt)
        Hoff = Hij
        if fix_scale:
            # the sigma dof: zero row and column, unit diagonal -> dx[:, 6] == 0
            D = torch.where(kill, 0.0, D)
            D[:, 6, 6] = 1.0
            Hoff = torch.where(kill, 0.0, Hij)
            b = torch.where(sel[None, :], 0.0, b)
        if solver == "dense":
            dx = _solve_dense(D, Hoff, ei, ej, off_ok, b)
        else:
            dx = _solve_pcg(D, Hoff, ei, ej, off_ok, b, cg_iters)
        dx = torch.where(free[:, None], dx, 0.0)

        S_new = sim3.exp(dx) @ S
        ok = (cost_of(S_new) < cost_of(S)) & torch.isfinite(S_new).all()
        S = torch.where(ok, S_new, S)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 8.0), 1e-8, 1e3)
    return S


def correct_map_after_pose_graph(mp_pos, mp_valid, mp_ref_kf, S_old, S_new) -> torch.Tensor:
    """X' = S_new_ref^-1 S_old_ref X for each point's reference keyframe
    (src/Optimizer.cc:1015-1041)."""
    corr = sim3.inv(S_new) @ S_old
    Xc = sim3.apply(corr[mp_ref_kf.clamp(min=0).long()], mp_pos)
    ok = mp_valid & (mp_ref_kf >= 0)
    return torch.where(ok[:, None], Xc, mp_pos)
