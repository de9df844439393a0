"""A whole loop-closing session in the port, on the CPU: the injected-drift
out-and-back of tests/test_loop.py::TestLoopClosureEndToEnd (the JAX
package's frames, its config, its per-frame finish() after frame 40) with
``System(..., device="cpu", enable_loop_closing=True)``, fed the JAX
session's random draws (initializer, vocabulary, PnP and Sim3 RANSAC) as the
other session tests are, so that it starts as the JAX session does. It
asserts what the JAX test asserts: a loop closes and the scale-aligned ATE of
the frames tracked before the closure drops. Over random draws that outcome
is a coin toss in both packages (tests/torch_loop_seeds.py: over seeds 0-27
the JAX session meets it in 19 runs, the port with its own draws in 16), so
any one seed's result moves with a 1-ulp change anywhere in the session.
Whole sessions of the two packages part after the first adopted mapping pass
(float summation order, ROADMAP C), so this session is not compared with
the JAX one step by step; tests/test_torch_loop.py holds the stages on the
JAX session's own state."""

import jax
import numpy as np
import torch
from test_loop import FX, H, W, disjoint_out_and_back
from test_torch_loop import drift_G, inject_drift, loop_session_config, t_
from test_torch_reloc import use_jax_draws

from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry import se3
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)


def traj_ate(t, seq, n=None):
    """Scale-aligned ATE of the first n trajectory entries (all: None);
    the frames' timestamps are i / 30."""
    ts, Twc = t.trajectory_Twc()
    idx = np.rint(np.asarray(ts[:n]) * 30.0).astype(int)
    return ate_rmse(Twc[:n], seq.gt_Twc[idx]), len(idx)


def test_port_session_closes_the_loop_and_lowers_ate():
    seq = disjoint_out_and_back()
    cfg = loop_session_config(tconfig)
    sys_ = System(cfg, Camera.create(FX, FX, 159.5, 119.5, width=W, height=H), device="cpu",
                  enable_loop_closing=True)
    t, lc = sys_.tracker, sys_.loop_closer
    use_jax_draws(t, cfg.seed)
    lc.sim3_draws = lambda k, n: t_(np.asarray(jax.random.randint(
        jax.random.PRNGKey(cfg.seed + 97 * k), (300, 3), 0, n)))
    gba_issued, ate_pre, n_pre, states = [], None, None, []
    enqueue = lc._enqueue_global_ba

    def counting_enqueue(gauge_kf):
        gba_issued.append(lc.gba_chunks_issued)
        enqueue(gauge_kf)

    lc._enqueue_global_ba = counting_enqueue
    for i, f in enumerate(seq.frames):
        states.append(sys_.track_monocular(f.image, f.timestamp).state)
        if i == 36:
            sys_.finish()
            t.m = inject_drift(t.m, torch.where, se3.inv, se3.apply,
                               lambda a, sel: torch.isin(a, torch.nonzero(sel).flatten().int()),
                               torch.from_numpy(drift_G()))
        if i > 40 and lc.n_loops_closed == 0:
            sys_.finish()
            ate_pre, n_pre = traj_ate(t, seq)
    sys_.finish()
    # the frames tracked before the closure, each against its own ground
    # truth (the JAX test's gt[-len(Twc):] is aligned only at the end)
    ate_post, _ = traj_ate(t, seq, n_pre)

    assert lc.n_loops_closed >= 1 and lc.last_loop_kf >= 0
    assert ate_pre is not None and np.isfinite(ate_post) and ate_post < ate_pre, (ate_pre, ate_post)
    assert sum(s == "OK" for s in states) > 60, states
    # finish() adopted the last global BA: 1 robust phase + ceil(15 / 5)
    # refinement chunks for it (earlier ones may have been superseded)
    assert lc._pending_gba is None and gba_issued
    assert lc.gba_chunks_issued - gba_issued[-1] == 1 + -(-(cfg.optim.global_ba_iters - 5)
                                                         // cfg.tracking.ba_chunk_iters)
    m = sys_.map
    poses = m.kf_pose[m.kf_valid].numpy()
    assert np.isfinite(poses).all() and np.isfinite(m.mp_pos[m.mp_valid].numpy()).all()
    R = poses[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-4)
    assert all(i < j for i, j, _ in lc.loop_edges) and lc.loop_edges[-1][1] == lc.last_loop_kf
