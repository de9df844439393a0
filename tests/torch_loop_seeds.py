"""How often the injected-drift loop session of tests/test_loop.py closes a
loop and lowers the ATE, over seeds, in either package: the criterion of
tests/test_torch_loop_session.py (a closure, and the scale-aligned ATE of
the frames tracked before it lower after finish(), each frame against its
own ground truth), with ``cfg.seed`` set to each seed.

    python tests/torch_loop_seeds.py {jax,port,port-jax-draws} SEED [SEED ...] [--repo DIR]

``port`` uses the port's own random draws, ``port-jax-draws`` the JAX
package's (initializer, vocabulary, PnP and Sim3 RANSAC, as the session test
feeds them). ``--repo`` takes the packages from another checkout (e.g. an
older commit unpacked with ``git archive``); this file's directory still
provides the test helpers. One line of JSON per seed. A run takes ~2-3
minutes on one core; start one process per seed to use more. The counts in
PERF.md were taken with XLA_FLAGS="--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def run(mode: str, seed: int) -> dict:
    import jax
    import numpy as np

    from test_loop import FX, H, W, disjoint_out_and_back
    from test_torch_loop import drift_G, inject_drift, loop_session_config, t_
    from weiner_slamit_v2_tpu.io.evaluation import ate_rmse

    seq = disjoint_out_and_back()
    if mode == "jax":
        import jax.numpy as jnp

        from weiner_slamit_v2_tpu import config as jconfig
        from weiner_slamit_v2_tpu.geometry import se3
        from weiner_slamit_v2_tpu.geometry.camera import Camera
        from weiner_slamit_v2_tpu.tracking.system import System

        cfg = loop_session_config(jconfig).replace(seed=seed)
        sys_ = System(cfg, Camera.create(FX, FX, 159.5, 119.5, width=W, height=H),
                      enable_loop_closing=True)
        G = jnp.asarray(drift_G())
        drift = lambda m: inject_drift(  # noqa: E731
            m, jnp.where, se3.inv, se3.apply,
            lambda a, sel: jnp.isin(a, jnp.asarray(np.nonzero(np.asarray(sel))[0])), G)
    else:
        import torch

        from weiner_slamit_v2_torch import config as tconfig
        from weiner_slamit_v2_torch.geometry import se3
        from weiner_slamit_v2_torch.geometry.camera import Camera
        from weiner_slamit_v2_torch.tracking.system import System

        torch.set_num_threads(1)
        cfg = loop_session_config(tconfig).replace(seed=seed)
        sys_ = System(cfg, Camera.create(FX, FX, 159.5, 119.5, width=W, height=H), device="cpu",
                      enable_loop_closing=True)
        if mode == "port-jax-draws":
            from test_torch_reloc import use_jax_draws

            use_jax_draws(sys_.tracker, seed)
            sys_.loop_closer.sim3_draws = lambda k, n: t_(np.asarray(jax.random.randint(
                jax.random.PRNGKey(seed + 97 * k), (300, 3), 0, n)))
        G = torch.from_numpy(drift_G())
        drift = lambda m: inject_drift(  # noqa: E731
            m, torch.where, se3.inv, se3.apply,
            lambda a, sel: torch.isin(a, torch.nonzero(sel).flatten().int()), G)
    t, lc = sys_.tracker, sys_.loop_closer

    def traj_ate(n=None):
        ts, Twc = t.trajectory_Twc()
        idx = np.rint(np.asarray(ts[:n]) * 30.0).astype(int)
        return ate_rmse(Twc[:n], seq.gt_Twc[idx]), len(idx)

    t0, states, ate_pre, n_pre = time.time(), [], None, None
    for i, f in enumerate(seq.frames):
        states.append(sys_.track_monocular(f.image, f.timestamp).state)
        if i == 36:
            sys_.finish()
            t.m = drift(t.m)
        if i > 40 and lc.n_loops_closed == 0:
            sys_.finish()
            ate_pre, n_pre = traj_ate()
    sys_.finish()
    ate_post, _ = traj_ate(n_pre)
    closed = int(lc.n_loops_closed)
    return dict(mode=mode, seed=seed, closed=closed, ate_pre=ate_pre, ate_post=float(ate_post),
                ok_frames=sum(s == "OK" for s in states),
                closes_and_lowers=bool(closed >= 1 and ate_pre is not None and ate_post < ate_pre),
                seconds=round(time.time() - t0, 1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("jax", "port", "port-jax-draws"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--repo", default=os.path.dirname(HERE))
    a = ap.parse_args()
    sys.path[:0] = [os.path.abspath(a.repo), HERE]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    for seed in a.seeds:
        print(json.dumps(run(a.mode, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
