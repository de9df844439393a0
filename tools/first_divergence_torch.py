"""Where the port's monocular session first parts from the JAX package's, frame
by frame and stage by stage, on the CPU.

    python tools/first_divergence_torch.py [--frames 24] [--out FILE]

Runs the session of tests/test_torch_slice.py (its SEQ: 24 frames of the
240x320 synthetic orbit, its small_config, the JAX initializer's RANSAC
draws fed to the port) in both packages, side by side, and records each
frame's stages:

    extract       keypoints, angles, descriptors (the frame's FrameFeatures)
    undistort     xy_und
    motion match  the cascade's matches (motion model, 2x window, reference
                  keyframe) and their count
    pose LM 1     Tcw after the first pose optimization, its inliers
    local map     the local-map matches
    pose LM 2     Tcw after the second pose optimization, its inliers
    keyframe      the keyframe decision
    map           the map after the frame: keyframe and point planes, poses
                  and positions (initialization, mapping passes, counters)

A stage differs when an integer plane has an entry that differs ("i<n>")
or a float plane a value that differs ("f<n>", with the largest difference
in ulps: float32 units in the last place). The last lines give the first
integer divergence, the keyframes each package created and both ATEs. The JAX tracking step is one fused program; its
stages come from a copy that also returns them, run on the same inputs, and
the tool checks that the copy's pose and matches equal the fused program's
(the copy is tools/fed_stages_torch.py's ``_jax_step_stages``).
Both packages run on the CPU; JAX with the flags of tests/conftest.py.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from fed_stages_torch import _jax_step_stages, _np, ulps  # noqa: E402
from test_torch_slice import SEQ, H, W, jax_draws, small_config  # noqa: E402
from weiner_slamit_v2_tpu import config as jconfig  # noqa: E402
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence  # noqa: E402
from weiner_slamit_v2_tpu.tracking import tracker as jtm  # noqa: E402
from weiner_slamit_v2_tpu.tracking.system import System as JSystem  # noqa: E402
from weiner_slamit_v2_torch import config as tconfig  # noqa: E402
from weiner_slamit_v2_torch.geometry.camera import Camera  # noqa: E402
from weiner_slamit_v2_torch.tracking import tracker as ttm  # noqa: E402
from weiner_slamit_v2_torch.tracking.system import System  # noqa: E402

STAGES = ("extract", "undistort", "motion match", "pose LM 1", "local map", "pose LM 2",
          "keyframe", "map")
# the tracking step's stages: outputs of tools/fed_stages_torch.py's JAX stage copy
STAGE_KEYS = {"motion match": ("obs_c", "n_c"), "pose LM 1": ("Tcw1", "obs_d", "n_i1"),
              "local map": ("obs_e",), "pose LM 2": ("Tcw2", "obs_f", "n_i2")}
MAP_FIELDS = ("kf_valid", "kf_pose", "kf_obs", "kf_xy", "kf_angle", "kf_desc", "mp_valid", "mp_pos",
              "mp_desc", "mp_normal", "mp_n_obs", "mp_obs_kf", "mp_visible", "mp_found", "n_kf", "n_mp")


def run_jax(frames, cfg, rec: list) -> JSystem:
    """The JAX session; appends one dict of stage results per frame to rec."""
    stages = jax.jit(_jax_step_stages, static_argnames=(
        "n_levels", "max_local_points", "local_kf_cap", "pose_rounds", "pose_iters", "histo_bins"))
    fused = jtm._track_step

    def step(*args, **kw):
        out = fused(*args, **kw)
        s = {k: _np(v) for k, v in stages(*args, **kw).items()}
        if not (np.array_equal(s["Tcw2"], _np(out[1])) and np.array_equal(s["obs_f"], _np(out[2]))):
            raise SystemExit("the instrumented JAX step differs from the fused one")
        rec[-1].update({st: tuple(s[k] for k in keys) for st, keys in STAGE_KEYS.items()})
        return out

    js = JSystem(cfg, JCamera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H))
    t = js.tracker
    for name in ("_extract_track", "_extract_init"):
        fn = getattr(t, name)

        def wrapped(img, fn=fn):
            f = fn(img)
            rec[-1]["extract"] = tuple(_np(v) for v in (f.xy, f.angle, _np(f.desc).view(np.int32),
                                                        f.octave, f.valid, f.response))
            rec[-1]["undistort"] = (_np(f.xy_und),)
            return f
        setattr(t, name, wrapped)
    jtm._track_step = step
    try:
        for fr in frames:
            rec.append({})
            out = js.track_monocular(fr.image, fr.timestamp)
            rec[-1]["keyframe"] = (np.asarray(bool(out.created_kf)),)
            rec[-1]["map"] = tuple(_np(getattr(t.m, f)) for f in MAP_FIELDS)
            rec[-1]["state"] = out.state
    finally:
        jtm._track_step = fused
    return js


def run_port(frames, cfg, rec: list) -> System:
    """The port's session (CPU), recording the same stages."""
    calls = []

    def recorder(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            calls.append(out)
            return out
        return wrapped

    names = ("_track_last_frame", "_match_reference_kf", "_pose_opt_on_obs", "_track_local_map")
    saved = {n: getattr(ttm, n) for n in names}
    for n in names:
        setattr(ttm, n, recorder(saved[n]))
    ts = System(cfg, Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H), device="cpu")
    ts.tracker.init_draws = jax_draws(cfg.seed)
    t = ts.tracker
    extract = t._extract

    def wrapped(image, initializing):
        f = extract(image, initializing)
        rec[-1]["extract"] = tuple(_np(v) for v in (f.xy, f.angle, f.desc, f.octave, f.valid,
                                                    f.response))
        rec[-1]["undistort"] = (_np(f.xy_und),)
        return f
    t._extract = wrapped
    tc = cfg.tracking
    try:
        for fr in frames:
            rec.append({})
            calls.clear()
            out = ts.track_monocular(fr.image, fr.timestamp)
            if len(calls) == 6:     # a tracking step ran: both windows, ref, LM, local, LM
                (oa, na), (ow, nw), (orf, nr), (T1, od, ni1), (oe, _), (T2, of, ni2) = calls
                widen = bool(na < tc.min_matches_motion)
                ob, nb = (ow, nw) if widen else (oa, na)
                oc, nc = (orf, nr) if bool(nb < tc.min_matches_motion) else (ob, nb)
                rec[-1].update({"motion match": (_np(oc), _np(nc)),
                                "pose LM 1": (_np(T1), _np(od), _np(ni1)),
                                "local map": (_np(oe),), "pose LM 2": (_np(T2), _np(of), _np(ni2))})
            rec[-1]["keyframe"] = (np.asarray(bool(out.created_kf)),)
            rec[-1]["map"] = tuple(_np(getattr(t.m, f)) for f in MAP_FIELDS)
            rec[-1]["state"] = out.state
    finally:
        for n in names:
            setattr(ttm, n, saved[n])
    return ts


def _ate(sys_, seq) -> float:
    """Scale-aligned ATE of a System's trajectory after finish()."""
    from weiner_slamit_v2_tpu.io.evaluation import ate_rmse

    sys_.finish()
    _, Twc = sys_.tracker.trajectory_Twc()
    return float(ate_rmse(np.asarray(Twc), seq.gt_Twc[-len(Twc):]))


def compare(a: tuple, b: tuple) -> str:
    """'=' or what differs: "i<n>" integer entries, "f<n>" float entries and
    their max ulps."""
    n_int, n_float, worst = 0, 0, 0
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            return f"shape {x.shape} vs {y.shape}"
        if x.dtype.kind == "f":
            x32, y32 = x.astype(np.float32), y.astype(np.float32)
            d = ~((x32 == y32) | (np.isnan(x32) & np.isnan(y32)))
            if d.any():
                n_float += int(d.sum())
                ok = d & np.isfinite(x32) & np.isfinite(y32)
                worst = max(worst, ulps(x32[ok], y32[ok]))
        else:
            n_int += int((x.astype(np.int64) != y.astype(np.int64)).sum())
    if n_int == 0 and n_float == 0:
        return "="
    return " ".join(([f"i{n_int}"] if n_int else []) + ([f"f{n_float} ({worst} ulp)"] if n_float else []))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=SEQ["n_frames"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    seq = make_synthetic_sequence(**{**SEQ, "n_frames": args.frames})
    jrec, trec = [], []
    jsys = run_jax(seq.frames, small_config(jconfig), jrec)
    tsys = run_port(seq.frames, small_config(tconfig), trec)
    lines = ["frame | JAX / port state | " + " | ".join(STAGES),
             "---|---|" + "---|" * len(STAGES)]
    first = None
    for i, (a, b) in enumerate(zip(jrec, trec)):
        cells = []
        for st in STAGES:
            if st in a and st in b:
                c = compare(a[st], b[st])
            elif st in a or st in b:
                c = "ran in one"
            else:
                c = "-"
            if first is None and c not in ("=", "-"):
                first = (i, st, c)
            cells.append(c)
        lines.append(f"{i} | {a['state']} / {b['state']} | " + " | ".join(cells))
    first_int = next(((i, st, c) for i, (a, b) in enumerate(zip(jrec, trec)) for st in STAGES
                      if st in a and st in b and "i" in (c := compare(a[st], b[st]))), None)
    lines.append("")
    lines.append("first divergence: " + (f"frame {first[0]}, {first[1]}: {first[2]}" if first
                                         else "none: every stage of every frame is equal"))
    lines.append("first integer divergence: " + (f"frame {first_int[0]}, {first_int[1]}: {first_int[2]}"
                                                 if first_int else "none"))
    lines.append(f"keyframes created: JAX {jsys.tracker.n_kf_host}, port {tsys.tracker.n_kf_host}; "
                 f"ATE (scale-aligned, OK frames after finish): JAX {_ate(jsys, seq):.5f} m, "
                 f"port {_ate(tsys, seq):.5f} m")
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
