"""Every stage of the monocular back end fed a reference session's own state,
frame by frame: the port's stage against the reference's on the same inputs.

    python tools/fed_stages_torch.py [--session slice|staged|bench] [--frames N] [--scale S]
                                     [--out FILE]

The reference is the JAX package's session (this tool; JAX on the CPU with
the flags of tests/conftest.py), or the port's own session on the CPU
(chip_smoke.py phase 21, which feeds the card). For every frame it records
each stage's inputs and outputs; the port's stage is then run on the
reference's inputs for that stage on that frame (not on the port's own
earlier outputs) and its outputs compared:

    1 motion        the motion-model matches (window, 2x window, reference
                    keyframe), their counts and the selection
    2 pose LM 1     the first pose optimization: pose, kept matches, inliers
    3 local map     the local-map matches and the visible mask
    4 pose LM 2     the second pose optimization
    5 decision      the point counters, packed scalars, velocity, and the
                    keyframe decision (NeedNewKeyFrame on the same scalars)
    6 keyframe      keyframe creation (the map after it) and the BoW index
                    after its registration (vocabulary, rows)
    7 mapping pre   the mapping pass up to the BA (cull, triangulate, fuse,
                    statistics, the BA problem)
    8 local BA      the BA on the reference's problem (solve_ba, or the
                    staged ba_phase1 / ba_phase2_chunk / ba_finalize)
    9 mapping finish  write-back and keyframe culling

An integer entry that differs is counted; a float's difference is given in
ulps (float32 units in the last place). For each stage with differing
integer entries, ``explain`` names the float gate that decided them where
it can (the value in both packages and its distance from the threshold).

Sessions (24 frames of the 240x320 orbit of tests/test_torch_slice.py by
default): ``slice`` is that test's small_config (abortable_ba=False);
``staged`` the same frames and capacities under the default TrackingConfig
(the staged, abortable BA that bench.py's configuration uses); ``bench``
the bench geometry (bench.py:50-80: 480x640, fx = fy = 500, 1024 features,
8 levels, the 164-frame orbit pace, abortable_ba=False).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from weiner_slamit_v2_torch.bow import database as tdb  # noqa: E402
from weiner_slamit_v2_torch.bow import vocabulary as tvoc  # noqa: E402
from weiner_slamit_v2_torch.optim import local_ba as tba  # noqa: E402
from weiner_slamit_v2_torch.slam_map import types as tmt  # noqa: E402
from weiner_slamit_v2_torch.slam_map.convert import features_from_numpy, map_from_numpy  # noqa: E402
from weiner_slamit_v2_torch.tracking import local_mapping as tlm  # noqa: E402
from weiner_slamit_v2_torch.tracking import system as tsys  # noqa: E402
from weiner_slamit_v2_torch.tracking import tracker as ttm  # noqa: E402

STAGES = ("motion", "pose LM 1", "local map", "pose LM 2", "decision", "keyframe",
          "mapping pre", "local BA", "mapping finish")
BA_FNS = ("solve_ba", "ba_phase1", "ba_phase2_chunk", "ba_finalize")
CHI2_MONO = 5.991


# --- numpy records -------------------------------------------------------------

def _np(x):
    """A tensor or array as numpy; uint32 (JAX descriptors, packed bits) as
    the port's int32 bit patterns."""
    if x is None:
        return None
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def fields(obj) -> dict:
    """A dataclass (the port's or a flax one) as a dict of numpy arrays."""
    return {f.name: _np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _t(a, dev):
    return None if a is None else torch.from_numpy(np.array(a)).to(dev)


def _problem(d: dict, dev) -> tba.BAProblem:
    return tba.BAProblem(**{k: _t(v, dev) for k, v in d.items()})


def _result(d: dict, dev) -> tba.BAResult:
    return tba.BAResult(**{k: _t(v, dev) for k, v in d.items()})


def _bow_state(bow) -> dict:
    """A BoW index (either package's) as numpy: vocabulary, database rows and
    the keyframes waiting for a vocabulary."""
    st = {"ready": np.asarray(bow.vocab is not None),
          "pending": np.asarray([int(k) for k, _, _ in bow._pending], np.int32)}
    if bow.vocab is not None:
        v = bow.vocab
        for i, (d, ok) in enumerate(zip(v.level_desc, v.level_valid)):
            st[f"level{i}_desc"], st[f"level{i}_valid"] = _np(d), _np(ok)
        st["word_idf"] = _np(v.word_idf)
        st["db_bow"], st["db_has_entry"] = _np(bow.db.bow), _np(bow.db.has_entry)
    return st


def _port_bow(st: dict, m, max_kf: int, dev) -> tdb.BowIndex:
    """The port's BowIndex in the state ``st`` (waiting keyframes take their
    rows from the map ``m``)."""
    bow = tdb.BowIndex(max_kf, device=dev)
    if bool(st["ready"]):
        L = sum(1 for k in st if k.endswith("_desc"))
        bow.vocab = tvoc.Vocabulary(
            level_desc=tuple(_t(st[f"level{i}_desc"], dev) for i in range(L)),
            level_valid=tuple(_t(st[f"level{i}_valid"], dev) for i in range(L)),
            word_idf=_t(st["word_idf"], dev), branching=bow.branching, depth=bow.depth)
        bow.db = tdb.KeyframeDatabase(bow=_t(st["db_bow"], dev), has_entry=_t(st["db_has_entry"], dev))
    bow._pending = [(int(k), m.kf_desc[int(k)], m.kf_feat_valid[int(k)]) for k in st["pending"]]
    return bow


# --- the port's stages -----------------------------------------------------------

def step_inputs(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw, ref_kf,
                local_th, bounds) -> dict:
    """The inputs of one tracking step, as numpy (velocity None: none yet)."""
    return {"m": fields(m), "feats": fields(feats), "last_obs": _np(last_obs),
            "last_octave": _np(last_octave), "last_angle": _np(last_angle),
            "has_velocity": velocity is not None,
            "velocity": _np(velocity) if velocity is not None else np.eye(4, dtype=np.float32),
            "last_Tcw": _np(last_Tcw), "ref_kf": int(ref_kf), "local_th": float(local_th),
            "bounds": _np(bounds)}


def port_step(inp: dict, consts: dict, cfg, dev, ref: dict | None = None):
    """Stages 1-5 (without the decision) of the port on the step inputs
    ``inp``. ref: a reference's outputs (the dict this returns): each stage
    then takes its inputs from ref instead of the port's stage before it.
    Returns (outputs as tensors, the step's StepResult)."""
    m = map_from_numpy(inp["m"], dev)
    feats = features_from_numpy(inp["feats"], dev)
    K, sf, isig2 = (_t(consts[k], dev) for k in ("K", "scale_factors", "inv_sigma2"))
    t, mc, o = cfg.tracking, cfg.matcher, cfg.optim
    nl, hb = cfg.orb.n_levels, mc.histo_length
    last_obs, last_oct, last_ang, last_Tcw = (_t(inp[k], dev) for k in (
        "last_obs", "last_octave", "last_angle", "last_Tcw"))
    ref_kf = inp["ref_kf"]
    out = {}

    def given(key, own):
        return _t(ref[key], dev) if ref is not None else own

    out["Tcw_pred"] = (ttm.se3.matmul(_t(inp["velocity"], dev), last_Tcw) if inp["has_velocity"]
                       else last_Tcw)
    Tcw_pred = given("Tcw_pred", out["Tcw_pred"])

    def motion(window):
        return ttm._track_last_frame(m, feats, last_obs, last_oct, last_ang, Tcw_pred, K, window,
                                     sf, nl, mc.nn_ratio_motion, mc.th_high, hb)

    out["obs_a"], out["n_a"] = motion(t.motion_search_window)
    out["obs_w"], out["n_w"] = motion(2.0 * t.motion_search_window)
    out["obs_r"], out["n_r"] = ttm._match_reference_kf(m, feats, ref_kf, mc.nn_ratio_refkf,
                                                       mc.th_low, hb)
    widen = out["n_a"] < t.min_matches_motion
    obs_b = torch.where(widen, out["obs_w"], out["obs_a"])
    n_b = torch.where(widen, out["n_w"], out["n_a"])
    need_ref = n_b < t.min_matches_motion
    out["need_ref"] = need_ref
    out["obs_c"] = torch.where(need_ref, out["obs_r"], obs_b)
    out["n_c"] = torch.where(need_ref, out["n_r"], n_b)
    out["Tcw0"] = torch.where(need_ref, last_Tcw, Tcw_pred)
    enough = out["n_c"] >= torch.where(need_ref, t.min_matches_refkf, t.min_matches_motion)

    def pose_lm(obs, Tcw):
        return ttm._pose_opt_on_obs(m, feats, obs, Tcw, K, isig2, o.pose_opt_rounds,
                                    o.pose_opt_iters, o.lm_lambda_init)

    out["Tcw1"], out["obs_d"], out["n_i1"] = pose_lm(given("obs_c", out["obs_c"]),
                                                     given("Tcw0", out["Tcw0"]))
    out["ok1"] = given("enough", enough) & (out["n_i1"] >= t.min_inliers_motion)
    out["enough"] = enough
    Tcw1 = given("Tcw1", out["Tcw1"])
    out["obs_e"], out["visible"] = ttm._track_local_map(
        m, feats, given("obs_d", out["obs_d"]), Tcw1, K, sf, inp["local_th"], nl,
        mc.nn_ratio_localmap, mc.th_high, cfg.capacity.local_ba_points, t.local_map_kf_cap,
        _t(inp["bounds"], dev))
    out["Tcw2"], out["obs_f"], out["n_i2"] = pose_lm(given("obs_e", out["obs_e"]), Tcw1)
    r = ttm._step_tail(m, feats, given("obs_f", out["obs_f"]), given("visible", out["visible"]),
                       given("ok1", out["ok1"]), given("n_c", out["n_c"]),
                       given("need_ref", out["need_ref"]), given("n_i1", out["n_i1"]),
                       given("n_i2", out["n_i2"]), given("Tcw2", out["Tcw2"]), last_Tcw, ref_kf)
    out.update(mp_visible=r.m.mp_visible, mp_found=r.m.mp_found, scalars=r.scalars,
               inc_vis=r.inc[0], inc_found=r.inc[1], velocity=r.velocity, T_cr=r.T_cr)
    return out, r


# which outputs of port_step each stage compares
STEP_KEYS = {
    "motion": ("Tcw_pred", "obs_a", "n_a", "obs_w", "n_w", "obs_r", "n_r", "need_ref", "obs_c",
               "n_c", "Tcw0"),
    "pose LM 1": ("Tcw1", "obs_d", "n_i1", "ok1"),
    "local map": ("obs_e", "visible"),
    "pose LM 2": ("Tcw2", "obs_f", "n_i2"),
    "decision": ("mp_visible", "mp_found", "scalars", "inc_vis", "inc_found", "velocity", "T_cr"),
}


def decision_inputs(tracker, args, frame_id, idle_calls) -> dict:
    n_inliers, n_ref, n_kf_valid, n_close_t, n_close_u = args
    return dict(n_inliers=int(n_inliers), n_ref=int(n_ref), n_kf_valid=int(n_kf_valid),
                n_close_t=int(n_close_t), n_close_u=int(n_close_u),
                frame_id=int(tracker.frame_id if frame_id is None else frame_id),
                last_kf_frame=int(tracker.last_kf_frame),
                last_reloc_frame=int(tracker.last_reloc_frame), n_kf_host=int(tracker.n_kf_host),
                allow_keyframes=bool(tracker.allow_keyframes), max_kf=int(tracker.m.max_kf),
                idle=[tuple(c) for c in idle_calls])


def port_decision(inp: dict, cfg) -> dict:
    """NeedNewKeyFrame of the port on the reference's scalars and host state;
    the mapper's idle answers are the reference's, in order."""
    calls = []

    def idle(force=False, abort=False):
        ans = inp["idle"][len(calls)][2] if len(calls) < len(inp["idle"]) else True
        calls.append((force, abort, ans))
        return ans

    ns = SimpleNamespace(cfg=cfg, frame_id=inp["frame_id"], allow_keyframes=inp["allow_keyframes"],
                         n_kf_host=inp["n_kf_host"], m=SimpleNamespace(max_kf=inp["max_kf"]),
                         last_reloc_frame=inp["last_reloc_frame"],
                         last_kf_frame=inp["last_kf_frame"], mapper_idle_hook=idle)
    d = ttm.Tracker._need_new_keyframe(ns, inp["n_inliers"], inp["n_ref"], inp["n_kf_valid"],
                                       inp["n_close_t"], inp["n_close_u"], frame_id=inp["frame_id"])
    return {"decision": np.asarray(bool(d)), "idle": np.asarray(calls, np.int32).reshape(-1, 3)}


def port_keyframe(inp: dict, dev) -> dict:
    """Freeze the frame into a keyframe (the map after mt.add_keyframe)."""
    m, kf = tmt.add_keyframe(map_from_numpy(inp["m"], dev), _t(inp["Tcw"], dev),
                             *(_t(inp["feats"][k], dev).view(torch.int32) if k == "desc"
                               else _t(inp["feats"][k], dev)
                               for k in ("xy_und", "octave", "angle", "desc", "valid")),
                             _t(inp["cur_obs"], dev), int(inp["frame_id"]), float(inp["ts"]),
                             int(inp["parent"]))
    return {**fields(m), "kf_id": np.asarray(kf)}


def port_bow(inp: dict, m_after: dict, cfg, dev) -> dict:
    """The BoW registration of keyframe inp["kf"] (_register_kf_bow) from the
    reference's index state before it, on the reference's map after the
    keyframe; the vocabulary draws are the reference's."""
    m = map_from_numpy(m_after, dev)
    draws = [_t(d, dev) for d in inp["draws"]] if inp["draws"] is not None else None
    ns = SimpleNamespace(m=m, bow=_port_bow(inp["before"], m, m.max_kf, dev),
                         n_kf_host=inp["n_kf_host"], cfg=cfg, frame_id=inp["frame_id"],
                         vocab_draws=lambda seed, n: draws, vocab_trainings=[])
    ttm.Tracker._register_kf_bow(ns, inp["kf"])
    return _bow_state(ns.bow)


def port_mapping(call: dict, consts: dict, cfg, dev):
    """One call of the mapping pass (mapping pre, a BA piece, mapping finish)
    on the reference's inputs; its outputs as numpy."""
    fn, inp = call["fn"], call["in"]
    if fn == "mapping pre":
        c = [_t(consts[k], dev) for k in ("K", "scale_factors", "sigma2", "inv_sigma2")]
        m, prob, cam_ids, point_ids = tlm.mapping_pre(map_from_numpy(inp["m"], dev), inp["kf"], *c,
                                                      cfg, n_neighbors=inp["n_neighbors"])
        return {"m": fields(m), "prob": fields(prob), "cam_ids": _np(cam_ids),
                "point_ids": _np(point_ids)}
    if fn == "mapping finish":
        res = _result(inp["res"], dev) if inp["res"] is not None else None
        prob = _problem(inp["prob"], dev) if inp["prob"] is not None else None
        m = tlm.mapping_finish(map_from_numpy(inp["m"], dev), inp["kf"], res, prob,
                               _t(inp["cam_ids"], dev), _t(inp["point_ids"], dev), cfg)
        return {"m": fields(m)}
    prob = _problem(inp["prob"], dev)
    if fn == "solve_ba":
        return {"res": fields(tba.solve_ba(prob, inp["iters1"], inp["iters2"]))}
    if fn == "ba_phase1":
        cam, pts, lam, inl = tba.ba_phase1(prob, n_iters=inp["n_iters"])
        return {"cam_pose": _np(cam), "points": _np(pts), "lam": _np(lam), "inlier": _np(inl)}
    if fn == "ba_phase2_chunk":
        cam, pts, lam = tba.ba_phase2_chunk(prob, _t(inp["cam_pose"], dev), _t(inp["points"], dev),
                                            _t(inp["lam"], dev), _t(inp["inlier"], dev),
                                            n_iters=inp["n_iters"])
        return {"cam_pose": _np(cam), "points": _np(pts), "lam": _np(lam)}
    if fn == "ba_finalize":
        return {"res": fields(tba.ba_finalize(prob, _t(inp["cam_pose"], dev),
                                              _t(inp["points"], dev)))}
    raise ValueError(fn)


MAPPING_STAGE = {"mapping pre": "mapping pre", "mapping finish": "mapping finish",
                 **{fn: "local BA" for fn in BA_FNS}}


# --- comparison --------------------------------------------------------------------

def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bit patterns as integers ordered like the floats."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest float32 distance in ulps between finite a and b."""
    ok = np.isfinite(a) & np.isfinite(b)
    return int(np.abs(_ordered(a[ok]) - _ordered(b[ok])).max()) if ok.any() else 0


def _flat(d, prefix="") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def compare(ref: dict, port: dict) -> dict:
    """{"int": integer entries differing, "float": float entries differing,
    "ulps" / "abs": the largest float difference in ulps / absolute, "keys":
    {name: (entries, ulps, abs)}} over the arrays of ref (nested dicts
    flattened)."""
    ref, port = _flat(ref), _flat(port)
    res = {"int": 0, "float": 0, "ulps": 0, "abs": 0.0, "keys": {}}
    for k, a in ref.items():
        b = port.get(k)
        if b is None or a.shape != b.shape:
            res["int"] += max(a.size, 1)
            res["keys"][k] = ("shape", a.shape, None if b is None else b.shape)
            continue
        if a.dtype.kind == "f":
            a32, b32 = a.astype(np.float32), b.astype(np.float32)
            d = ~((a32 == b32) | (np.isnan(a32) & np.isnan(b32)))
            n = int(d.sum())
            if n:
                u = ulps(a32[d], b32[d])
                fin = d & np.isfinite(a32) & np.isfinite(b32)
                ab = float(np.abs(a32[fin].astype(np.float64) - b32[fin]).max()) if fin.any() else 0.0
                res["float"] += n
                res["ulps"] = max(res["ulps"], u)
                res["abs"] = max(res["abs"], ab)
                res["keys"][k] = (n, u, ab)
        else:
            n = int((a.astype(np.int64) != b.astype(np.int64)).sum())
            if n:
                res["int"] += n
                res["keys"][k] = (n, None, None)
    return res


def cell(r: dict | None) -> str:
    """A table cell: '=' or the integer entries and the float ulps."""
    if r is None:
        return "-"
    if not r["int"] and not r["float"]:
        return "="
    s = f"{r['int']}" if r["int"] else "0"
    return s + (f" ({r['ulps']} ulp)" if r["float"] else "")


def explain(stage: str, rec: dict, ref: dict, port: dict, consts: dict) -> list[str]:
    """The float gate behind each integer entry of a pose LM stage that
    differs: the chi2 of the observation at each package's final pose, in
    float64, against the 5.991 gate."""
    if stage not in ("pose LM 1", "pose LM 2"):
        return []
    key, T = ("obs_d", "Tcw1") if stage == "pose LM 1" else ("obs_f", "Tcw2")
    diff = np.nonzero(np.asarray(ref[key]) != np.asarray(port[key]))[0]
    if not diff.size:
        return []
    m, f = rec["step"]["m"], rec["step"]["feats"]
    isig2 = consts["inv_sigma2"][np.clip(f["octave"], 0, len(consts["inv_sigma2"]) - 1)]
    K = consts["K"].astype(np.float64)
    out = []
    for i in diff:
        mp = max(int(ref[key][i]), int(port[key][i]))
        X = m["mp_pos"][mp].astype(np.float64)
        chi = []
        for Tcw in (ref[T], port[T]):
            Pc = Tcw[:3, :3].astype(np.float64) @ X + Tcw[:3, 3]
            u = K[0, 0] * Pc[0] / Pc[2] + K[0, 2] - f["xy_und"][i, 0]
            v = K[1, 1] * Pc[1] / Pc[2] + K[1, 2] - f["xy_und"][i, 1]
            chi.append((u * u + v * v) * isig2[i])
        out.append(f"feature {i} (point {mp}): chi2 gate {CHI2_MONO}: reference {chi[0]:.7g}, "
                   f"port {chi[1]:.7g} ({chi[0] - CHI2_MONO:+.3g} from the gate)")
    return out


def audit_frame(rec: dict, cfg, dev) -> dict:
    """Every recorded stage of one frame, fed the reference's inputs on
    ``dev``: {stage: compare(...) (+ "why")}; stages with several calls (the
    BA pieces) are summed."""
    res: dict = {}
    consts = rec["consts"]

    def add(stage, r, why=()):
        if stage in res:
            acc = res[stage]
            acc["int"] += r["int"]
            acc["float"] += r["float"]
            acc["ulps"] = max(acc["ulps"], r["ulps"])
            acc["abs"] = max(acc["abs"], r["abs"])
            acc["keys"].update({f"{len(acc['keys'])}:{k}": v for k, v in r["keys"].items()})
            acc["why"] += list(why)
        else:
            res[stage] = {**r, "why": list(why)}

    if "step" in rec:
        ref = rec["step_out"]
        port, _ = port_step(rec["step"], consts, cfg, dev, ref=ref)
        port = {k: _np(v) for k, v in port.items()}
        for stage, keys in STEP_KEYS.items():
            a = {k: ref[k] for k in keys}
            b = {k: port[k] for k in keys}
            add(stage, compare(a, b), explain(stage, rec, ref, port, consts))
    if "decision" in rec:
        add("decision", compare(rec["decision"]["out"], port_decision(rec["decision"]["in"], cfg)))
    if "keyframe" in rec:
        kf = rec["keyframe"]
        add("keyframe", compare(kf["out"], port_keyframe(kf["in"], dev)))
    if "bow" in rec:
        b = rec["bow"]
        add("keyframe", compare(b["out"], port_bow(b["in"], b["in"]["m"], cfg, dev)))
    for call in rec.get("mapping", []):
        port = port_mapping(call, consts, cfg, dev)
        why = []
        if "lam" in call["out"] and float(call["out"]["lam"]) != float(port["lam"]):
            why.append(f"{call['fn']}: the LM acceptance gate (cost1 < cost0, float sums) took "
                       f"another branch: damping reference {float(call['out']['lam']):.6g}, port "
                       f"{float(port['lam']):.6g}")
        add(MAPPING_STAGE[call["fn"]], compare(call["out"], port), why)
    return res


# --- the port's own session as a reference ----------------------------------------------

def record_port_session(sys_, frames, on_record) -> None:
    """Run the port's System over ``frames`` (monocular), calling
    on_record(rec) after each frame with the frame's stage inputs and
    outputs in the layout audit_frame reads."""
    t = sys_.tracker
    cfg, dev = sys_.cfg, t.device
    rec: dict = {}
    saved = {n: getattr(tsys, n) for n in ("mapping_step", "mapping_pre", "mapping_finish",
                                           "ba_phase1", "ba_phase2_chunk", "ba_finalize")}
    saved_step, saved_add = ttm.track_step, tmt.add_keyframe
    inst = {n: getattr(t, n) for n in ("_need_new_keyframe", "_create_keyframe", "_register_kf_bow")}
    consts = {k: _np(getattr(t, k)) for k in ("K", "scale_factors", "sigma2", "inv_sigma2")}

    def step(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw, ref_kf, K,
             scale_factors, inv_sigma2, cfg_, local_th, bounds, **kw):
        assert kw.get("ur") is None and kw.get("depth") is None, "monocular frames only"
        rec["step"] = step_inputs(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw,
                                  ref_kf, local_th, bounds)
        out, r = port_step(rec["step"], consts, cfg_, dev)
        rec["step_out"] = {k: _np(v) for k, v in out.items()}
        return r

    def decision(n_inliers, n_ref, n_kf_valid, n_close_tracked=0, n_close_untracked=0,
                 frame_id=None):
        calls, hook = [], t.mapper_idle_hook

        def idle(force=False, abort=False):
            ans = hook(force=force, abort=abort) if hook else True
            calls.append((force, abort, bool(ans)))
            return ans

        t.mapper_idle_hook = idle
        try:
            d = inst["_need_new_keyframe"](n_inliers, n_ref, n_kf_valid, n_close_tracked,
                                           n_close_untracked, frame_id=frame_id)
        finally:
            t.mapper_idle_hook = hook
        inp = decision_inputs(t, (n_inliers, n_ref, n_kf_valid, n_close_tracked,
                                  n_close_untracked), frame_id, [])
        inp["idle"] = calls
        # the host state as the decision saw it (it does not change the state)
        rec["decision"] = {"in": inp, "out": {"decision": np.asarray(bool(d)),
                                              "idle": np.asarray(calls, np.int32).reshape(-1, 3)}}
        return d

    def add_keyframe(m, pose, xy_und, octave, angle, desc, valid, obs, frame_id, ts, parent, ur=None):
        m2, kf = saved_add(m, pose, xy_und, octave, angle, desc, valid, obs, frame_id, ts, parent, ur)
        feats = {"xy_und": _np(xy_und), "octave": _np(octave), "angle": _np(angle),
                 "desc": _np(desc), "valid": _np(valid)}
        rec["keyframe"] = {"in": {"m": fields(m), "Tcw": _np(pose), "feats": feats, "cur_obs": _np(obs),
                                  "frame_id": int(frame_id), "ts": float(ts), "parent": int(parent)},
                           "out": {**fields(m2), "kf_id": np.asarray(kf)}}
        return m2, kf

    def create_keyframe(*a, **kw):
        tmt.add_keyframe = add_keyframe
        try:
            return inst["_create_keyframe"](*a, **kw)
        finally:
            tmt.add_keyframe = saved_add

    def register_bow(kf):
        drawn = []
        hook = t.vocab_draws

        def draws(seed, n):
            d = hook(seed, n)
            drawn.append([_np(x) for x in d])
            return d

        before = _bow_state(t.bow)
        t.vocab_draws = draws
        try:
            inst["_register_kf_bow"](kf)
        finally:
            t.vocab_draws = hook
        rec["bow"] = {"in": {"kf": int(kf), "before": before, "n_kf_host": t.n_kf_host,
                             "frame_id": t.frame_id, "draws": drawn[0] if drawn else None,
                             "m": fields(t.m)},
                      "out": _bow_state(t.bow)}

    def mapping(fn):
        def call(*a, **kw):
            out = saved[fn](*a, **kw)
            rec.setdefault("mapping", []).append(_port_call(fn, a, kw, out, cfg, sys_))
            return out
        return call

    def mapping_step(m, kf, K, sf, s2, is2, cfg_, n_neighbors=None, **kw):
        # the fused pass is mapping_pre -> solve_ba -> mapping_finish (tracking/local_mapping.py)
        m2, prob, cam_ids, point_ids = mapping("mapping_pre")(m, kf, K, sf, s2, is2, cfg_,
                                                              n_neighbors=n_neighbors)
        res = tba.solve_ba(prob, cfg_.optim.local_ba_iters1, cfg_.optim.local_ba_iters2)
        rec.setdefault("mapping", []).append({
            "fn": "solve_ba", "in": {"prob": fields(prob), "iters1": cfg_.optim.local_ba_iters1,
                                     "iters2": cfg_.optim.local_ba_iters2},
            "out": {"res": fields(res)}})
        return mapping("mapping_finish")(m2, kf, res, prob, cam_ids, point_ids, cfg_)

    ttm.track_step = step
    tsys.mapping_step = mapping_step
    for fn in ("mapping_pre", "mapping_finish", "ba_phase1", "ba_phase2_chunk", "ba_finalize"):
        setattr(tsys, fn, mapping(fn))
    t._need_new_keyframe, t._create_keyframe, t._register_kf_bow = decision, create_keyframe, register_bow
    try:
        for fr in frames:
            rec = {"consts": consts}
            out = sys_.track_monocular(fr.image, fr.timestamp)
            rec["state"] = out.state
            on_record(rec)
    finally:
        ttm.track_step, tmt.add_keyframe = saved_step, saved_add
        for n, f in saved.items():
            setattr(tsys, n, f)
        for n in inst:
            delattr(t, n)


def _port_call(fn: str, a, kw, out, cfg, sys_) -> dict:
    """A mapping call of the port's session as a record (fn as audit_frame
    names it)."""
    if fn == "mapping_pre":
        m, kf = a[0], a[1]
        m2, prob, cam_ids, point_ids = out
        return {"fn": "mapping pre",
                "in": {"m": fields(m), "kf": int(kf), "n_neighbors": kw.get("n_neighbors")},
                "out": {"m": fields(m2), "prob": fields(prob), "cam_ids": _np(cam_ids),
                        "point_ids": _np(point_ids)}}
    if fn == "mapping_finish":
        m, kf, res, prob, cam_ids, point_ids = a[:6]
        return {"fn": "mapping finish",
                "in": {"m": fields(m), "kf": int(kf), "res": None if res is None else fields(res),
                       "prob": None if prob is None else fields(prob), "cam_ids": _np(cam_ids),
                       "point_ids": _np(point_ids)},
                "out": {"m": fields(out)}}
    if fn == "ba_phase1":
        cam, pts, lam, inl = out
        return {"fn": fn, "in": {"prob": fields(a[0]), "n_iters": kw.get("n_iters", 5)},
                "out": {"cam_pose": _np(cam), "points": _np(pts), "lam": _np(lam),
                        "inlier": _np(inl)}}
    if fn == "ba_phase2_chunk":
        prob, cam, pts, lam, inl = a[:5]
        c2, p2, l2 = out
        return {"fn": fn, "in": {"prob": fields(prob), "cam_pose": _np(cam), "points": _np(pts),
                                 "lam": np.asarray(_np(lam) if torch.is_tensor(lam) else lam, np.float32),
                                 "inlier": _np(inl), "n_iters": kw.get("n_iters", 5)},
                "out": {"cam_pose": _np(c2), "points": _np(p2), "lam": _np(l2)}}
    if fn == "ba_finalize":
        return {"fn": fn, "in": {"prob": fields(a[0]), "cam_pose": _np(a[1]), "points": _np(a[2])},
                "out": {"res": fields(out)}}
    raise ValueError(fn)


# --- the JAX package's session as the reference ------------------------------------------

def _jax():
    """Import JAX on the CPU with tests/conftest.py's flags."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_step_stages(m, feats, last_obs, last_octave, last_angle, has_velocity, velocity, last_Tcw,
                     ref_kf, K, scale_factors, inv_sigma2, p, n_levels, max_local_points,
                     local_kf_cap, pose_rounds, pose_iters, histo_bins, **_):
    """The monocular body of the JAX ``_track_step_impl``, every branch run,
    returning each stage's outputs (tools/first_divergence_torch.py's
    ``_jax_stages``, with the branches the port always runs)."""
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.tracking import tracker as jtm

    Tcw_pred = jnp.where(has_velocity, velocity @ last_Tcw, last_Tcw)

    def motion(window):
        return jtm._track_last_frame(m, feats, last_obs, last_octave, last_angle, Tcw_pred, K,
                                     window, scale_factors, n_levels, p.nn_ratio_motion, p.th_high,
                                     histo_bins, forward=False, backward=False)

    obs_a, n_a = motion(p.motion_window)
    obs_w, n_w = motion(2.0 * p.motion_window)
    obs_r, n_r = jtm._match_reference_kf(m, feats, ref_kf, p.nn_ratio_refkf, p.th_low, histo_bins)
    widen = n_a < p.min_matches_motion
    obs_b, n_b = jnp.where(widen, obs_w, obs_a), jnp.where(widen, n_w, n_a)
    need_ref = n_b < p.min_matches_motion
    obs_c, n_c = jnp.where(need_ref, obs_r, obs_b), jnp.where(need_ref, n_r, n_b)
    Tcw0 = jnp.where(need_ref, last_Tcw, Tcw_pred)
    enough = n_c >= jnp.where(need_ref, p.min_matches_refkf, p.min_matches_motion)
    Tcw1, obs_d, n_i1 = jtm._pose_opt_on_obs(m, feats, obs_c, Tcw0, K, inv_sigma2, pose_rounds,
                                             pose_iters, p.lm_lambda)
    ok1 = enough & (n_i1 >= p.min_inliers_motion)
    obs_e, visible = jtm._track_local_map(m, feats, obs_d, Tcw1, K, scale_factors, p.local_th,
                                          n_levels, p.nn_ratio_localmap, p.th_high,
                                          max_local_points=max_local_points,
                                          local_kf_cap=local_kf_cap, bounds=p.bounds)
    Tcw2, obs_f, n_i2 = jtm._pose_opt_on_obs(m, feats, obs_e, Tcw1, K, inv_sigma2, pose_rounds,
                                             pose_iters, p.lm_lambda)
    return dict(Tcw_pred=Tcw_pred, obs_a=obs_a, n_a=n_a, obs_w=obs_w, n_w=n_w, obs_r=obs_r, n_r=n_r,
                need_ref=need_ref, obs_c=obs_c, n_c=n_c, Tcw0=Tcw0, enough=enough, Tcw1=Tcw1,
                obs_d=obs_d, n_i1=n_i1, ok1=ok1, obs_e=obs_e, visible=visible, Tcw2=Tcw2,
                obs_f=obs_f, n_i2=n_i2)


def jax_vocab_draws(seed: int, n: int, depth: int) -> list:
    """train_vocabulary's per-level seeding draws for PRNGKey(seed)."""
    jax = _jax()
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(depth):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (n,))))
    return out


def record_jax_session(js, frames, on_record) -> list:
    """Run the JAX package's System ``js`` over ``frames`` (monocular),
    calling on_record(rec) after each frame (the layout audit_frame reads).
    Returns notes: where a JAX stage copy's outputs differ from the fused
    program's (they are then not the session's)."""
    jax = _jax()
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.optim import local_ba as jlba
    from weiner_slamit_v2_tpu.tracking import system as jsys
    from weiner_slamit_v2_tpu.tracking import tracker as jtm

    t, cfg = js.tracker, js.cfg
    notes: list = []
    rec: dict = {}
    stages = jax.jit(_jax_step_stages, static_argnames=(
        "n_levels", "max_local_points", "local_kf_cap", "pose_rounds", "pose_iters", "histo_bins"))
    solve_ba = jax.jit(jlba.solve_ba, static_argnames=("iters1", "iters2"))
    fused_step, freeze = jtm._track_step, jtm._freeze_kf
    saved_sys = {n: getattr(jsys, n) for n in ("_mapping_step_jit", "_mapping_pre_jit",
                                               "_mapping_finish_jit")}
    saved_ba = {n: getattr(jlba, n) for n in ("ba_phase1", "ba_phase2_chunk", "ba_finalize")}
    inst = {n: getattr(t, n) for n in ("_need_new_keyframe", "_register_kf_bow")}
    consts = {k: _np(getattr(t, k)) for k in ("K", "scale_factors", "sigma2", "inv_sigma2")}

    def step(m, feats, last_obs, last_octave, last_angle, has_velocity, velocity, last_Tcw,
             ref_kf, K, scale_factors, inv_sigma2, p, **kw):
        out = fused_step(m, feats, last_obs, last_octave, last_angle, has_velocity, velocity,
                         last_Tcw, ref_kf, K, scale_factors, inv_sigma2, p, **kw)
        assert kw.get("ur") is None and kw.get("depth") is None, "monocular frames only"
        s = stages(m, feats, last_obs, last_octave, last_angle, has_velocity, velocity, last_Tcw,
                   ref_kf, K, scale_factors, inv_sigma2, p, **kw)
        m2, Tcw2, obs_f, vel, T_cr, scalars, (inc_v, inc_f) = out
        if not (np.array_equal(_np(s["Tcw2"]), _np(Tcw2)) and np.array_equal(_np(s["obs_f"]), _np(obs_f))):
            notes.append(f"frame {t.frame_id}: the JAX stage copy's pose LM 2 differs from the fused step's")
        rec["step"] = step_inputs(m, feats, last_obs, last_octave, last_angle,
                                  velocity if bool(has_velocity) else None, last_Tcw, int(ref_kf),
                                  float(p.local_th), p.bounds)
        rec["step_out"] = {**{k: _np(v) for k, v in s.items()},
                           "mp_visible": _np(m2.mp_visible), "mp_found": _np(m2.mp_found),
                           "scalars": _np(scalars), "inc_vis": _np(inc_v), "inc_found": _np(inc_f),
                           "velocity": _np(vel), "T_cr": _np(T_cr)}
        return out

    def decision(n_inliers, n_ref, n_kf_valid, frame_id=None, n_close_tracked=0,
                 n_close_untracked=0):
        calls, hook = [], t.mapper_idle_hook

        def idle(force=False, abort=False):
            ans = hook(force=force, abort=abort) if hook else True
            calls.append((force, abort, bool(ans)))
            return ans

        inp = decision_inputs(t, (n_inliers, n_ref, n_kf_valid, n_close_tracked,
                                  n_close_untracked), frame_id, [])
        t.mapper_idle_hook = idle
        try:
            d = inst["_need_new_keyframe"](n_inliers, n_ref, n_kf_valid, frame_id=frame_id,
                                           n_close_tracked=n_close_tracked,
                                           n_close_untracked=n_close_untracked)
        finally:
            t.mapper_idle_hook = hook
        inp["idle"] = calls
        rec["decision"] = {"in": inp, "out": {"decision": np.asarray(bool(d)),
                                              "idle": np.asarray(calls, np.int32).reshape(-1, 3)}}
        return d

    def freeze_kf(m, Tcw, feats, cur_obs, frame_id, ts, parent):
        m2, kf = freeze(m, Tcw, feats, cur_obs, frame_id, ts, parent)
        rec["keyframe"] = {"in": {"m": fields(m), "Tcw": _np(Tcw), "feats": fields(feats),
                                  "cur_obs": _np(cur_obs), "frame_id": int(frame_id),
                                  "ts": float(ts), "parent": int(parent)},
                           "out": {**fields(m2), "kf_id": np.asarray(int(kf))}}
        return m2, kf

    def register_bow(kf):
        before = _bow_state(t.bow)
        was_ready = t.bow.ready
        inst["_register_kf_bow"](kf)
        n = t.n_kf_host
        draws = None
        if not was_ready and t.bow.ready:
            draws = jax_vocab_draws(cfg.seed + 7, n * t.m.n_feat, t.bow.depth)
        elif n in (16, 64) and not t.bow.pretrained:
            draws = jax_vocab_draws(cfg.seed + 7 + n, t.m.max_kf * t.m.n_feat, t.bow.depth)
        rec["bow"] = {"in": {"kf": int(kf), "before": before, "n_kf_host": n,
                             "frame_id": t.frame_id, "draws": draws, "m": fields(t.m)},
                      "out": _bow_state(t.bow)}

    def pre_record(args, kw, out):
        m, kf = args[0], args[1]
        m2, prob, cam_ids, point_ids = out
        return {"fn": "mapping pre",
                "in": {"m": fields(m), "kf": int(kf), "n_neighbors": kw.get("n_neighbors")},
                "out": {"m": fields(m2), "prob": fields(prob), "cam_ids": _np(cam_ids),
                        "point_ids": _np(point_ids)}}

    def finish_record(args, out):
        m, kf, res, prob, cam_ids, point_ids = args[:6]
        return {"fn": "mapping finish",
                "in": {"m": fields(m), "kf": int(kf), "res": None if res is None else fields(res),
                       "prob": None if prob is None else fields(prob), "cam_ids": _np(cam_ids),
                       "point_ids": _np(point_ids)},
                "out": {"m": fields(out)}}

    def mapping_step(m, kf, K, sf, s2, is2, cfg_, n_neighbors=None, **kw):
        fused = saved_sys["_mapping_step_jit"](m, kf, K, sf, s2, is2, cfg_, n_neighbors=n_neighbors, **kw)
        pre = saved_sys["_mapping_pre_jit"](m, kf, K, sf, s2, is2, cfg_, n_neighbors=n_neighbors)
        m2, prob, cam_ids, point_ids = pre
        o = cfg_.optim
        res = solve_ba(prob, iters1=o.local_ba_iters1, iters2=o.local_ba_iters2)
        fin = saved_sys["_mapping_finish_jit"](m2, kf, res, prob, cam_ids, point_ids, cfg_)
        calls = rec.setdefault("mapping", [])
        calls.append(pre_record((m, kf), {"n_neighbors": n_neighbors}, pre))
        calls.append({"fn": "solve_ba", "in": {"prob": fields(prob), "iters1": o.local_ba_iters1,
                                               "iters2": o.local_ba_iters2},
                      "out": {"res": fields(res)}})
        calls.append(finish_record((m2, kf, res, prob, cam_ids, point_ids), fin))
        if any(not np.array_equal(a, b, equal_nan=True)
               for a, b in zip(fields(fin).values(), fields(fused).values())):
            notes.append(f"frame {t.frame_id}: the JAX pass as pre -> solve_ba -> finish differs "
                         "from the fused program's")
        return fused

    def mapping_pre(*a, **kw):
        out = saved_sys["_mapping_pre_jit"](*a, **kw)
        rec.setdefault("mapping", []).append(pre_record(a, kw, out))
        return out

    def mapping_finish(*a, **kw):
        out = saved_sys["_mapping_finish_jit"](*a, **kw)
        rec.setdefault("mapping", []).append(finish_record(a, out))
        return out

    def ba(name):
        sig = inspect.signature(saved_ba[name])

        def call(*a, **kw):
            out = saved_ba[name](*a, **kw)
            arg = sig.bind(*a, **kw)
            arg.apply_defaults()
            arg = arg.arguments
            if isinstance(arg["prob"].cam_pose, jax.core.Tracer):
                return out       # inside solve_ba's trace (the initializer's BA)
            inp = {"prob": fields(arg["prob"])}
            inp.update({k: _np(arg[k]) for k in ("cam_pose", "points", "inlier") if k in arg})
            if "lam" in arg:
                inp["lam"] = np.asarray(_np(arg["lam"]), np.float32)
            if "n_iters" in arg:
                inp["n_iters"] = int(arg["n_iters"])
            if name == "ba_finalize":
                res = {"res": fields(out)}
            else:
                keys = ("cam_pose", "points", "lam", "inlier")[:len(out)]
                res = {k: _np(v) for k, v in zip(keys, out)}
            rec.setdefault("mapping", []).append({"fn": name, "in": inp, "out": res})
            return out
        return call

    jtm._track_step, jtm._freeze_kf = step, freeze_kf
    jsys._mapping_step_jit, jsys._mapping_pre_jit = mapping_step, mapping_pre
    jsys._mapping_finish_jit = mapping_finish
    for n in saved_ba:
        setattr(jlba, n, ba(n))
    t._need_new_keyframe, t._register_kf_bow = decision, register_bow
    try:
        for fr in frames:
            rec = {"consts": consts}
            out = js.track_monocular(fr.image, fr.timestamp)
            rec["state"] = out.state
            on_record(rec)
    finally:
        jtm._track_step, jtm._freeze_kf = fused_step, freeze
        for n, f in saved_sys.items():
            setattr(jsys, n, f)
        for n, f in saved_ba.items():
            setattr(jlba, n, f)
        for n in inst:
            delattr(t, n)
    del jnp
    return notes


# --- the local BA's LM, iteration by iteration ------------------------------------------

def _port_ba_step(prob, cam_pose, points, lam, active, robust: bool):
    """One iteration of the port's LM (local_ba._lm_step): its two costs,
    its decision, the state after it, and the reduced camera system's
    smallest over largest eigenvalue on the free cameras (float64 of the
    float32 system the Cholesky factors: near 0 or below, rounding decides
    whether it is positive definite, and the step)."""
    seen, real = [], torch.linalg.cholesky_ex

    def cholesky_ex(A, **kw):
        seen.append(A)
        return real(A, **kw)

    cam_free = prob.cam_valid & ~prob.cam_fixed
    point_free = prob.point_valid & (tba._base_obs(prob).sum(1) > 0)
    torch.linalg.cholesky_ex = cholesky_ex
    try:
        pose, pts, lam1, c0, c1, accept = tba._lm_step(prob, cam_pose, points, active, robust, lam,
                                                       cam_free, point_free)
    finally:
        torch.linalg.cholesky_ex = real
    free = cam_free.repeat_interleave(6)
    eig = torch.linalg.eigvalsh(seen[0][free][:, free].double())
    return float(c0), float(c1), bool(accept), pose, pts, lam1, float(eig[0] / eig[-1])


_JAX_BA = {}


def _jax_ba_fns():
    """A jitted copy of the JAX package's _lm_phase (optim/local_ba.py) whose
    loop also keeps, for every iteration, the state it starts from, the
    damping, both costs of the acceptance gate and its decision (trace_ba
    holds its results against the package's own programs)."""
    if _JAX_BA:
        return _JAX_BA
    from functools import partial

    jax = _jax()
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.geometry import se3 as jse3
    from weiner_slamit_v2_tpu.optim import local_ba as jlba

    @partial(jax.jit, static_argnames=("robust", "n_iters"))
    def phase(prob, cam_pose, points, lam0, active_obs, robust, n_iters):
        C = prob.cam_pose.shape[0]
        cam_free = prob.cam_valid & ~prob.cam_fixed
        point_free = prob.point_valid & (jlba._base_obs(prob).sum(axis=1) > 0)
        rb = jnp.asarray(robust)

        def step(i, st):
            cam_pose, points, lam, poses, pts, lams, c0s, c1s, accs = st
            poses, pts, lams = poses.at[i].set(cam_pose), pts.at[i].set(points), lams.at[i].set(lam)
            c0, chi2, _ = jlba._total_cost(cam_pose, points, prob.K, prob, active_obs, rb)
            w = prob.obs_inv_sigma2 * jlba._robust_weight(chi2, rb, jlba._per_obs_chi2_th(prob))
            w = jnp.where(active_obs, w, 0.0)
            Hcc, bc, Hpp, bp, U = jlba.build_normal_equations(
                cam_pose, points, prob.K, prob.obs_cam, prob.obs_uv, w, C, prob.obs_ur,
                prob.obs_has_ur, prob.bf)
            dc, dp = jlba.schur_solve(Hcc, bc, Hpp, bp, U, cam_free, point_free, lam)
            new_pose, new_pts = jax.vmap(jse3.retract)(cam_pose, dc), points + dp
            c1, _, _ = jlba._total_cost(new_pose, new_pts, prob.K, prob, active_obs, rb)
            finite = jnp.isfinite(c1) & jnp.all(jnp.isfinite(dc)) & jnp.all(jnp.isfinite(dp))
            accept = (c1 < c0) & finite
            cam_pose = jnp.where(accept, new_pose, cam_pose)
            points = jnp.where(accept, new_pts, points)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 8.0), 1e-5, 1e3)
            return (cam_pose, points, lam, poses, pts, lams, c0s.at[i].set(c0), c1s.at[i].set(c1),
                    accs.at[i].set(accept))

        z = jnp.zeros(n_iters, jnp.float32)
        return jax.lax.fori_loop(0, n_iters, step, (
            cam_pose, points, lam0, jnp.zeros((n_iters,) + cam_pose.shape, cam_pose.dtype),
            jnp.zeros((n_iters,) + points.shape, points.dtype), z, z, z,
            jnp.zeros(n_iters, bool)))

    def problem(d):
        return jlba.BAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})

    _JAX_BA.update(phase=phase, problem=problem, base=jlba._base_obs, phase1=jlba.ba_phase1,
                   phase2=jlba.ba_phase2_chunk, finalize=jlba.ba_finalize, jnp=jnp)
    return _JAX_BA


def trace_ba(call: dict) -> list[str]:
    """A solve_ba call's LM, iteration by iteration: the JAX package's (its
    loop copied to keep every iteration's values; its state after each phase
    and its result are held against the package's own ba_phase1 /
    ba_phase2_chunk / ba_finalize, which compose the fused solve_ba), the
    port's on its own state from the same start, and the port's iteration on
    the JAX state of that iteration. Names every iteration whose acceptance
    gate (cost1 < cost0, and a finite step) takes another branch: first in
    the two chains, then on the fed state, with both packages' costs."""
    J = _jax_ba_fns()
    jnp = J["jnp"]
    d, n1, n2 = call["in"]["prob"], call["in"]["iters1"], call["in"]["iters2"]
    jp, tp = J["problem"](d), _problem(d, "cpu")
    lam0 = np.float32(tba.BA_LAMBDA_INIT)     # solve_ba's lambda_init in both packages
    c5, p5, _, inl = J["phase1"](jp, n1)
    o1 = J["phase"](jp, jp.cam_pose, jp.points, jnp.float32(lam0), J["base"](jp), True, n1)
    c15, p15, _ = J["phase2"](jp, c5, p5, float(lam0), inl, n2)
    o2 = J["phase"](jp, c5, p5, jnp.float32(lam0), inl, False, n2)
    res = J["finalize"](jp, c15, p15)
    faithful = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
        (o1[0], c5), (o1[1], p5), (o2[0], c15), (o2[1], p15)))
    faithful &= all(np.array_equal(np.asarray(getattr(res, k)), call["out"]["res"][k])
                    for k in ("cam_pose", "points"))
    jrows = []    # (state, lam, c0, c1, accept, active, robust) per iteration
    for o, act, robust in ((o1, J["base"](jp), True), (o2, inl, False)):
        for i in range(len(o[5])):
            jrows.append(((o[3][i], o[4][i]), o[5][i], float(o[6][i]), float(o[7][i]), bool(o[8][i]),
                          act, robust))
    ts, tact, lines, first = (tp.cam_pose, tp.points, torch.tensor(lam0)), tba._base_obs(tp), [], None
    for it, ((jc, jx), jlam, jc0, jc1, jacc, jact, robust) in enumerate(jrows):
        if it == n1:        # phase 2: the phase-1 inliers, the damping restarted
            tact = tba.ba_phase1(dataclasses.replace(tp, cam_pose=ts[0], points=ts[1]), n_iters=0)[3]
            ts = (ts[0], ts[1], torch.tensor(lam0))
        gap = (float(np.abs(np.asarray(jc) - _np(ts[0])).max()),
               float(np.abs(np.asarray(jx) - _np(ts[1])).max()))
        tc0, tc1, tacc, *tn, teig = _port_ba_step(tp, *ts, tact, robust)
        fc0, fc1, facc, *_, feig = _port_ba_step(tp, _t(np.asarray(jc), "cpu"), _t(np.asarray(jx), "cpu"),
                                           _t(np.asarray(jlam), "cpu"), _t(np.asarray(jact), "cpu"),
                                           robust)
        ts = tuple(tn)

        def gate(c0, c1, acc):
            why = "" if acc == (c1 < c0) else ", the step not finite"
            return (f"cost0 {c0:.9g} cost1 {c1:.9g} {'accepts' if acc else 'rejects'} "
                    f"({(c1 - c0) / max(abs(c0), 1e-30):+.3g} relative{why})")

        where = f"iteration {it} (phase {1 if it < n1 else 2}, damping {float(jlam):.3g})"
        if jacc != tacc:
            first = it if first is None else first
            lines.append(f"{where}, own states {gap[0]:.3g} / {gap[1]:.3g} apart (poses / points): "
                         f"JAX {gate(jc0, jc1, jacc)}; port {gate(tc0, tc1, tacc)}, its reduced "
                         f"system's eigenvalue ratio {teig:.3g}")
        if jacc != facc:
            lines.append(f"{where}, on JAX's state: JAX {gate(jc0, jc1, jacc)}; port "
                         f"{gate(fc0, fc1, facc)}, the reduced system's eigenvalue ratio {feig:.3g}")
    final = (float(np.abs(np.asarray(c15) - _np(ts[0])).max()),
             float(np.abs(np.asarray(p15) - _np(ts[1])).max()))
    head = (f"the JAX copy {'equals' if faithful else 'DIFFERS FROM'} the package's programs; "
            f"chains {final[0]:.3g} / {final[1]:.3g} apart at the end (poses / points); "
            + ("the gate takes the same branch in every iteration" if not lines else
               f"first branch apart at iteration {first}" if first is not None else
               "the chains take the same branches"))
    return [head] + lines


# --- sessions ------------------------------------------------------------------------------

def session_config(mod, session: str, scale: float = 1.0):
    """(config, camera arguments, sequence arguments) of a named session in
    the config module ``mod`` (either package's). scale < 1 shrinks the bench
    geometry (image, focal length and feature budget; the field of view and
    every other setting stay)."""
    if session == "bench":
        H, W, f = int(480 * scale), int(640 * scale), 500.0 * scale
        cfg = mod.SlamConfig(
            orb=mod.OrbConfig(n_features=int(1024 * scale)),
            camera=mod.CameraConfig(fx=f, fy=f, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0, k3=0,
                                    width=W, height=H),
            tracking=mod.TrackingConfig(mapping_latency_frames=8, frames_per_sync=1,
                                        abortable_ba=False))
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        return cfg, (f, f, W / 2, H / 2, W, H), dict(h=H, w=W, seed=0, motion="orbit", K=K,
                                                      motion_frames=164)
    H, W = 240, 320
    tracking = dict(frames_per_sync=1, abortable_ba=False) if session == "slice" else {}
    cfg = mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                k3=0, width=W, height=H),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(**tracking))
    K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
    return cfg, (300.0, 300.0, 159.5, 119.5, W, H), dict(h=H, w=W, seed=11, motion="orbit", K=K)


def jax_records(session: str, n_frames: int, on_record, scale: float = 1.0) -> tuple:
    """Run the JAX session ``session`` over n_frames, on_record(rec) per
    frame; returns (notes, the port's config of the session)."""
    _jax()
    from weiner_slamit_v2_tpu import config as jconfig
    from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System as JSystem
    from weiner_slamit_v2_torch import config as tconfig

    cfg, (fx, fy, cx, cy, W, H), seq_kw = session_config(jconfig, session, scale)
    seq = make_synthetic_sequence(n_frames=n_frames, **seq_kw)
    frames = seq.frames
    if session == "bench":
        frames = [SimpleNamespace(image=np.clip(f.image, 0, 255).astype(np.uint8),
                                  timestamp=f.timestamp) for f in frames]
    js = JSystem(cfg, JCamera.create(fx, fy, cx, cy, width=W, height=H))
    return record_jax_session(js, frames, on_record), session_config(tconfig, session, scale)[0]


def table(rows: list[dict], states: list[str]) -> list[str]:
    lines = ["frame | state | " + " | ".join(STAGES), "---|---|" + "---|" * len(STAGES)]
    for i, (r, s) in enumerate(zip(rows, states)):
        lines.append(f"{i} | {s} | " + " | ".join(cell(r.get(st)) for st in STAGES))
    return lines


def gate_notes(rows: list[dict]) -> list[str]:
    """The float gates that took another branch on fed inputs without an
    integer output differing (the local BA's damping)."""
    return [f"frame {i}, {st}: {w}" for i, r in enumerate(rows) for st, x in r.items()
            for w in x["why"] if not x["int"]]


def summary(rows: list[dict]) -> list[str]:
    """Per stage: frames run, frames and integer entries differing, the
    largest float difference in ulps, and the explained entries."""
    lines = ["stage | frames run | frames with integer differences | integer entries | "
             "max ulps | max abs | float planes that differ (max abs)", "---|---|---|---|---|---|---"]
    for st in STAGES:
        rs = [r[st] for r in rows if st in r]
        planes: dict = {}
        for r in rs:
            for k, v in r["keys"].items():
                if v[1] is not None:
                    name = k.split(":")[-1]
                    planes[name] = max(planes.get(name, 0.0), v[2])
        lines.append(f"{st} | {len(rs)} | {sum(1 for r in rs if r['int'])} | "
                     f"{sum(r['int'] for r in rs)} | {max((r['ulps'] for r in rs), default=0)} | "
                     f"{max((r['abs'] for r in rs), default=0):.3g} | "
                     + ", ".join(f"{k} {v:.3g}" for k, v in sorted(planes.items())))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--session", choices=("slice", "staged", "bench"), default="slice")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="bench geometry scale (0.5: 320x240, f 250, 512 features)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    n = args.frames or (40 if args.session == "bench" else 24)
    from weiner_slamit_v2_torch import config as tconfig

    cfg = session_config(tconfig, args.session, args.scale)[0]
    rows, states, details = [], [], []
    t0 = time.time()

    traces = []

    def on_record(rec):
        i = len(rows)
        rows.append(audit_frame(rec, cfg, "cpu"))
        for call in rec.get("mapping", []):
            if call["fn"] == "solve_ba":
                traces.append(f"frame {i}, local BA:")
                traces.extend(f"    {line}" for line in trace_ba(call))
        states.append(rec["state"])
        for st, r in rows[-1].items():
            if r["int"]:
                keys = {k: v for k, v in r["keys"].items() if v[1] is None}
                details.append(f"frame {i}, {st}: {keys}")
                details.extend(f"    {w}" for w in r["why"])
        print(f"frame {i} {rec['state']}: " + ", ".join(f"{st} {cell(r)}" for st, r in rows[-1].items()),
              flush=True)

    notes, _ = jax_records(args.session, n, on_record, args.scale)
    text = "\n".join([f"# fed stages, session {args.session} (scale {args.scale}), {n} frames "
                      f"({time.time() - t0:.0f} s)", ""]
                     + table(rows, states) + [""] + summary(rows) + [""] + ["integer differences:"]
                     + (details or ["none"]) + [""] + ["gates that flipped with equal integer outputs:"]
                     + (gate_notes(rows) or ["none"]) + [""]
                     + ["the fused local BA's LM acceptance, iteration by iteration:"]
                     + (traces or ["no fused BA call"]) + [""] + ["notes:"] + (notes or ["none"]))
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
