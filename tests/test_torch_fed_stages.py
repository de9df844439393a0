"""Every stage of the monocular back end held on the JAX session's own state,
frame by frame (tools/fed_stages_torch.py): the 24-frame 240x320 session of
tests/test_torch_slice.py (small_config, abortable_ba=False) runs once in
the JAX package; on every frame each port stage is fed the JAX session's
inputs for that stage (its map, features, the matches and poses of the
stage before) and its outputs are compared with JAX's.

Integer outputs (match indices, counts, inlier masks, counter planes, the
packed scalars, the keyframe decision, every integer plane of the map, the
BA's inlier classification) are equal on every frame at every stage: no
float gate flips on fed inputs in this session. Floats are held to the
figures measured on an x86-64 CPU (XLA:CPU with --xla_cpu_max_isa=AVX2):
- motion, local map, decision (counters, velocity, T_cr) and mapping finish:
  bit-equal;
- pose LM 1 / 2: within 1.42e-5 / 3.27e-5 (the normal equations are XLA
  dots whose summation order the port does not reproduce; the damping, the
  6x6 solve and the update are JAX's, tests/test_torch_pose_solve.py);
- keyframe: the BoW rows within 2 ulp (the tf-idf normalization's sum);
- mapping pre: new points within 8.2e-4 (the triangulation's SVD is
  LAPACK's in JAX and torch's here), their normals and depth ranges with
  them;
- local BA: poses within 2.5e-4, points within 1e-3 m (the scene is
  0.2-1.8 m from the cameras) except one far point in each of the last two
  passes (5.8 and 13.3 m away, 2 observations each: low parallax), whose
  ray stays within 2.3e-4 rad while it slides 0.19 and 2.41 m along it, and
  the final cost within 1.2e-5 relative (the BA's sums; its acceptance
  gate, cost1 < cost0 and a finite step, takes other branches near the
  minimum: tools/fed_stages_torch.py traces it iteration by iteration,
  and test_ba_trace_of_the_last_pass holds that trace on the last pass).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import fed_stages_torch as fed  # noqa: E402

torch.set_num_threads(1)

N_FRAMES = 24
# frames each stage runs on: tracking from frame 3 (the two-view
# initialization takes frames 0-2), a keyframe on frame 2 (the second of
# the initialization) and on 6 frames after, a mapping pass with each of those
RUNS = {"motion": 21, "pose LM 1": 21, "local map": 21, "pose LM 2": 21, "decision": 21,
        "keyframe": 7, "mapping pre": 6, "local BA": 6, "mapping finish": 6}
# the largest absolute float difference measured per stage (0: bit-equal)
FLOAT_ABS = {"motion": 0.0, "pose LM 1": 1.42e-5, "pose LM 2": 3.27e-5, "local map": 0.0,
             "decision": 0.0, "mapping pre": 8.2e-4, "mapping finish": 0.0}


@pytest.fixture(scope="module")
def audit():
    from weiner_slamit_v2_torch import config as tconfig

    cfg = fed.session_config(tconfig, "slice")[0]
    rows, states, ba, calls = [], [], [], []

    def on_record(rec):
        rows.append(fed.audit_frame(rec, cfg, "cpu"))
        states.append(rec["state"])
        for call in rec.get("mapping", []):
            if call["fn"] == "solve_ba":
                ba.append((call["out"]["res"], fed.port_mapping(call, rec["consts"], cfg, "cpu")["res"],
                           call["in"]["prob"]))
                calls.append(call)

    notes, _ = fed.jax_records("slice", N_FRAMES, on_record)
    return rows, states, notes, ba, calls


def test_jax_stage_copies_are_the_session(audit):
    """The JAX stage copy equals the fused tracking step on every frame, and
    each pass as pre -> solve_ba -> finish equals the fused mapping program."""
    rows, states, notes, *_ = audit
    assert notes == []
    assert len(rows) == N_FRAMES and states[:2] == ["NOT_INITIALIZED"] * 2
    assert all(s == "OK" for s in states[2:])


@pytest.mark.parametrize("stage", fed.STAGES)
def test_integer_outputs_equal_on_every_frame(audit, stage):
    rows = audit[0]
    ran = [(i, r[stage]) for i, r in enumerate(rows) if stage in r]
    assert len(ran) == RUNS[stage]
    differ = {i: r["keys"] for i, r in ran if r["int"]}
    assert differ == {}, differ


@pytest.mark.parametrize("stage", sorted(FLOAT_ABS))
def test_float_outputs_within_measured(audit, stage):
    worst = max(r[stage]["abs"] for r in audit[0] if stage in r)
    assert worst <= FLOAT_ABS[stage], worst
    if FLOAT_ABS[stage] == 0.0:
        assert all(r[stage]["float"] == 0 for r in audit[0] if stage in r)


def test_keyframe_and_bow_within_two_ulp(audit):
    assert max(r["keyframe"]["ulps"] for r in audit[0] if "keyframe" in r) <= 2


def test_local_ba_within_measured(audit):
    ba = audit[3]
    assert len(ba) == RUNS["local BA"]
    n_far = []
    for ref, port, prob in ba:
        np.testing.assert_array_equal(port["obs_inlier"], ref["obs_inlier"])
        np.testing.assert_allclose(port["cam_pose"], ref["cam_pose"], rtol=0, atol=2.5e-4)
        np.testing.assert_allclose(port["final_cost"], ref["final_cost"], rtol=1.2e-5)
        # each point's distance from its nearest camera of the window; a far
        # point is more than 4 x the median away
        pv = prob["point_valid"].astype(bool)
        P = ref["points"][pv].astype(np.float64)
        Q = port["points"][pv].astype(np.float64)
        T = ref["cam_pose"][prob["cam_valid"].astype(bool)].astype(np.float64)
        C = -np.einsum("cji,cj->ci", T[:, :3, :3], T[:, :3, 3])
        d = np.linalg.norm(P[:, None] - C[None], axis=2)
        near = d.argmin(1)
        dist = d[np.arange(len(P)), near]
        far = dist > 4 * np.median(dist)
        n_far.append(int(far.sum()))
        np.testing.assert_allclose(Q[~far], P[~far], rtol=0, atol=1e-3)
        ray = (P[far] - C[near[far]]) / dist[far, None]
        diff = Q[far] - P[far]
        across = diff - (diff * ray).sum(1, keepdims=True) * ray
        assert np.all(np.linalg.norm(across, axis=1) / dist[far] <= 2.3e-4)
    assert n_far == [0, 0, 0, 0, 1, 1]


def test_ba_trace_of_the_last_pass(audit):
    """The fused BA's LM iteration by iteration (fed.trace_ba) on the last
    pass: the JAX loop's copy equals the package's programs, and on JAX's
    state of each of the 15 iterations the port takes JAX's branch but in
    two: iteration 4, where the port's Cholesky of the reduced camera
    system fails (the free cameras' smallest eigenvalue -8.0e-7 of the
    largest in the port's float32 system) and JAX's does not, and
    iteration 14, where the two costs lie within 4.5e-7 of each other
    relative to cost0 in both packages."""
    lines = fed.trace_ba(audit[4][-1])
    assert lines[0].startswith("the JAX copy equals the package's programs"), lines[0]
    on_jax = [line for line in lines if "on JAX's state" in line]
    assert [int(line.split()[1]) for line in on_jax] == [4, 14], on_jax
    assert "port cost0" in on_jax[0] and on_jax[0].split("port cost0")[1].count("step not finite") == 1
