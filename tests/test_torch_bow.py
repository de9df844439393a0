"""The port's BoW vocabulary, keyframe database and RANSAC PnP against the
JAX package on the same numpy inputs, with the JAX package's own random
draws (jax.random) fed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu.bow import database as jdb
from weiner_slamit_v2_tpu.bow import vocabulary as jvoc
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.optim.pnp import N_ITERS, SAMPLE
from weiner_slamit_v2_tpu.optim.pnp import ransac_pnp as j_ransac_pnp
from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose as j_optimize_pose
from weiner_slamit_v2_torch.bow import database as tdb
from weiner_slamit_v2_torch.bow import vocabulary as tvoc
from weiner_slamit_v2_torch.optim.pnp import ransac_pnp
from weiner_slamit_v2_torch.optim.pose_opt import optimize_pose

torch.set_num_threads(1)


def jax_uniforms(seed: int, n: int, depth: int):
    """train_vocabulary's per-level seeding draws for PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(depth):
        key, k1 = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(k1, (n,)))))
    return out


def t_desc(d):
    """uint32 descriptors -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(d, np.uint32)).view(np.int32))


def clustered(rng, n_clusters, per_cluster, flip_bits=8):
    centers = rng.integers(0, 2**32, (n_clusters, 8), dtype=np.uint32)
    d = np.repeat(centers, per_cluster, 0)
    for _ in range(flip_bits):
        w = rng.integers(0, 8, d.shape[0])
        b = rng.integers(0, 32, d.shape[0]).astype(np.uint32)
        d[np.arange(d.shape[0]), w] ^= np.uint32(1) << b
    return d


def corpus(case):
    """(desc uint32, valid, seed, branching, depth) of a training case."""
    rng = np.random.default_rng(case)
    if case == 0:    # random descriptors, 10 % invalid, the default 10^4-word tree
        d = rng.integers(0, 2**32, (1500, 8), dtype=np.uint32)
        return d, rng.random(1500) > 0.1, 3, 10, 4
    if case == 1:    # clustered descriptors: populated words, real k-means moves
        d = clustered(rng, 40, 30)
        return d, rng.random(d.shape[0]) > 0.05, 4, 10, 3
    # 60 descriptors, K=10: the root's slot K-1 is written by 51 of them. The
    # last of them in the seeding order, and the 4 before it, are invalid.
    d = rng.integers(0, 2**32, (60, 8), dtype=np.uint32)
    r0 = np.asarray(jax_uniforms(5, 60, 2)[0])
    valid = np.ones(60, bool)
    valid[np.argsort(r0, kind="stable")[-5:]] = False
    return d, valid, 5, 10, 2


def train_both(case):
    d, valid, seed, K, L = corpus(case)
    jv = jvoc.train_vocabulary(jnp.asarray(d), jnp.asarray(valid), jax.random.PRNGKey(seed),
                               branching=K, depth=L)
    tv = tvoc.train_vocabulary(t_desc(d), torch.from_numpy(valid), jax_uniforms(seed, d.shape[0], L),
                               branching=K, depth=L)
    return d, valid, jv, tv


@pytest.mark.parametrize("case", [0, 1, 2], ids=["random", "clustered", "tail_invalid_slot"])
def test_train_vocabulary_matches_jax(case):
    """Equal trees (centroids, trained masks) and idf within 1e-6 relative.
    Case 2 holds the duplicate-index seeding scatter to the JAX package's
    order: the slot shared by a parent's members of rank >= K-1 keeps the
    last write."""
    d, _, jv, tv = train_both(case)
    for lvl in range(jv.depth):
        np.testing.assert_array_equal(tv.level_desc[lvl].numpy().view(np.uint32),
                                      np.asarray(jv.level_desc[lvl]), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(tv.level_valid[lvl].numpy(), np.asarray(jv.level_valid[lvl]))
    np.testing.assert_allclose(tv.word_idf.numpy(), np.asarray(jv.word_idf), rtol=1e-6, atol=0)
    if case == 2:
        assert not bool(jv.level_valid[0][9]) and not bool(tv.level_valid[0][9])


def test_pack_unpack_bits_round_trip():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    d[0] = 0xFFFFFFFF
    d[1] = 0x80000000
    bits = tvoc._unpack_bits(t_desc(d))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jvoc._unpack_bits(jnp.asarray(d))))
    np.testing.assert_array_equal(tvoc._pack_bits(bits).numpy().view(np.uint32), d)


@pytest.mark.parametrize("case", [0, 1])
def test_transform_bow_vector_and_l1_match_jax(case):
    d, valid, jv, tv = train_both(case)
    q = np.random.default_rng(11).permutation(d.shape[0])[:400]
    qv = np.random.default_rng(12).random(400) > 0.1
    jw, jg = jvoc.transform(jv, jnp.asarray(d[q]), jnp.asarray(qv))
    tw, tg = tvoc.transform(tv, t_desc(d[q]), torch.from_numpy(qv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    halves = [(slice(0, 200), slice(200, 400)), (slice(0, 200), slice(0, 200))]
    for a, b in halves:
        jva, jvb = jvoc.bow_vector(jv, jw[a]), jvoc.bow_vector(jv, jw[b])
        tva, tvb = tvoc.bow_vector(tv, tw[a]), tvoc.bow_vector(tv, tw[b])
        np.testing.assert_allclose(tva.numpy(), np.asarray(jva), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(tvoc.l1_score(tva, tvb)), float(jvoc.l1_score(jva, jvb)),
                                   rtol=1e-6, atol=1e-6)


def kf_rows(d, n_kf=6, n=48, seed=3):
    rng = np.random.default_rng(seed)
    kd = np.stack([d[rng.choice(d.shape[0], n, replace=False)] for _ in range(n_kf)])
    return kd, rng.random((n_kf, n)) > 0.1


def test_dense_database_matches_jax():
    """add / erase / mask / permute / query_candidates: keep equal, acc
    within 1e-5."""
    d, _, jv, tv = train_both(1)
    kd, fv = kf_rows(d, n_kf=7)
    K = 8
    jd, td = jdb.KeyframeDatabase.create(K, jv.n_words), tdb.KeyframeDatabase.create(K, tv.n_words, "cpu")
    for k in range(7):
        jw, _ = jvoc.transform(jv, jnp.asarray(kd[k]), jnp.asarray(fv[k]))
        tw, _ = tvoc.transform(tv, t_desc(kd[k]), torch.from_numpy(fv[k]))
        jd = jdb.add_keyframe_bow(jd, jnp.asarray(k), jvoc.bow_vector(jv, jw))
        td = tdb.add_keyframe_bow(td, k, tvoc.bow_vector(tv, tw))
    jd, td = jdb.erase_keyframe_bow(jd, jnp.asarray(3)), tdb.erase_keyframe_bow(td, 3)
    kf_valid = np.ones(K, bool)
    kf_valid[5] = False
    jd, td = jdb._mask_db_valid(jd, jnp.asarray(kf_valid)), tdb._mask_db_valid(td, torch.from_numpy(kf_valid))

    rng = np.random.default_rng(9)
    W = rng.integers(0, 60, (K, K))
    W = np.triu(W, 1) + np.triu(W, 1).T
    for qk in (0, 2, 6):
        jw, _ = jvoc.transform(jv, jnp.asarray(kd[qk]), jnp.asarray(fv[qk]))
        tw, _ = tvoc.transform(tv, t_desc(kd[qk]), torch.from_numpy(fv[qk]))
        excl = np.zeros(K, bool)
        excl[qk] = True
        ja, jk = jdb.query_candidates(jd, jvoc.bow_vector(jv, jw), jnp.asarray(excl),
                                      jnp.asarray(W, jnp.float32))
        ta, tk = tdb.query_candidates(td, tvoc.bow_vector(tv, tw), torch.from_numpy(excl),
                                      torch.from_numpy(W).float())
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
        assert tk.any()

    # BowIndex.permute (map compaction): dense rows move as the JAX rows do
    kf_map = np.array([0, -1, 1, 2, -1, 3, 4, 5], np.int32)
    ji, ti = jdb.BowIndex(K, vocab=jv), tdb.BowIndex(K, vocab=tv, device="cpu")
    ji.db, ti.db = jd, td
    ji.permute(jnp.asarray(kf_map))
    ti.permute(torch.from_numpy(kf_map))
    np.testing.assert_array_equal(ti.db.has_entry.numpy(), np.asarray(ji.db.has_entry))
    np.testing.assert_allclose(ti.db.bow.numpy(), np.asarray(ji.db.bow), rtol=1e-6, atol=1e-7)


def test_sparse_database_through_dbow2_text(tmp_path):
    """save_dbow2_text -> vocabulary_from_dbow2 -> sparse rows -> candidates,
    against the JAX package reading the same file."""
    d, _, _, tv = train_both(1)
    path = str(tmp_path / "voc.txt")
    tvoc.save_dbow2_text(tv, path)
    jv = jvoc.vocabulary_from_dbow2(path)
    tv2 = tvoc.vocabulary_from_dbow2(path, device="cpu")
    for lvl in range(jv.depth):
        np.testing.assert_array_equal(tv2.level_desc[lvl].numpy().view(np.uint32),
                                      np.asarray(jv.level_desc[lvl]))
        np.testing.assert_array_equal(tv2.level_valid[lvl].numpy(), np.asarray(jv.level_valid[lvl]))
    np.testing.assert_array_equal(tv2.word_idf.numpy(), np.asarray(jv.word_idf))

    kd, fv = kf_rows(d)
    kf_valid = np.ones(6, bool)
    kf_valid[4] = False
    jsd = jdb.build_sparse_db_from_keyframes(jv, jnp.asarray(kd), jnp.asarray(fv), jnp.asarray(kf_valid))
    tsd = tdb.build_sparse_db_from_keyframes(tv2, t_desc(kd), torch.from_numpy(fv),
                                             torch.from_numpy(kf_valid))
    np.testing.assert_array_equal(tsd.wid.numpy(), np.asarray(jsd.wid))
    np.testing.assert_allclose(tsd.wt.numpy(), np.asarray(jsd.wt), rtol=1e-6, atol=1e-7)
    jq = jdb.sparse_bow_row(jv, jvoc.transform(jv, jnp.asarray(kd[0]), jnp.asarray(fv[0]))[0])
    tq = tdb.sparse_bow_row(tv2, tvoc.transform(tv2, t_desc(kd[0]), torch.from_numpy(fv[0]))[0])
    W = np.zeros((6, 6), np.float32)
    W[0, 1] = W[1, 0] = 40
    ja, jk = jdb.query_candidates_sparse(jsd, *jq, jnp.zeros(6, bool), jnp.asarray(W),
                                         jnp.asarray(0.0), n_words=jv.n_words)
    ta, tk = tdb.query_candidates_sparse(tsd, *tq, torch.zeros(6, dtype=torch.bool),
                                         torch.from_numpy(W), 0.0, tv2.n_words)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    assert bool(tk[0])

    # BowIndex in sparse mode: add, erase, mask, permute and query, both packages
    ji = jdb.BowIndex(8, vocab=jv, sparse_slots=48)
    ti = tdb.BowIndex(8, vocab=tv2, sparse_slots=48, device="cpu")
    ji.sparse = ti.sparse = True     # the DBoW2-scale path on a small vocabulary
    ji.db, ti.db = jdb.SparseKeyframeDatabase.create(8, 48), tdb.SparseKeyframeDatabase.create(8, 48, "cpu")
    for k in range(6):
        ji.add(k, jnp.asarray(kd[k]), jnp.asarray(fv[k]))
        ti.add(k, t_desc(kd[k]), torch.from_numpy(fv[k]))
    ji.erase(2)
    ti.erase(2)
    mask = np.ones(8, bool)
    mask[4] = False
    ji.mask_valid(jnp.asarray(mask))
    ti.mask_valid(torch.from_numpy(mask))
    kf_map = np.array([1, 0, -1, 2, -1, 3, -1, -1], np.int32)
    ji.permute(jnp.asarray(kf_map))
    ti.permute(torch.from_numpy(kf_map))
    for f in ("wid", "wt", "has_entry"):
        np.testing.assert_allclose(getattr(ti.db, f).numpy(), np.asarray(getattr(ji.db, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    ja, jk = ji.candidates(ji.query_vector(jnp.asarray(kd[5]), jnp.asarray(fv[5])),
                           jnp.zeros(8, bool), jnp.zeros((8, 8), jnp.float32))
    ta, tk = ti.candidates(ti.query_vector(t_desc(kd[5]), torch.from_numpy(fv[5])),
                           torch.zeros(8, dtype=torch.bool), torch.zeros((8, 8)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    assert int(torch.argmax(torch.where(tk, ta, -1.0))) == 3    # kf 5 is row 3 after permute


def test_bow_index_trains_online_and_keeps_pending_rows():
    """Keyframes added before the vocabulary exists are indexed by
    maybe_train; retrain re-indexes every valid slot (same rows as JAX)."""
    d, _, _, _ = train_both(1)
    kd, fv = kf_rows(d, n_kf=5, n=64, seed=4)
    ji, ti = jdb.BowIndex(8, depth=3), tdb.BowIndex(8, depth=3, device="cpu")
    for k in range(4):
        ji.add(k, jnp.asarray(kd[k]), jnp.asarray(fv[k]))
        ti.add(k, t_desc(kd[k]), torch.from_numpy(fv[k]))
    assert not ti.ready
    ji.maybe_train(jnp.asarray(kd[:4].reshape(-1, 8)), jnp.asarray(fv[:4].reshape(-1)),
                   jax.random.PRNGKey(7))
    ti.maybe_train(t_desc(kd[:4].reshape(-1, 8)), torch.from_numpy(fv[:4].reshape(-1)),
                   jax_uniforms(7, 4 * 64, 3))
    np.testing.assert_allclose(ti.db.bow.numpy(), np.asarray(ji.db.bow), rtol=1e-6, atol=1e-7)
    all_desc = np.zeros((8, 64, 8), np.uint32)
    all_desc[:5] = kd
    all_fv = np.zeros((8, 64), bool)
    all_fv[:5] = fv
    kf_valid = np.arange(8) < 5
    ji.retrain(jnp.asarray(all_desc), jnp.asarray(all_fv), jnp.asarray(kf_valid), jax.random.PRNGKey(9))
    ti.retrain(t_desc(all_desc.reshape(-1, 8)).reshape(8, 64, 8), torch.from_numpy(all_fv),
               torch.from_numpy(kf_valid), jax_uniforms(9, 8 * 64, 3))
    np.testing.assert_array_equal(ti.db.has_entry.numpy(), np.asarray(ji.db.has_entry))
    np.testing.assert_allclose(ti.db.bow.numpy(), np.asarray(ji.db.bow), rtol=1e-6, atol=1e-7)


def pnp_problem(seed=5, n=100, n_out=30):
    """tests/test_bow.py::test_ransac_pnp_with_outliers's correspondences."""
    rng = np.random.default_rng(seed)
    cam = JCamera.create(500.0, 500.0, 320.0, 240.0)
    K = np.array(cam.K, np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                 1).astype(np.float32)
    T_true = jse3.exp(jnp.asarray([0.2, -0.1, 0.15, 0.05, 0.1, -0.03]))
    uv = np.array(cam.project(jse3.apply(T_true, jnp.asarray(X))))
    uv += rng.normal(0, 0.5, uv.shape)
    uv[:n_out] += rng.uniform(30, 120, (n_out, 2))
    valid = rng.random(n) > 0.05
    w = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    return X, uv.astype(np.float32), valid, w, K, np.asarray(T_true)


@pytest.mark.parametrize("key", [0, 1, 2])
def test_ransac_pnp_matches_jax(key):
    """Same draws, same winning hypothesis: its pose within 2e-3 (float32
    SVDs of a 12x12 system in two LAPACK builds), the inlier count within 2
    (a borderline chi2 < 5.991 point may flip); refined by the pose LM, the
    poses agree within 1e-4 and land on the truth."""
    X, uv, valid, w, K, T_true = pnp_problem()
    jkey = jax.random.PRNGKey(key)
    Tj, inl_j, n_j = j_ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(w),
                                  jnp.asarray(K), jkey)
    draws = jax.random.randint(jkey, (N_ITERS, SAMPLE), 0, max(int(valid.sum()), 1))
    Tt, inl_t, n_t = ransac_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(valid),
                                torch.from_numpy(w), torch.from_numpy(K),
                                torch.from_numpy(np.array(draws)))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-3)
    assert abs(int(n_t) - int(n_j)) <= 2 and int(n_t) > 15
    assert int((inl_t.numpy() != np.asarray(inl_j)).sum()) <= 2
    Rj, _, _ = j_optimize_pose(Tj, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w), jnp.asarray(valid),
                               jnp.asarray(K))
    Rt, _, _ = optimize_pose(Tt, torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(w),
                             torch.from_numpy(valid), torch.from_numpy(K))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), T_true, atol=2e-2)
