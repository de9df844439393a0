"""Keyframe recognition database: BoW scoring over all keyframes (port of
weiner_slamit_v2_tpu/bow/database.py; KeyFrameDatabase,
src/KeyFrameDatabase.cc).

The reference walks an inverted file per query; here each keyframe has a
dense (n_words,) BoW row and a query is a few masked reductions over the
(max_kf, n_words) matrix. Pre-trained vocabularies above 65,536 words use the
sparse form: per-keyframe (word id, weight) rows, scored by scattering the
query once and gathering it at every row's word ids.

Candidate gating mirrors DetectRelocalizationCandidates /
DetectLoopCandidates (KeyFrameDatabase.cc:84-328): shared words above 0.8x
the best, L1 similarity, scores accumulated over each candidate's top-10
covisible neighbors, keep above 0.75x the best accumulated score.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import torch

from ..util import put, resolve_device, topk
from .vocabulary import Vocabulary, bow_vector, l1_score, train_vocabulary, transform

DENSE_MAX_WORDS = 65536   # above this, rows are sparse (1M words x 4 B = 4 MB a dense row)


@dataclass
class KeyframeDatabase:
    bow: torch.Tensor        # (K, W) float32 L1-normalized tf-idf row per keyframe
    has_entry: torch.Tensor  # (K,) bool

    @classmethod
    def create(cls, max_kf: int, n_words: int, device=None) -> "KeyframeDatabase":
        dev = resolve_device(device)
        return cls(bow=torch.zeros((max_kf, n_words), device=dev),
                   has_entry=torch.zeros(max_kf, dtype=torch.bool, device=dev))

    def replace(self, **kw) -> "KeyframeDatabase":
        return dataclasses.replace(self, **kw)


def add_keyframe_bow(db: KeyframeDatabase, kf_id: int, v: torch.Tensor) -> KeyframeDatabase:
    """Register a keyframe's BoW vector (KeyFrameDatabase::add)."""
    return db.replace(bow=put(db.bow, torch.tensor(kf_id), v),
                      has_entry=put(db.has_entry, torch.tensor(kf_id), True))


def erase_keyframe_bow(db: KeyframeDatabase, kf_id: int) -> KeyframeDatabase:
    return db.replace(bow=put(db.bow, torch.tensor(kf_id), 0.0),
                      has_entry=put(db.has_entry, torch.tensor(kf_id), False))


def _mask_db_valid(db: KeyframeDatabase, kf_valid: torch.Tensor) -> KeyframeDatabase:
    """Zero the rows of keyframes no longer valid in the map."""
    keep = db.has_entry & kf_valid
    return db.replace(bow=torch.where(keep[:, None], db.bow, 0.0), has_entry=keep)


def _kf_words(vocab: Vocabulary, kf_desc, kf_feat_valid):
    K, N, _ = kf_desc.shape
    words, _ = transform(vocab, kf_desc.reshape(K * N, 8), kf_feat_valid.reshape(K * N))
    return words.reshape(K, N)


def build_db_from_keyframes(vocab: Vocabulary, kf_desc, kf_feat_valid, kf_valid) -> KeyframeDatabase:
    """Re-index every valid keyframe in one batched pass (after the
    vocabulary is (re)trained)."""
    rows = bow_vector(vocab, _kf_words(vocab, kf_desc, kf_feat_valid))
    return KeyframeDatabase(bow=torch.where(kf_valid[:, None], rows, 0.0), has_entry=kf_valid)


def _common_words(db: KeyframeDatabase, v: torch.Tensor) -> torch.Tensor:
    """(K,) number of vocabulary words shared with the query."""
    return ((db.bow > 0) & (v[None, :] > 0)).sum(1, dtype=torch.int32)


def _gate_candidates(eligible, common, scores, covis_weights, min_score):
    """Shared candidate gating (KeyFrameDatabase.cc:84-328): 0.8x-max common
    words, similarity floor, score accumulated over the top-10 covisible
    neighbors, keep above 0.75x the best accumulated score."""
    common = torch.where(eligible, common, 0)
    min_common = (0.8 * common.max()).to(torch.int32)          # KeyFrameDatabase.cc:129
    pass1 = eligible & (common > min_common) & (scores >= min_score)
    nb_w = torch.where(pass1[None, :], covis_weights, 0)
    top_w, top_i = topk(nb_w, min(10, nb_w.shape[1]))
    nb_scores = torch.where(top_w > 0, scores[top_i], 0.0)
    acc = torch.where(pass1, scores, 0.0) + nb_scores.sum(1)
    best_acc = torch.where(pass1, acc, 0.0).max()
    return acc, pass1 & (acc > 0.75 * best_acc)                 # KeyFrameDatabase.cc:185


def query_candidates(db: KeyframeDatabase, v, exclude, covis_weights, min_score=0.0):
    """(accumulated scores (K,), candidate mask (K,)) of a dense (W,) query
    against every row. exclude: (K,) keyframes that may not be candidates;
    covis_weights: (K, K); min_score: the similarity floor (0 for
    relocalization)."""
    eligible = db.has_entry & ~exclude
    return _gate_candidates(eligible, _common_words(db, v), l1_score(db.bow, v),
                            covis_weights, min_score)


# --- sparse rows: (word id, weight) lists for DBoW2-scale vocabularies --------

@dataclass
class SparseKeyframeDatabase:
    wid: torch.Tensor        # (K, S) int32 word ids, -1 padding
    wt: torch.Tensor         # (K, S) float32 L1-normalized tf-idf weights
    has_entry: torch.Tensor  # (K,) bool

    @classmethod
    def create(cls, max_kf: int, slots: int, device=None) -> "SparseKeyframeDatabase":
        dev = resolve_device(device)
        return cls(wid=torch.full((max_kf, slots), -1, dtype=torch.int32, device=dev),
                   wt=torch.zeros((max_kf, slots), device=dev),
                   has_entry=torch.zeros(max_kf, dtype=torch.bool, device=dev))

    def replace(self, **kw) -> "SparseKeyframeDatabase":
        return dataclasses.replace(self, **kw)


def sparse_bow_row(vocab: Vocabulary, word_ids: torch.Tensor):
    """(..., N) word ids (-1 invalid) -> ((..., N) distinct word ids, -1
    padded, ascending; (..., N) L1-normalized tf-idf weights). Repeated words
    merge, so min-based L1 scoring sees per-word totals."""
    N = word_ids.shape[-1]
    big = 2**30
    ws = torch.sort(torch.where(word_ids >= 0, word_ids.to(torch.int32), big), -1).values
    ok = ws < big
    is_first = torch.cat([torch.ones_like(ok[..., :1]), ws[..., 1:] != ws[..., :-1]], -1) & ok
    grp = torch.cumsum(is_first.to(torch.int64), -1) - 1
    lead = ws.shape[:-1]
    counts = torch.zeros((*lead, N + 1), device=ws.device).scatter_add_(
        -1, torch.where(ok, grp, N), ok.to(torch.float32))[..., :N]
    uw = torch.full((*lead, N + 1), -1, dtype=torch.int32, device=ws.device).scatter_(
        -1, torch.where(is_first, grp, N), ws)[..., :N]
    tf = counts * torch.where(uw >= 0, vocab.word_idf[uw.clamp(min=0).long()], 0.0)
    return uw, tf / torch.clamp(tf.sum(-1, keepdim=True), min=1e-9)


def _dense_query_vec(q_wid, q_wt, n_words: int) -> torch.Tensor:
    return put(torch.zeros(n_words, device=q_wt.device), torch.where(q_wid >= 0, q_wid, n_words), q_wt)


def sparse_scores(db: SparseKeyframeDatabase, q_wid, q_wt, n_words: int):
    """(scores (K,), common-word counts (K,)) of the query against every row."""
    qv = _dense_query_vec(q_wid, q_wt, n_words)
    g = qv[db.wid.clamp(min=0).long()] * (db.wid >= 0)
    scores = 2.0 * torch.minimum(g, db.wt).sum(-1)
    return scores, ((g > 0) & (db.wt > 0)).sum(-1, dtype=torch.int32)


def query_candidates_sparse(db: SparseKeyframeDatabase, q_wid, q_wt, exclude, covis_weights,
                            min_score, n_words: int):
    scores, common = sparse_scores(db, q_wid, q_wt, n_words)
    return _gate_candidates(db.has_entry & ~exclude, common, scores, covis_weights, min_score)


def build_sparse_db_from_keyframes(vocab: Vocabulary, kf_desc, kf_feat_valid,
                                   kf_valid) -> SparseKeyframeDatabase:
    wid, wt = sparse_bow_row(vocab, _kf_words(vocab, kf_desc, kf_feat_valid))
    return SparseKeyframeDatabase(wid=torch.where(kf_valid[:, None], wid, -1),
                                  wt=torch.where(kf_valid[:, None], wt, 0.0), has_entry=kf_valid)


class BowIndex:
    """Owner of the vocabulary and the keyframe database, updated per
    keyframe: the (vocabulary, KeyFrameDatabase) pair of System
    (src/System.cc:124-139). Without a pre-trained vocabulary, the vocabulary
    is trained from the session's first keyframes; until then, added
    keyframes wait in a list."""

    def __init__(self, max_kf: int, branching: int = 10, depth: int = 4,
                 vocab: Vocabulary | None = None, sparse_slots: int = 1024, device=None):
        """vocab: a pre-trained vocabulary (vocabulary_from_dbow2 of an
        ORBvoc.txt-format file, as the reference loads at
        src/System.cc:124-129). Above DENSE_MAX_WORDS words, rows are sparse;
        give sparse_slots the feature budget so that no row is truncated."""
        self.device = resolve_device(device)
        self.branching, self.depth = branching, depth
        self.max_kf = max_kf
        self.sparse_slots = sparse_slots
        self.vocab: Vocabulary | None = None
        self.db = None
        self.pretrained = vocab is not None
        self.sparse = False
        self._pending: list = []
        if vocab is not None:
            self.branching, self.depth = vocab.branching, vocab.depth
            self.vocab = vocab
            self.sparse = vocab.n_words > DENSE_MAX_WORDS
            self.db = (SparseKeyframeDatabase.create(max_kf, sparse_slots, self.device) if self.sparse
                       else KeyframeDatabase.create(max_kf, vocab.n_words, self.device))

    @classmethod
    def from_pretrained(cls, path: str, max_kf: int, sparse_slots: int = 1024,
                        device=None) -> "BowIndex":
        """From a DBoW2-format text vocabulary file (ORBvoc.txt)."""
        from .vocabulary import vocabulary_from_dbow2

        return cls(max_kf, vocab=vocabulary_from_dbow2(path, device), sparse_slots=sparse_slots,
                   device=device)

    @property
    def ready(self) -> bool:
        return self.vocab is not None

    def maybe_train(self, desc, valid, uniforms) -> None:
        """Train the vocabulary on the corpus (N, 8) if it has none, then add
        the keyframes that waited for it. uniforms: ``depth`` (N,) seeding
        draws."""
        if self.vocab is None:
            self.vocab = train_vocabulary(desc, valid, uniforms, self.branching, self.depth)
            self.db = KeyframeDatabase.create(self.max_kf, self.vocab.n_words, self.device)
            for kf_id, d, dv in self._pending:
                self.add(kf_id, d, dv)
            self._pending = []

    def retrain(self, kf_desc, kf_feat_valid, kf_valid, uniforms) -> None:
        """Retrain on every keyframe slot's descriptors (masked by validity)
        and re-index all keyframes: the first vocabulary, from ~4 keyframes,
        leaves most words empty. A pre-trained vocabulary is kept (the
        reference parses ORBvoc.txt once); only the rows are rebuilt."""
        K, N, _ = kf_desc.shape
        if not self.pretrained:
            self.vocab = train_vocabulary(
                kf_desc.reshape(K * N, 8),
                kf_feat_valid.reshape(K * N) & kf_valid.repeat_interleave(N),
                uniforms, self.branching, self.depth)
        self.reindex(kf_desc, kf_feat_valid, kf_valid)

    def reindex(self, kf_desc, kf_feat_valid, kf_valid) -> None:
        """Rebuild every row from keyframe descriptors in one batched pass."""
        build = build_sparse_db_from_keyframes if self.sparse else build_db_from_keyframes
        self.db = build(self.vocab, kf_desc, kf_feat_valid, kf_valid)

    def add(self, kf_id: int, desc, valid) -> None:
        if self.vocab is None:
            self._pending.append((kf_id, desc, valid))
            return
        words, _ = transform(self.vocab, desc, valid)
        if not self.sparse:
            self.db = add_keyframe_bow(self.db, kf_id, bow_vector(self.vocab, words))
            return
        wid, wt = sparse_bow_row(self.vocab, words)
        S = self.db.wid.shape[1]
        if wid.shape[0] > S:
            warnings.warn(f"sparse BoW row truncated: {wid.shape[0]} words > {S} slots; "
                          "scores for this frame are underestimated", stacklevel=2)
        pad = S - min(wid.shape[0], S)
        wid = torch.cat([wid[:S], torch.full((pad,), -1, dtype=torch.int32, device=wid.device)])
        wt = torch.cat([wt[:S], torch.zeros(pad, device=wt.device)])
        k = torch.tensor(kf_id)
        self.db = self.db.replace(wid=put(self.db.wid, k, wid), wt=put(self.db.wt, k, wt),
                                  has_entry=put(self.db.has_entry, k, True))

    def erase(self, kf_id: int) -> None:
        if self.db is None:
            return
        if not self.sparse:
            self.db = erase_keyframe_bow(self.db, kf_id)
            return
        k = torch.tensor(kf_id)
        self.db = self.db.replace(wid=put(self.db.wid, k, -1), wt=put(self.db.wt, k, 0.0),
                                  has_entry=put(self.db.has_entry, k, False))

    def mask_valid(self, kf_valid) -> None:
        """Erase the rows of every culled keyframe (KeyFrameDatabase::erase,
        src/KeyFrameDatabase.cc:60-75): the culls happen inside the mapping
        pass, so callers pass the map's kf_valid before a query."""
        if self.db is None:
            return
        if not self.sparse:
            self.db = _mask_db_valid(self.db, kf_valid)
            return
        keep = self.db.has_entry & kf_valid
        self.db = self.db.replace(wid=torch.where(keep[:, None], self.db.wid, -1),
                                  wt=torch.where(keep[:, None], self.db.wt, 0.0), has_entry=keep)

    def permute(self, kf_map) -> None:
        """Renumber rows after map compaction: row old -> kf_map[old] (-1
        rows dropped)."""
        if self.db is None:
            return
        K = self.db.has_entry.shape[0]
        tgt = torch.where(kf_map >= 0, kf_map, K)
        db = self.db
        fields = ("wid", "wt", "has_entry") if self.sparse else ("bow", "has_entry")
        fill = {"wid": -1, "wt": 0.0, "bow": 0.0, "has_entry": False}
        self.db = db.replace(**{f: put(torch.full_like(getattr(db, f), fill[f]), tgt, getattr(db, f))
                                for f in fields})

    # -- queries (dense or sparse) ---------------------------------------------
    def query_vector(self, desc, valid):
        """A frame's query: a dense (W,) vector, or a (wid, wt) pair when sparse."""
        words, _ = transform(self.vocab, desc, valid)
        return sparse_bow_row(self.vocab, words) if self.sparse else bow_vector(self.vocab, words)

    def row_query(self, kf_id: int):
        """A keyframe's stored row, as a query."""
        if self.sparse:
            return self.db.wid[kf_id], self.db.wt[kf_id]
        return self.db.bow[kf_id]

    def score_rows(self, row_ids, q) -> torch.Tensor:
        """L1 similarity of query q against the given rows."""
        row_ids = torch.as_tensor(row_ids, device=self.device).long()
        if self.sparse:
            sub = SparseKeyframeDatabase(wid=self.db.wid[row_ids], wt=self.db.wt[row_ids],
                                         has_entry=self.db.has_entry[row_ids])
            return sparse_scores(sub, q[0], q[1], self.vocab.n_words)[0]
        return l1_score(self.db.bow[row_ids], q)

    def candidates(self, q, exclude, covis_weights, min_score: float = 0.0):
        """(accumulated scores, candidate mask) of a query against the whole
        database."""
        if self.sparse:
            return query_candidates_sparse(self.db, q[0], q[1], exclude, covis_weights,
                                           min_score, self.vocab.n_words)
        return query_candidates(self.db, q, exclude, covis_weights, min_score)

