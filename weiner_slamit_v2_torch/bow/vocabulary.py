"""Visual vocabulary: hierarchical binary k-means, batched tree descent
(port of weiner_slamit_v2_tpu/bow/vocabulary.py; DBoW2's
TemplatedVocabulary, Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h).

The tree is an implicit complete K-ary tree stored as one descriptor tensor
per level: the children of node i at level l are nodes [i*K, i*K+K) at
level l+1, so descent is a gather plus a Hamming argmin per level for all
descriptors at once. Training is hierarchical k-means with the
bitwise-majority centroid (FORB::meanValue, DBoW2/src/FORB.cpp:31-79),
every node of a level refined by one segment sum per iteration.

Descriptors are int32 bit patterns of the reference's uint32 words. The
k-means seeding draws are an argument: one (N,) float32 tensor of uniforms
per level, which the tracker draws from a seeded ``torch.Generator`` and the
tests take from the JAX package's own ``jax.random`` keys.

The DBoW2 text format (ORBvoc.txt) is read and written on the host with
numpy, in the port's own copy of that code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.hamming import popcount32
from ..util import resolve_device

_FAR = 10_000   # distance to an untrained node: never the argmin


@dataclass
class Vocabulary:
    """Implicit complete K-ary tree of binary descriptor centroids."""

    level_desc: tuple       # per level l: (K^(l+1), 8) int32 centroids
    level_valid: tuple      # per level l: (K^(l+1),) bool, node trained
    word_idf: torch.Tensor  # (K^L,) float32 idf weight per leaf word
    branching: int = 10
    depth: int = 4

    @property
    def n_words(self) -> int:
        return self.branching**self.depth


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) float32 of bits (the arithmetic shift's sign
    fill is masked off by the & 1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(M, 256) bool/float -> (M, 8) int32 bit patterns (summed in int64, then
    wrapped to the int32 pattern of the uint32 word)."""
    b = (bits > 0.5).to(torch.int64).reshape(-1, 8, 32)
    v = (b << torch.arange(32, dtype=torch.int64, device=bits.device)).sum(-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount32(a ^ b).sum(-1, dtype=torch.int32)


def _descend(centers, ok, assign, desc, K: int) -> torch.Tensor:
    """Index (N,) of the nearest of each descriptor's K candidate children
    (first on ties); untrained children never win."""
    cand = centers.reshape(-1, K, 8)[assign]                    # (N, K, 8)
    d = _hamming(desc[:, None, :], cand)
    d = torch.where(ok.reshape(-1, K)[assign], d, _FAR)
    return torch.argmin(d, 1)


def _seed_level(desc, valid, assign, r, n_parents: int, K: int):
    """Seed each parent's K children with member descriptors in a random
    order: the i-th member in the order sorted by (parent, r) seeds child
    min(i, K-1). Slot K-1 of a parent with more than K members gets many
    writes; as in the JAX package on the CPU, the last one in that order
    wins (here by a max over positions, so the device's scatter order never
    decides)."""
    N = desc.shape[0]
    dev = desc.device
    order = torch.argsort(assign.to(torch.float32) * 2.0 + r, stable=True)
    sorted_assign = assign[order]
    first = torch.searchsorted(sorted_assign, torch.arange(n_parents, dtype=assign.dtype, device=dev))
    pos = torch.arange(N, device=dev)
    rank = pos - first[sorted_assign.clamp(0, n_parents - 1)]
    seed_slot = sorted_assign.long() * K + rank.clamp(max=K - 1)
    last = torch.full((n_parents * K,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, seed_slot, pos, reduce="amax", include_self=True)
    written = last >= 0
    src = order[last.clamp(min=0)]
    centers = torch.where(written[:, None], desc[src], 0)
    return centers, written & valid[src]


def train_vocabulary(desc: torch.Tensor, valid: torch.Tensor, uniforms, branching: int = 10,
                     depth: int = 4, kmeans_iters: int = 6) -> Vocabulary:
    """Train the hierarchical vocabulary from a descriptor corpus.

    desc: (N, 8) int32; valid: (N,) bool; uniforms: ``depth`` (N,) float32
    tensors in [0, 1), the seeding draws of each level. The node assignment
    of every descriptor is carried down the tree, so one segment sum per
    k-means iteration refines all nodes of a level. Segment sums are of 0/1
    values, exact in float32 in any order (``index_add_``)."""
    K = branching
    N = desc.shape[0]
    dev = desc.device
    w = valid.to(torch.float32)
    bits_w = _unpack_bits(desc) * w[:, None]
    assign = torch.zeros(N, dtype=torch.int64, device=dev)
    level_desc, level_valid = [], []
    for lvl in range(depth):
        n_parents, n_nodes = K**lvl, K ** (lvl + 1)
        centers, seeded = _seed_level(desc, valid, assign, uniforms[lvl].to(dev), n_parents, K)
        child = torch.zeros(N, dtype=torch.int64, device=dev)
        for _ in range(kmeans_iters):
            child = _descend(centers, seeded, assign, desc, K)
            group = assign * K + child
            sums = torch.zeros((n_nodes, 256), device=dev).index_add_(0, group, bits_w)
            cnts = torch.zeros(n_nodes, device=dev).index_add_(0, group, w)
            has = cnts > 0
            maj = sums > 0.5 * torch.clamp(cnts, min=1.0)[:, None]   # FORB::meanValue
            centers = torch.where(has[:, None], _pack_bits(maj), centers)
            seeded = seeded | has
        assign = assign * K + child
        level_desc.append(centers)
        level_valid.append(seeded)

    # idf = log(N / n_i) over the training corpus (TF_IDF weighting)
    counts = torch.zeros(K**depth, device=dev).index_add_(0, assign, w)
    n_valid = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    idf = torch.where(counts > 0, torch.log(n_valid / torch.clamp(counts, min=1.0)), 0.0)
    return Vocabulary(level_desc=tuple(level_desc), level_valid=tuple(level_valid),
                      word_idf=idf, branching=K, depth=depth)


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Quantize descriptors to leaf words by batched tree descent. Returns
    (word ids (N,) int32, -1 where invalid; the depth-2 ancestor (N,), the
    feature-grouping node of TemplatedVocabulary.h:1134-1201)."""
    K = vocab.branching
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for lvl in range(vocab.depth):
        node = node * K + _descend(vocab.level_desc[lvl], vocab.level_valid[lvl], node, desc, K)
    node = node.to(torch.int32)
    return torch.where(valid, node, -1), torch.where(valid, node // (K * K), -1)


def bow_vector(vocab: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Dense TF-IDF BoW vector, L1-normalized (DBoW2's BowVector): (..., N)
    word ids from ``transform`` (-1 ignored) -> (..., n_words) float32. The
    word counts are integer-valued sums, exact in any order."""
    W = vocab.n_words
    lead = word_ids.shape[:-1]
    rows = word_ids.reshape(-1, word_ids.shape[-1]).long()
    idx = torch.where(rows >= 0, rows, W) + (W + 1) * torch.arange(
        rows.shape[0], device=rows.device)[:, None]
    v = torch.zeros(rows.shape[0] * (W + 1), device=rows.device)
    v.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), device=rows.device))
    v = v.reshape(-1, W + 1)[:, :W].reshape(*lead, W) * vocab.word_idf
    return v / torch.clamp(v.sum(-1, keepdim=True), min=1e-9)


def l1_score(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 2 * sum_i min(v_i, w_i) of L1-normalized vectors
    (L1Scoring::score, DBoW2/src/ScoringObject.cpp:23-70), batched over the
    leading dims of either argument."""
    return 2.0 * torch.minimum(v, w).sum(-1)


# --- the DBoW2 text format (host side, numpy) ---------------------------------

def load_dbow2_text(path: str, max_nodes: int | None = None):
    """Parse a DBoW2 text vocabulary: header 'k L scoring weighting', then one
    node per line 'parent is_leaf d0..d31 weight' (TemplatedVocabulary.h:
    1345-1440). The node on line i has id i+1 (the root is 0); parents come
    before their children. Returns (k, L, nodes)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf, descs, weights = [], [], [], []
        for i, line in enumerate(f):
            if max_nodes is not None and i >= max_nodes:
                break
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf.append(int(parts[1]))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    return k, L, {
        "parent": np.asarray(parents, np.int64),
        "is_leaf": np.asarray(leaf, np.int64),
        "desc": np.asarray(descs, np.uint8).reshape(-1, 32),
        "weight": np.asarray(weights, np.float64),
    }


def _bytes_to_u32(desc_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32, little-endian within each word (any
    consistent packing keeps Hamming distances, FORB.cpp:81)."""
    b = desc_bytes.astype(np.uint32).reshape(-1, 8, 4)
    return (b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)).astype(np.uint32)


def _u32_to_bytes(desc_u32: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 32) uint8 (the inverse of _bytes_to_u32)."""
    d = desc_u32.astype(np.uint32)
    out = np.empty((d.shape[0], 8, 4), np.uint8)
    for i in range(4):
        out[:, :, i] = (d >> (8 * i)) & 0xFF
    return out.reshape(-1, 32)


def vocabulary_from_dbow2(path: str, device=None) -> Vocabulary:
    """Embed a DBoW2 text vocabulary (e.g. ORBvoc.txt, k=10 L=6) into the
    implicit complete tree. Each node's slot is parent_slot * k +
    sibling_rank, with ``level_valid`` masking slots without a node; a leaf
    above the last level continues as a single-child chain with its
    descriptor, so descent always ends at a last-level word; leaf weights
    become ``word_idf`` (TF_IDF: the stored weight is the idf)."""
    k, L, nodes = load_dbow2_text(path)
    parent = nodes["parent"]
    is_leaf = nodes["is_leaf"].astype(bool)
    weight = nodes["weight"].astype(np.float32)
    desc_u32 = _bytes_to_u32(nodes["desc"])
    n = parent.shape[0]
    ids = np.arange(1, n + 1)

    level = np.full(n + 1, -1, np.int64)
    level[0] = 0
    for l in range(1, L + 1):
        sel = (level[ids] == -1) & (level[parent] == l - 1)
        level[ids[sel]] = l
    if (level[ids] == -1).any():
        bad = int((level[ids] == -1).sum())
        raise ValueError(f"{bad} nodes deeper than L={L} or with forward parent refs")

    order = np.argsort(parent, kind="stable")       # sibling rank: order of appearance
    sp = parent[order]
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - np.searchsorted(sp, sp, side="left")
    if rank.max(initial=0) >= k:
        raise ValueError("a node has more than k children")

    slot = np.full(n + 1, -1, np.int64)
    slot[0] = 0
    for l in range(1, L + 1):
        sel = level[ids] == l
        slot[ids[sel]] = slot[parent[sel]] * k + rank[sel]

    level_desc = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(L)]
    level_valid = [np.zeros((k ** (l + 1),), bool) for l in range(L)]
    for l in range(1, L + 1):
        sel = level[ids] == l
        level_desc[l - 1][slot[ids[sel]]] = desc_u32[sel]
        level_valid[l - 1][slot[ids[sel]]] = True

    word_idf = np.zeros(k**L, np.float32)
    for l in range(1, L + 1):
        sel = is_leaf & (level[ids] == l)
        if not sel.any():
            continue
        cur = slot[ids[sel]]
        for lc in range(l, L):
            cur = cur * k
            level_desc[lc][cur] = desc_u32[sel]
            level_valid[lc][cur] = True
        word_idf[cur] = weight[sel]

    dev = resolve_device(device)
    return Vocabulary(
        level_desc=tuple(torch.from_numpy(a.view(np.int32)).to(dev) for a in level_desc),
        level_valid=tuple(torch.from_numpy(a).to(dev) for a in level_valid),
        word_idf=torch.from_numpy(word_idf).to(dev), branching=k, depth=L,
    )


def save_dbow2_text(vocab: Vocabulary, path: str) -> None:
    """Write the vocabulary in DBoW2's text format (the inverse of
    loadFromTextFile, TemplatedVocabulary.h:1286-1343): header 'k L 0 0'
    (L1_NORM, TF_IDF), then one line per node in level order; a slot under an
    untrained parent is skipped with its subtree."""
    K, L = vocab.branching, vocab.depth
    idf = vocab.word_idf.cpu().numpy()
    fid: dict[tuple[int, int], int] = {}
    next_id = 1
    with open(path, "w") as f:
        f.write(f"{K} {L} 0 0\n")
        for l in range(L):
            desc = _u32_to_bytes(vocab.level_desc[l].cpu().numpy().view(np.uint32))
            valid = vocab.level_valid[l].cpu().numpy()
            for s in np.nonzero(valid)[0]:
                pid = 0 if l == 0 else fid.get((l - 1, int(s) // K), -1)
                if pid < 0:
                    continue
                fid[(l, int(s))] = next_id
                leaf = 1 if l == L - 1 else 0
                w = float(idf[int(s)]) if leaf else 0.0
                f.write(f"{pid} {leaf} " + " ".join(str(int(x)) for x in desc[int(s)]) + f" {w:.6f}\n")
                next_id += 1
