"""Binary vocabulary + bag-of-words place recognition — DBoW2 replacement.

JAX redesign of the vendored DBoW2 stack
(/root/reference/Thirdparty/DBoW2: `TemplatedVocabulary` k-d word tree,
`BowVector`/`FeatureVector`, L1 `ScoringObject`) and `KeyFrameDatabase`'s
inverted index (/root/reference/src/algorithm/KeyFrameDatabase.cc:104-402).

Design (SURVEY.md §7.0 substitution table):
  * the vocabulary is a flattened hierarchical k-medians tree over packed
    256-bit descriptors; word assignment for a whole frame is a batched
    Hamming argmin *descent* (L gather+popcount rounds), not a pointer walk;
  * BoW vectors are dense (num_words,) tf-idf arrays, L1-normalized;
  * the inverted file is replaced by scoring a query against the entire
    keyframe BoW matrix in one vectorized `sum(min(q, M))` pass — for
    L1-normalized non-negative vectors this equals the DBoW2 L1 score
    ``1 - 0.5 * |q - m|_1``;
  * the DBoW2 "direct index" used to accelerate matching becomes per-feature
    word ids: BoW-gated matching masks pairs with equal (or same-parent)
    word ids (frontend/matching.py window_mask).

Training is a host-side numpy k-medians (majority bit voting) — the
reference ships a pre-trained 100 MB binary vocabulary (System.cc:109);
here a compact vocabulary is trained on-domain (KITTI or synthetic) in
seconds, and the descriptor pattern (orb._brief_pattern) is fixed, so
vocabulary and descriptors always agree.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Shipped vocabulary asset (the counterpart of the reference's pre-trained
# ORBvoc binary, System.cc:109) — regenerated deterministically by
# scripts/train_vocab.py over many synthetic frames.
DEFAULT_ASSET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "assets",
    "orbvoc_synth_k10_d4.npz",
)


class Vocabulary(NamedTuple):
    """Flattened k-ary tree. Level l has k^(l+1) centroids; children of node
    n at level l are rows [n*k, (n+1)*k) of centroids[l]."""

    centroids: tuple  # length-L tuple of (k^(l+1), 8) uint32 arrays
    idf: jnp.ndarray  # (num_words,) inverse-document-frequency weights
    k: int

    @property
    def num_words(self) -> int:
        return self.centroids[-1].shape[0]

    @property
    def depth(self) -> int:
        return len(self.centroids)


_POP_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_chunked(
    data: np.ndarray, cents: np.ndarray, chunk: int = 65536
) -> np.ndarray:
    """(n, kk) Hamming distances without the (n, kk, 256) unpackbits blowup
    (training at 10^6-descriptor corpus scale needs bounded temporaries)."""
    n, kk = data.shape[0], cents.shape[0]
    out = np.empty((n, kk), np.int32)
    for s in range(0, n, chunk):
        x = np.bitwise_xor(data[s : s + chunk, None, :], cents[None, :, :])
        out[s : s + chunk] = (
            _POP_LUT[x.view(np.uint8)].sum(-1, dtype=np.int32)
        )
    return out


def _majority_medoid(descs: np.ndarray) -> np.ndarray:
    """Majority bit vote over packed uint32 descriptors -> one centroid."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train(
    descriptors: np.ndarray,
    k: int = 10,
    depth: int = 3,
    iters: int = 8,
    seed: int = 0,
) -> Vocabulary:
    """Hierarchical binary k-medians. descriptors: (N, 8) uint32 (N >= k^depth)."""
    rng = np.random.RandomState(seed)
    descs = np.ascontiguousarray(descriptors.astype(np.uint32))

    def kmedians(data, kk):
        n = data.shape[0]
        if n == 0:
            return np.zeros((kk, 8), np.uint32), np.zeros((0,), np.int64)
        init = data[rng.choice(n, size=min(kk, n), replace=False)]
        cents = np.zeros((kk, 8), np.uint32)
        cents[: init.shape[0]] = init
        assign = np.zeros(n, np.int64)
        for _ in range(iters):
            d = _hamming_chunked(data, cents)  # (n, kk)
            assign = d.argmin(1)
            for c in range(kk):
                sel = data[assign == c]
                if len(sel):
                    cents[c] = _majority_medoid(sel)
                else:  # re-seed empty cluster
                    cents[c] = data[rng.randint(n)]
        return cents, assign

    levels = []
    groups = {(): descs}
    for lvl in range(depth):
        cents_lvl = np.zeros((k ** (lvl + 1), 8), np.uint32)
        new_groups = {}
        for path, data in groups.items():
            base = 0
            for i, p in enumerate(path):
                base = base * k + p
            cents, assign = kmedians(data, k)
            cents_lvl[base * k : (base + 1) * k] = cents
            for c in range(k):
                new_groups[path + (c,)] = data[assign == c]
        levels.append(jnp.asarray(cents_lvl))
        groups = new_groups

    # idf from training corpus: idf_w = log(N / (1 + n_w)).
    voc = Vocabulary(centroids=tuple(levels), idf=jnp.ones(k**depth), k=k)
    words = np.asarray(assign_words(voc, jnp.asarray(descs), jnp.ones(len(descs), bool)))
    counts = np.bincount(words, minlength=k**depth).astype(np.float32)
    idf = np.log(len(descs) / (1.0 + counts))
    idf = np.maximum(idf, 0.0) + 1e-3
    return voc._replace(idf=jnp.asarray(idf))


def assign_words(
    voc: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Descend the tree: (N, 8) uint32 -> (N,) int32 word ids (jit-safe)."""
    node = jnp.zeros(desc.shape[0], dtype=jnp.int32)
    for lvl in range(voc.depth):
        cents = voc.centroids[lvl]  # (k^(l+1), 8)
        child_ids = node[:, None] * voc.k + jnp.arange(voc.k, dtype=jnp.int32)[None, :]
        cand = cents[child_ids]  # (N, k, 8)
        d = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(desc[:, None, :], cand)),
            axis=-1,
        )
        node = jnp.take_along_axis(child_ids, jnp.argmin(d, axis=1)[:, None], axis=1)[
            :, 0
        ]
    return jnp.where(valid, node, -1).astype(jnp.int32)


def bow_vector(voc: Vocabulary, words: jnp.ndarray) -> jnp.ndarray:
    """(N,) word ids -> L1-normalized tf-idf vector (num_words,)."""
    valid = words >= 0
    w_safe = jnp.where(valid, words, 0)
    tf = jnp.zeros(voc.num_words, dtype=jnp.float32).at[w_safe].add(
        valid.astype(jnp.float32)
    )
    v = tf * voc.idf
    return v / jnp.maximum(jnp.sum(v), 1e-9)


def l1_score(q: jnp.ndarray, M: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity of query q (W,) against rows of M (K, W).

    For L1-normalized non-negative vectors: 1 - 0.5 |q - m|_1 = sum min(q, m).
    """
    return jnp.sum(jnp.minimum(q[None, :], M), axis=-1)


def bow_window_mask(
    words_q: jnp.ndarray, words_t: jnp.ndarray, levels_up: int = 0, k: int = 10
) -> jnp.ndarray:
    """(Q, T) mask of same-node pairs — the DBoW2 FeatureVector 'direct
    index' acceleration for SearchByBoW (ORBmatcher.cc:246).

    `levels_up` gates on ancestor nodes `word // k**levels_up` instead of
    leaf words (the reference's direct-index level, TemplatedVocabulary
    m_levelsup) — deeper vocabularies need coarser gating or the candidate
    sets collapse."""
    if levels_up > 0:
        div = k ** levels_up
        words_q = jnp.where(words_q >= 0, words_q // div, -1)
        words_t = jnp.where(words_t >= 0, words_t // div, -1)
    return (words_q[:, None] == words_t[None, :]) & (words_q[:, None] >= 0)


# ----------------------------------------------------------------------
# Persistence (the reference's loadFromTextFile/binary, System.cc:93-117)
# ----------------------------------------------------------------------


def save(voc: Vocabulary, path: str) -> None:
    np.savez_compressed(
        path,
        k=np.int64(voc.k),
        depth=np.int64(voc.depth),
        idf=np.asarray(voc.idf),
        **{f"level{i}": np.asarray(c) for i, c in enumerate(voc.centroids)},
    )


def load(path: str) -> Vocabulary:
    z = np.load(path)
    depth = int(z["depth"])
    return Vocabulary(
        centroids=tuple(jnp.asarray(z[f"level{i}"]) for i in range(depth)),
        idf=jnp.asarray(z["idf"]),
        k=int(z["k"]),
    )


def load_default() -> Optional[Vocabulary]:
    """The committed synthetic-domain vocabulary, or None if absent."""
    path = os.path.normpath(DEFAULT_ASSET)
    if os.path.exists(path):
        return load(path)
    return None
