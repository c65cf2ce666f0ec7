"""Descriptor matching: batched Hamming distance + windowed/rotation-gated search.

JAX redesign of the reference `ORBmatcher`
(/root/reference/src/frontend/ORBmatcher.cc): thresholds TH_HIGH=100,
TH_LOW=50, HISTO_LENGTH=30 (:46-48), `DescriptorDistance` bit-count (:2096),
`SearchByProjection` frame/local-map (:67, :1717), `SearchForInitialization`
(:573), `Fuse` (:1109).

Instead of per-keypoint grid walks + candidate lists, the whole matcher is a
masked (Q, T) Hamming matrix: XOR + popcount on uint32x8 packed descriptors
(one fused XLA computation), with window constraints, mutual-best / ratio
tests, and the rotation-consistency histogram applied as vectorized masks.
All outputs are fixed-capacity index arrays with validity masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

TH_HIGH = 100  # ORBmatcher.cc:46
TH_LOW = 50  # ORBmatcher.cc:47
HISTO_LENGTH = 30  # ORBmatcher.cc:48
_BIG = jnp.int32(1 << 20)


def hamming_matrix(desc_q: jnp.ndarray, desc_t: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distances between packed descriptors.

    desc_q: (Q, 8) uint32; desc_t: (T, 8) uint32 -> (Q, T) int32 in [0, 256].
    XLA fuses the XOR, popcount and 8-word sum into one reduction, so the
    (Q, T, 8) intermediate is never stored.
    """
    with jax.named_scope("hamming_matrix"):
        x = jnp.bitwise_xor(desc_q[:, None, :], desc_t[None, :, :])
        return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


class MatchResult(NamedTuple):
    idx: jnp.ndarray  # (Q,) int32 target index (undefined where invalid)
    dist: jnp.ndarray  # (Q,) int32 best Hamming distance
    valid: jnp.ndarray  # (Q,) bool


def _rotation_consistency(
    angle_q: jnp.ndarray, angle_t_matched: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the top-3 histogram
    bins (ORBmatcher `ComputeThreeMaxima` semantics, HISTO_LENGTH=30)."""
    dtheta = (angle_q - angle_t_matched) % (2.0 * jnp.pi)
    bins = jnp.floor(dtheta / (2.0 * jnp.pi) * HISTO_LENGTH).astype(jnp.int32)
    bins = jnp.clip(bins, 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, dtype=jnp.int32).at[bins].add(
        valid.astype(jnp.int32)
    )
    top3 = jax.lax.top_k(counts, 3)[0]
    # Reference keeps bins 2/3 only if reasonably populated vs the max.
    keep_count = jnp.where(top3 >= jnp.maximum(top3[0] / 10, 1), top3, -1)
    good_bin = jnp.zeros(HISTO_LENGTH, dtype=bool)
    for k in range(3):
        good_bin = good_bin | (counts == keep_count[k]) & (keep_count[k] > 0)
    return valid & good_bin[bins]


def match_descriptors(
    desc_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_q: jnp.ndarray,
    valid_t: jnp.ndarray,
    window_mask: Optional[jnp.ndarray] = None,
    max_dist: int = TH_LOW,
    ratio: Optional[float] = None,
    mutual=True,
    angles: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    octave_t: Optional[jnp.ndarray] = None,
) -> MatchResult:
    """Generic masked matcher: best target per query with all ORB gates.

    window_mask: optional (Q, T) bool of allowed pairs (projection window,
    BoW same-word, epipolar band, ... — caller-provided).
    ratio: best/second-best ratio test (e.g. 0.9 in SearchForInitialization,
    0.75/0.6 in BoW search). With `octave_t` given, the test applies ONLY
    when best and second-best keypoints sit on the same pyramid level — the
    reference's local-map SearchByProjection semantics
    (ORBmatcher.cc:196-247: cross-level runners-up are expected near a
    re-detected corner and must not veto the match).
    mutual: True requires the query to also be the target's best (Fuse /
    initialization semantics). "claim" resolves per-target conflicts by
    keeping the claiming query with the smallest distance — the reference's
    TrackLocalMap assignment (one map point per keypoint via
    F.mvpMapPoints[bestIdx] overwrite) made deterministic-best instead of
    last-writer-wins.
    angles: (angle_q (Q,), angle_t (T,)) enables rotation-consistency gating.
    """
    D = hamming_matrix(desc_q, desc_t)
    pair_ok = valid_q[:, None] & valid_t[None, :]
    if window_mask is not None:
        pair_ok = pair_ok & window_mask
    D_masked = jnp.where(pair_ok, D, _BIG)

    best_idx = jnp.argmin(D_masked, axis=1)
    best = jnp.min(D_masked, axis=1)
    valid = (best <= max_dist) & valid_q

    if ratio is not None:
        # Second best: mask out the best then re-min.
        cols = jnp.arange(D.shape[1])
        D2 = jnp.where(cols[None, :] == best_idx[:, None], _BIG, D_masked)
        second = jnp.min(D2, axis=1)
        second_idx = jnp.argmin(D2, axis=1)
        ratio_fail = best.astype(jnp.float32) >= ratio * second.astype(
            jnp.float32
        )
        if octave_t is not None:
            same_lvl = octave_t[best_idx] == octave_t[second_idx]
            ratio_fail = ratio_fail & same_lvl
        valid = valid & ~ratio_fail

    if mutual == "claim":
        # One query per target, best-claim wins. Tie-break on query index so
        # exactly one survives (distance < 256 and Q fit the int32 key).
        Q, T = D.shape
        # Invalid rows carry dist=_BIG (2^20); clip the key base to 512 so
        # key = dist*Q + q stays within int32 for any realistic Q.
        d_key = jnp.minimum(best, 512).astype(jnp.int32)
        key = d_key * Q + jnp.arange(Q, dtype=jnp.int32)
        sentinel = jnp.int32(513 * Q)
        tgt_best_key = (
            jnp.full(T, sentinel, jnp.int32)
            .at[best_idx]
            .min(jnp.where(valid, key, sentinel))
        )
        valid = valid & (key == tgt_best_key[best_idx])
    elif mutual:
        rev_best = jnp.argmin(jnp.where(pair_ok, D, _BIG), axis=0)  # (T,)
        valid = valid & (rev_best[best_idx] == jnp.arange(D.shape[0]))

    if angles is not None:
        angle_q, angle_t = angles
        valid = _rotation_consistency(angle_q, angle_t[best_idx], valid)

    return MatchResult(idx=best_idx.astype(jnp.int32), dist=best, valid=valid)


def predict_octave(
    dist: jnp.ndarray,
    max_dist: jnp.ndarray,
    scale_factor: float = 1.2,
    num_levels: int = 8,
) -> jnp.ndarray:
    """Predicted pyramid level for a landmark seen at distance `dist`.

    MapPoint::PredictScale semantics: level = ceil(log(maxDist/dist)/log(s))
    clipped to [0, num_levels). `max_dist` is the landmark's scale-invariance
    ceiling (store.lm_max_dist); entries that are not yet set (inf) predict
    level 0 — callers should also disable the octave gate for those."""
    ratio = max_dist / jnp.maximum(dist, 1e-6)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6)) / math.log(scale_factor))
    lvl = jnp.where(jnp.isfinite(max_dist), lvl, 0.0)
    return jnp.clip(lvl, 0, num_levels - 1).astype(jnp.int32)


def projection_window_mask(
    uv_pred: jnp.ndarray,
    uv_kp: jnp.ndarray,
    radius: jnp.ndarray,
    octave_pred: Optional[jnp.ndarray] = None,
    octave_kp: Optional[jnp.ndarray] = None,
    level_slack: int = 1,
    octave_gate: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """(Q, T) mask: keypoint t within `radius` of projection q, optional
    pyramid-level compatibility (SearchByProjection r=7/15 semantics,
    Tracking.cc:1503-1584; octave window [pred-1, pred+1] and per-landmark
    radius scaling mirror ORBmatcher.cc:88-105).

    `radius` may be per-query (Q,) — the scale-aware search widens it by the
    predicted level's scale factor. `octave_gate` (Q,) bool disables the
    level gate per query (landmarks whose scale range is not yet set)."""
    d = uv_pred[:, None, :] - uv_kp[None, :, :]
    dist2 = jnp.sum(d * d, axis=-1)
    r = jnp.broadcast_to(jnp.asarray(radius, dtype=uv_pred.dtype), (uv_pred.shape[0],))
    mask = dist2 <= (r[:, None] * r[:, None])
    if octave_pred is not None and octave_kp is not None:
        dl = octave_kp[None, :] - octave_pred[:, None]
        level_ok = (dl >= -level_slack) & (dl <= level_slack)
        if octave_gate is not None:
            level_ok = level_ok | ~octave_gate[:, None]
        mask = mask & level_ok
    return mask
