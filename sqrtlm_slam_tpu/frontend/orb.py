"""ORB feature extraction — pyramid FAST + oriented BRIEF, tensorized for TPU.

JAX redesign of the reference `ORBextractor`
(/root/reference/src/frontend/ORBextractor.cc): image pyramid (:1224),
FAST + quad-tree keypoint balancing (:692-1045), intensity-centroid
orientation (:155-204) and steered BRIEF descriptors (:1204).

Design differences (deliberate, SURVEY.md §7.0):
  * The sequential octree `DistributeOctTree` becomes a **grid-bucketed
    top-k**: per-cell best corners, then a global top-N — deterministic and
    fully parallel. This preserves spatial spread (the octree's purpose)
    without data-dependent control flow.
  * FAST segment test is evaluated densely over the image as 16 shifted
    comparisons + windowed arc reduction (VPU-friendly), score = sum of
    absolute differences over the contiguous arc, NMS by 3x3 max-pooling.
  * The BRIEF sampling pattern is a fixed seeded Gaussian pattern (BRIEF
    paper construction) rather than the hand-learned OpenCV table — NOT
    bit-compatible with OpenCV ORB by design; the vocabulary is trained for
    this descriptor (frontend/vocab.py).
  * Everything is fixed-capacity: each level yields its capped keypoint
    count with a validity mask; total capacity = `max_features`.

All functions are jit-compatible; per-level shapes are static.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# FAST circle (radius 3, 16 pixels) — Bresenham circle offsets (dy, dx).
_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (level-0 pixel coordinates)."""

    xy: jnp.ndarray  # (N, 2) float32, level-0 coords
    score: jnp.ndarray  # (N,) FAST score
    angle: jnp.ndarray  # (N,) radians
    octave: jnp.ndarray  # (N,) int32 pyramid level
    valid: jnp.ndarray  # (N,) bool
    desc: jnp.ndarray  # (N, 8) uint32 — 256-bit packed descriptor

    @property
    def capacity(self):
        return self.xy.shape[0]


class ORBConfig(NamedTuple):
    max_features: int = 2000  # reference cfg: 2000 (cfg/KITTI04-12.yaml)
    num_levels: int = 8  # pyramid 8 x 1.2 (Tracking.cc:116-120)
    scale_factor: float = 1.2
    fast_threshold: int = 20  # iniThFAST 20 (cfg/KITTI*.yaml)
    fast_min_threshold: int = 7  # minThFAST: per-cell fallback re-detection
    cell_size: int = 32  # grid cell for top-k distribution
    per_cell: int = 4  # candidates kept per cell before global top-k
    patch_size: int = 31  # orientation patch


def scale_factors(cfg: ORBConfig) -> np.ndarray:
    return np.array([cfg.scale_factor**i for i in range(cfg.num_levels)], dtype=np.float32)


def level_sigma2(cfg: ORBConfig) -> np.ndarray:
    s = scale_factors(cfg)
    return (s * s).astype(np.float32)


def features_per_level(cfg: ORBConfig) -> List[int]:
    """Geometric distribution of the feature budget over levels
    (ORBextractor.cc ctor:474 semantics)."""
    factor = 1.0 / cfg.scale_factor
    n_first = cfg.max_features * (1 - factor) / (1 - factor**cfg.num_levels)
    counts = []
    acc = 0
    for i in range(cfg.num_levels - 1):
        c = int(round(n_first * factor**i))
        counts.append(c)
        acc += c
    counts.append(max(cfg.max_features - acc, 0))
    return counts


# ----------------------------------------------------------------------------
# FAST corner detection (dense, whole image)
# ----------------------------------------------------------------------------


def _score_from_diff(diff: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9/16 score map from the precomputed circle-difference stack.

    diff: (16, H, W) neighbor-minus-center. Returns (H, W) NMS'd scores,
    0 where not a corner. Shared by both detection thresholds so the
    expensive part (the 16 rolled copies) is computed once."""
    _, H, W = diff.shape
    brighter = diff > threshold
    darker = diff < -threshold

    # Contiguous arc of >= 9: for each start position, AND over a 9-window
    # (wrap-around via doubling).
    def arc_any(mask):
        m2 = jnp.concatenate([mask, mask], axis=0)  # (32, H, W)
        # windowed AND of length 9 starting at each of 16 positions
        acc = jnp.ones((16, H, W), dtype=bool)
        for j in range(9):
            acc = acc & m2[j : j + 16]
        return jnp.any(acc, axis=0)

    is_corner = arc_any(brighter) | arc_any(darker)

    # Score: sum of |diff| over pixels exceeding the threshold (either sign).
    score = jnp.sum(jnp.where(brighter | darker, jnp.abs(diff) - threshold, 0.0), axis=0)
    score = jnp.where(is_corner, score, 0.0)

    # 3x3 non-maximum suppression.
    padded = jnp.pad(score, 1, constant_values=-1.0)
    windows = jnp.stack(
        [
            padded[1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        axis=0,
    )
    is_max = score > jnp.max(windows, axis=0) - 1e-6
    score = jnp.where(is_max, score, 0.0)

    # Kill the border (circle radius + BRIEF patch half-width).
    border = 19
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return jnp.where(in_border, score, 0.0)


def _circle_diff(img: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W) Bresenham-circle neighbor-minus-center difference stack.

    Shifted views: pixel p's circle neighbor k is img rolled by -offset."""
    neigh = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _FAST_OFFSETS],
        axis=0,
    )  # (16, H, W)
    return neigh - img[None]


def fast_scores(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9/16 corner score map. img: (H, W) float32 in [0, 255].

    Returns (H, W) scores; 0 where not a corner. Implemented as 16 rolled
    copies + arc reduction — pure VPU work, no gather.
    """
    return _score_from_diff(_circle_diff(img), threshold)


def fast_scores_dual(
    img: jnp.ndarray, threshold: float, min_threshold: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Score maps at BOTH detection thresholds from ONE difference stack.

    The reference re-runs FAST at minThFAST=7 on cells that found nothing at
    iniThFAST=20 (ORBextractor.cc:1045-1097); here both dense maps come out
    of the shared (16, H, W) diff stack — the rolls are computed once, the
    threshold comparisons are cheap VPU passes — and the per-cell fallback
    happens in `grid_topk_fallback`."""
    diff = _circle_diff(img)
    return _score_from_diff(diff, threshold), _score_from_diff(diff, min_threshold)


def grid_topk(
    score: jnp.ndarray, cell: int, per_cell: int, n_out: int,
    score_lo: jnp.ndarray | None = None,
):
    """Spatially balanced keypoint selection: per-cell top-k then global top-n.

    Returns (xy (n_out, 2) float32 [x, y], scores (n_out,)); empty slots have
    score 0. Replaces DistributeOctTree (ORBextractor.cc:692).

    `score_lo` (optional) is the minThFAST score map: cells where the primary
    map found NO corner fall back to it (the reference's empty-cell
    re-detection at threshold 7, ORBextractor.cc:1045-1097) — low-texture
    regions still contribute keypoints instead of silently starving.
    """
    H, W = score.shape
    Hc, Wc = H // cell, W // cell

    def cells_of(sc):
        c = sc[: Hc * cell, : Wc * cell].reshape(Hc, cell, Wc, cell)
        return c.transpose(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)

    s = cells_of(score)
    if score_lo is not None:
        s_lo = cells_of(score_lo)
        cell_has_hi = jnp.max(s, axis=1, keepdims=True) > 0
        s = jnp.where(cell_has_hi, s, s_lo)
    top_s, top_i = jax.lax.top_k(s, per_cell)  # (cells, per_cell)

    cy = jnp.arange(Hc * Wc) // Wc
    cx = jnp.arange(Hc * Wc) % Wc
    py = top_i // cell + (cy * cell)[:, None]
    px = top_i % cell + (cx * cell)[:, None]

    flat_s = top_s.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    n_cand = flat_s.shape[0]
    k = min(n_out, n_cand)
    best_s, best_i = jax.lax.top_k(flat_s, k)
    xy = jnp.stack([flat_x[best_i], flat_y[best_i]], axis=-1).astype(jnp.float32)
    scores = best_s
    if k < n_out:
        xy = jnp.pad(xy, ((0, n_out - k), (0, 0)))
        scores = jnp.pad(scores, (0, n_out - k))
    return xy, scores


# ----------------------------------------------------------------------------
# Orientation + BRIEF
# ----------------------------------------------------------------------------


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _correlate2d(img: jnp.ndarray, kernels) -> jnp.ndarray:
    """SAME-padded 2-D cross-correlation of one image with C kernels via
    ONE lax.conv call, which XLA hands to its convolution library, instead
    of `jax.scipy.signal.convolve2d`'s generic lowering.

    kernels: (C, kh, kw) -> returns (C, H, W)."""
    x = img[None, None].astype(jnp.float32)  # NCHW
    k = jnp.asarray(kernels, dtype=jnp.float32)[:, None]  # OIHW
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


def gaussian_blur(img: jnp.ndarray, size: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """7x7 sigma-2 blur before BRIEF sampling (cv::GaussianBlur equivalent).

    Separable: two 1-D passes (2·size taps) instead of one size² kernel —
    same zero-padded result, 3.5x fewer MACs."""
    k2 = np.asarray(_gaussian_kernel(size, sigma))
    # Exactly-separable rank-1 factorization: k2 = outer(ky, kx).
    ky = k2[:, size // 2]
    kx = k2[size // 2, :] / max(ky[size // 2], 1e-20)
    x = img[None, None].astype(jnp.float32)
    kxa = jnp.asarray(kx, jnp.float32)[None, None, None, :]
    kya = jnp.asarray(ky, jnp.float32)[None, None, :, None]
    out = jax.lax.conv_general_dilated(
        x, kxa, (1, 1), "SAME", precision=jax.lax.Precision.HIGHEST
    )
    out = jax.lax.conv_general_dilated(
        out, kya, (1, 1), "SAME", precision=jax.lax.Precision.HIGHEST
    )
    return out[0, 0]


@functools.lru_cache(maxsize=None)
def _brief_pattern(seed: int = 0, n_bits: int = 256, patch: int = 31) -> np.ndarray:
    """Seeded Gaussian BRIEF pattern: (n_bits, 4) = (y1, x1, y2, x2).

    BRIEF-paper construction (isotropic Gaussian, sigma = patch/5, clipped),
    fixed at import — the vocabulary and all matching use the same pattern.
    """
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    pts = rng.randn(n_bits, 4) * sigma
    lim = patch // 2 - 1
    return np.clip(np.round(pts), -lim, lim).astype(np.float32)


def _orientation_maps(img: jnp.ndarray, patch: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense m10 / m01 moment maps over a circular patch via ROW PREFIX SUMS.

    A direct 31x31 2-channel correlation is a 961-tap kernel: 961·H·W
    MACs/channel. The circle is a stack of
    horizontal spans, so each output row reduces to span sums of two
    horizontal prefix arrays (img and x·img):

        m01(y,x) = Σ_dy dy · rowsum_{w(dy)}(y+dy, x)
        m10(y,x) = Σ_dy [ rowxsum_{w(dy)} - x · rowsum_{w(dy)} ](y+dy, x)

    with w(dy) = floor(sqrt(half² - dy²)) the span half-width. Span sums
    are two static slices of edge-padded prefix arrays (edge padding of a
    prefix sum IS the zero-padded-image boundary semantics), and vertical
    shifts are static slices of a zero-padded stack — O(patch·H·W) adds,
    no conv, ~20x fewer ops. Exact up to f32 summation order vs the SAME
    zero-padded correlation it replaces."""
    half = patch // 2
    H, W = img.shape
    f = img.astype(jnp.float32)
    x = jnp.arange(W, dtype=jnp.float32)

    # Horizontal prefix arrays with a leading zero: P[:, i] = sum img[:, :i].
    def prefix(a):
        p = jnp.concatenate(
            [jnp.zeros((H, 1), jnp.float32), jnp.cumsum(a, axis=1)], axis=1
        )
        # Edge padding replicates P[:,0]=0 / P[:,W]=rowtotal — exactly the
        # clip-to-border behaviour a zero-padded image induces on spans.
        return jnp.pad(p, ((0, 0), (half + 1, half + 1)), mode="edge")

    S = prefix(f)
    U = prefix(f * x[None, :])
    base = half + 1

    def spans(P, w):
        # sum over [x-w, x+w] = P[x+w+1] - P[x-w] (prefix convention).
        return (
            P[:, base + w + 1 : base + w + 1 + W]
            - P[:, base - w : base - w + W]
        )

    # One (rowsum, rowxsum) pair per DISTINCT span width.
    widths = [
        int(math.floor(math.sqrt(half * half - dy * dy)))
        for dy in range(-half, half + 1)
    ]
    rows = {}
    for w in set(widths):
        rs = spans(S, w)
        rxs = spans(U, w) - x[None, :] * rs
        rows[w] = (rs, rxs)

    # Vertical zero-padded stacks, shifted by static dy slices.
    m10 = jnp.zeros((H, W), jnp.float32)
    m01 = jnp.zeros((H, W), jnp.float32)
    zpad = lambda a: jnp.pad(a, ((half, half), (0, 0)))
    padded = {w: (zpad(rs), zpad(rxs)) for w, (rs, rxs) in rows.items()}
    for i, dy in enumerate(range(-half, half + 1)):
        prs, prxs = padded[widths[i]]
        sl = slice(half + dy, half + dy + H)
        m10 = m10 + prxs[sl]
        if dy:
            m01 = m01 + float(dy) * prs[sl]
    return m10, m01


def compute_descriptors(
    img_blur: jnp.ndarray,
    xy: jnp.ndarray,
    angle: jnp.ndarray,
) -> jnp.ndarray:
    """Steered BRIEF: sample rotated point pairs, pack 256 bits to 8 uint32.

    img_blur: (H, W) blurred level image; xy: (N, 2) level coords; angle (N,).
    """
    H, W = img_blur.shape
    pat = jnp.asarray(_brief_pattern())  # (256, 4) y1 x1 y2 x2
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)

    def rot(y, x):
        # (256,) pattern coords rotated per keypoint -> (N, 256)
        ry = y[None, :] * ca[:, None] + x[None, :] * sa[:, None]
        rx = -y[None, :] * sa[:, None] + x[None, :] * ca[:, None]
        return ry, rx

    y1, x1 = rot(pat[:, 0], pat[:, 1])
    y2, x2 = rot(pat[:, 2], pat[:, 3])

    def sample(yy, xx):
        iy = jnp.clip(jnp.round(xy[:, 1:2] + yy), 0, H - 1).astype(jnp.int32)
        ix = jnp.clip(jnp.round(xy[:, 0:1] + xx), 0, W - 1).astype(jnp.int32)
        return img_blur[iy, ix]  # (N, 256)

    bits = (sample(y1, x1) < sample(y2, x2)).astype(jnp.uint32)  # (N, 256)
    bits = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(bits << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
    return packed  # (N, 8)


# ----------------------------------------------------------------------------
# Full extractor
# ----------------------------------------------------------------------------


def _extract_level(img_l, n_feats, cfg: ORBConfig):
    """Single-level extraction: scores -> grid top-k -> angle -> BRIEF."""
    if cfg.fast_min_threshold and cfg.fast_min_threshold < cfg.fast_threshold:
        score, score_lo = fast_scores_dual(
            img_l, float(cfg.fast_threshold), float(cfg.fast_min_threshold)
        )
    else:
        score, score_lo = fast_scores(img_l, float(cfg.fast_threshold)), None
    xy, s = grid_topk(score, cfg.cell_size, cfg.per_cell, n_feats, score_lo)
    valid = s > 0

    m10, m01 = _orientation_maps(img_l, cfg.patch_size)
    iy = xy[:, 1].astype(jnp.int32)
    ix = xy[:, 0].astype(jnp.int32)
    angle = jnp.arctan2(m01[iy, ix], m10[iy, ix])

    img_b = gaussian_blur(img_l)
    desc = compute_descriptors(img_b, xy, angle)
    return xy, s, angle, valid, desc


def extract(img: jnp.ndarray, cfg: ORBConfig = ORBConfig()) -> Keypoints:
    """Extract ORB keypoints + descriptors from a (H, W) float32 image.

    Each pyramid level is one jit-able computation with static shapes;
    results are concatenated into the fixed `max_features` capacity with
    coordinates mapped back to level 0.
    """
    counts = features_per_level(cfg)
    scales = scale_factors(cfg)
    H, W = img.shape

    all_xy, all_s, all_a, all_v, all_d, all_o = [], [], [], [], [], []
    img_l = img
    for lvl in range(cfg.num_levels):
        if lvl > 0:
            h = int(round(H / scales[lvl]))
            w = int(round(W / scales[lvl]))
            img_l = jax.image.resize(img, (h, w), method="linear")
        xy, s, a, v, d = _extract_level(img_l, counts[lvl], cfg)
        all_xy.append(xy * scales[lvl])
        all_s.append(s)
        all_a.append(a)
        all_v.append(v)
        all_d.append(d)
        all_o.append(jnp.full((counts[lvl],), lvl, dtype=jnp.int32))

    return Keypoints(
        xy=jnp.concatenate(all_xy),
        score=jnp.concatenate(all_s),
        angle=jnp.concatenate(all_a),
        octave=jnp.concatenate(all_o),
        valid=jnp.concatenate(all_v),
        desc=jnp.concatenate(all_d),
    )
