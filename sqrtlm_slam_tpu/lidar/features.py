"""LiDAR feature extraction on the range image — fully tensorized.

JAX redesign of the reference's per-frame LiDAR front-end
(/root/reference/src/data_structure/Frame.cc):
  * `CalculateRingAndTime` — virtual 64-ring assignment by elevation (:473-545)
  * `PointToImage` — range image rows=rings, cols=360/0.2 deg, ground flag
    z < ground_z_bound, keep-nearest per cell (:548-642)
  * `ExtractFeaturePoints` — per-ring curvature over subregions, corners
    gated by BFS range-image segmentation (LeGO-LOAM style, angle > 1 rad),
    sharp/less-sharp caps, flat points by neighborhood plane fit with
    validity |res| < 0.1 and stored normals (:834-1239)
and the same pipeline in the standalone odometry
(/root/reference/src/algorithm/lidarOdom.cc:341-1340).

Design (SURVEY.md §7.0): the range image is already tensor-shaped — ring
binning is a scatter-min, curvature a fixed-window row convolution, the BFS
segmentation becomes iterated min-label propagation (bounded sweeps), and
plane fits are one batched least-squares over gathered windows. Outputs are
fixed-capacity feature sets with validity masks.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LidarConfig(NamedTuple):
    """Knobs mirroring lidarConfig / OdomConfig
    (/root/reference/include/utils/lidarconfig.h:7-63)."""

    num_rings: int = 64
    horizon_res_deg: float = 0.2  # -> 1800 columns
    elev_min_deg: float = -24.8  # HDL-64E vertical FOV
    elev_max_deg: float = 2.0
    ground_z: float = -1.2  # ground flag threshold (z < ground_z)
    min_range: float = 2.5
    max_range: float = 80.0
    num_subregions: int = 8  # curvature subregions per ring (Frame.cc:756)
    curv_window: int = 5  # +/- neighbors for curvature
    corner_thresh: float = 0.1  # curvature above -> corner candidate
    flat_thresh: float = 0.1  # curvature below -> flat candidate
    sharp_per_sub: int = 3  # caps (cfg 3/30, SURVEY §2.4)
    less_sharp_per_sub: int = 30
    flat_per_sub: int = 4
    seg_angle_thresh: float = 1.0  # rad — segmentation gate (Frame.cc:904)
    seg_prop_iters: int = 24  # label-propagation sweeps
    seg_min_size: int = 30
    seg_min_rings: int = 3
    plane_res_thresh: float = 0.1  # |plane residual| validity (Frame.cc:1179)

    @property
    def num_cols(self) -> int:
        return int(round(360.0 / self.horizon_res_deg))


def pad_cloud(points, bucket: int = 16384) -> jnp.ndarray:
    """Pad an (N, D) cloud to the next `bucket`-multiple row count with NaN
    rows, so repeated jit calls share ONE compiled program per size bucket.

    Real scans vary by hundreds of points frame to frame (the reference's
    per-frame `pcl::PointCloud` is naturally variable-length,
    Frame.cc:473-545); under jit a raw variable-length cloud recompiles the
    entire ~20 MB frame graph EVERY frame. NaN rows
    are inert in every consumer: `ring_and_azimuth` keeps only
    `isfinite(rng)` points and `project_cloud_to_depth_image` rejects them
    because NaN fails the z > 0.1 comparison."""
    import numpy as np

    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    cap = max(bucket, -(-n // bucket) * bucket)
    if cap != n:
        pts = np.concatenate(
            [pts, np.full((cap - n, pts.shape[1]), np.nan, np.float32)]
        )
    return jnp.asarray(pts)


class RangeImage(NamedTuple):
    depth: jnp.ndarray  # (R, C) range, 0 where empty
    xyz: jnp.ndarray  # (R, C, 3) point coords (camera/sensor frame)
    valid: jnp.ndarray  # (R, C) bool
    ground: jnp.ndarray  # (R, C) bool


class LidarFeatures(NamedTuple):
    """Fixed-capacity feature sets (sensor-frame points + masks)."""

    sharp: jnp.ndarray  # (Ns, 3) corner points
    sharp_valid: jnp.ndarray
    less_sharp: jnp.ndarray  # (Nls, 3)
    less_sharp_valid: jnp.ndarray
    flat: jnp.ndarray  # (Nf, 3)
    flat_normal: jnp.ndarray  # (Nf, 3) local plane normals
    flat_d: jnp.ndarray  # (Nf,) plane offsets (n.p + d = 0 locally)
    flat_valid: jnp.ndarray
    less_flat: jnp.ndarray  # (Nlf, 3) downsampled smooth points
    less_flat_valid: jnp.ndarray


def ring_and_azimuth(points: jnp.ndarray, cfg: LidarConfig):
    """Virtual ring + column assignment by elevation/azimuth.

    points: (N, 3) in the LiDAR frame (x forward, y left, z up — KITTI).
    Returns (ring (N,), col (N,), range (N,), keep (N,)).
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = jnp.sqrt(x * x + y * y + z * z)
    horiz = jnp.sqrt(x * x + y * y)
    elev = jnp.degrees(jnp.arctan2(z, jnp.maximum(horiz, 1e-6)))
    ring_f = (
        (elev - cfg.elev_min_deg)
        / (cfg.elev_max_deg - cfg.elev_min_deg)
        * (cfg.num_rings - 1)
    )
    ring = jnp.round(ring_f).astype(jnp.int32)
    az = jnp.degrees(jnp.arctan2(y, x))  # (-180, 180]
    col = jnp.floor((az + 180.0) / cfg.horizon_res_deg).astype(jnp.int32)
    col = jnp.clip(col, 0, cfg.num_cols - 1)
    keep = (
        (ring >= 0)
        & (ring < cfg.num_rings)
        & (rng > cfg.min_range)
        & (rng < cfg.max_range)
        & jnp.isfinite(rng)
    )
    return ring, col, rng, keep


def build_range_image(points: jnp.ndarray, cfg: LidarConfig) -> RangeImage:
    """Scatter points into the (R, C) grid keeping the nearest per cell."""
    R, C = cfg.num_rings, cfg.num_cols
    ring, col, rng, keep = ring_and_azimuth(points, cfg)
    flat = ring * C + col
    flat = jnp.where(keep, flat, R * C)  # spill cell for dropped points

    big = jnp.float32(1e9)
    depth = jnp.full(R * C + 1, big).at[flat].min(jnp.where(keep, rng, big))
    depth = depth[: R * C]
    valid = depth < big
    depth = jnp.where(valid, depth, 0.0)

    # Winner-takes-cell point coords: scatter xyz where this point is the min.
    is_winner = keep & (rng <= depth[jnp.clip(flat, 0, R * C - 1)] + 1e-6)
    xyz = (
        jnp.zeros((R * C + 1, 3))
        .at[jnp.where(is_winner, flat, R * C)]
        .set(points)  # later winners overwrite; all within 1e-6 of min range
    )[: R * C]

    ground = valid & (xyz[:, 2] < cfg.ground_z)
    return RangeImage(
        depth=depth.reshape(R, C),
        xyz=xyz.reshape(R, C, 3),
        valid=valid.reshape(R, C),
        ground=ground.reshape(R, C),
    )


def segment_labels(img: RangeImage, cfg: LidarConfig) -> jnp.ndarray:
    """Range-image segmentation via iterated min-label propagation.

    Neighbors (4-connectivity on the ring/col grid, col wraps) are 'connected'
    when the LeGO-LOAM angle criterion exceeds `seg_angle_thresh`:
        beta = atan2(d2 sin(alpha), d1 - d2 cos(alpha)) > thresh
    with d1 >= d2 and alpha the angular step. Returns (R, C) int32 labels
    (-1 for invalid cells); replaces the sequential BFS (Frame.cc:904-1010).
    """
    R, C = img.depth.shape
    alpha_h = math.radians(cfg.horizon_res_deg)
    alpha_v = math.radians((cfg.elev_max_deg - cfg.elev_min_deg) / (cfg.num_rings - 1))

    def connected(d, shift, axis, alpha):
        dn = jnp.roll(d, shift, axis=axis)
        vn = jnp.roll(img.valid, shift, axis=axis)
        d1 = jnp.maximum(d, dn)
        d2 = jnp.minimum(d, dn)
        beta = jnp.arctan2(
            d2 * math.sin(alpha), d1 - d2 * math.cos(alpha)
        )
        ok = img.valid & vn & (beta > cfg.seg_angle_thresh)
        if axis == 0:  # ring axis doesn't wrap
            if shift > 0:
                ok = ok.at[:shift].set(False)
            else:
                ok = ok.at[shift:].set(False)
        return ok

    conn_up = connected(img.depth, 1, 0, alpha_v)
    conn_dn = connected(img.depth, -1, 0, alpha_v)
    conn_lf = connected(img.depth, 1, 1, alpha_h)
    conn_rt = connected(img.depth, -1, 1, alpha_h)

    labels = jnp.arange(R * C, dtype=jnp.int32).reshape(R, C)
    labels = jnp.where(img.valid, labels, jnp.int32(R * C))

    def body(_, lab):
        up = jnp.where(conn_up, jnp.roll(lab, 1, 0), lab)
        dn = jnp.where(conn_dn, jnp.roll(lab, -1, 0), lab)
        lf = jnp.where(conn_lf, jnp.roll(lab, 1, 1), lab)
        rt = jnp.where(conn_rt, jnp.roll(lab, -1, 1), lab)
        return jnp.minimum(jnp.minimum(jnp.minimum(lab, up), jnp.minimum(dn, lf)), rt)

    labels = jax.lax.fori_loop(0, cfg.seg_prop_iters, body, labels)
    return jnp.where(img.valid, labels, -1)


def segment_valid_mask(labels: jnp.ndarray, cfg: LidarConfig) -> jnp.ndarray:
    """Segment validity: size >= seg_min_size OR spans >= seg_min_rings rings
    (LeGO-LOAM rule; reference 'segment valid iff >= 3 rings')."""
    R, C = labels.shape
    flat = jnp.where(labels >= 0, labels, R * C).reshape(-1)
    sizes = jax.ops.segment_sum(jnp.ones_like(flat), flat, num_segments=R * C + 1)

    ring_idx = jnp.broadcast_to(jnp.arange(R)[:, None], (R, C)).reshape(-1)
    rmin = jnp.full(R * C + 1, R, jnp.int32).at[flat].min(ring_idx)
    rmax = jnp.zeros(R * C + 1, jnp.int32).at[flat].max(ring_idx)
    span = rmax - rmin + 1

    ok = (sizes >= cfg.seg_min_size) | (span >= cfg.seg_min_rings)
    return jnp.where(labels >= 0, ok[jnp.clip(labels, 0, R * C)], False)


def curvature(img: RangeImage, cfg: LidarConfig) -> jnp.ndarray:
    """LOAM curvature per cell: || sum_{j in +/-W} (d_j - d_0) || normalized.

    Row (same-ring) neighbors only, matching the classic formulation; invalid
    neighbors break the window (cell marked non-smooth via large value there
    handled by the picker masks).
    """
    d = img.depth
    W = cfg.curv_window
    acc = jnp.zeros_like(d)
    cnt = jnp.zeros_like(d)
    for j in range(-W, W + 1):
        if j == 0:
            continue
        dj = jnp.roll(d, j, axis=1)
        vj = jnp.roll(img.valid, j, axis=1)
        acc = acc + jnp.where(vj, dj - d, 0.0)
        cnt = cnt + vj.astype(d.dtype)
    c = (acc * acc) / jnp.maximum(d * d, 1e-6)
    full_window = cnt >= 2 * W  # require complete neighborhoods
    return jnp.where(img.valid & full_window, c, -1.0)


def _neighborhood_plane_fit(img: RangeImage, cfg: LidarConfig):
    """Batched plane fit over a 3-ring x 7-col window around every cell.

    Solves min ||A n - 1|| per cell (LOAM norm trick), giving normal n/|n|
    and offset d = -1/|n|; validity requires all residuals < thresh
    (Frame.cc:1179-1224 colPivHouseholderQr equivalent).
    """
    R, C = img.depth.shape
    offs = [(dr, dc) for dr in (-1, 0, 1) for dc in (-3, -2, -1, 0, 1, 2, 3)]
    pts = jnp.stack(
        [jnp.roll(img.xyz, (dr, dc), axis=(0, 1)) for dr, dc in offs], axis=2
    )  # (R, C, K, 3)
    val = jnp.stack(
        [jnp.roll(img.valid, (dr, dc), axis=(0, 1)) for dr, dc in offs], axis=2
    )
    w = val.astype(jnp.float32)

    # Weighted normal equations for A n = 1.
    AtA = jnp.einsum("rcki,rck,rckj->rcij", pts, w, pts) + 1e-6 * jnp.eye(3)
    At1 = jnp.einsum("rcki,rck->rci", pts, w)
    n = jnp.linalg.solve(AtA, At1[..., None])[..., 0]  # (R, C, 3)
    norm = jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    normal = n / norm
    d_off = -1.0 / norm[..., 0]

    # Residuals of all window points against the fitted plane.
    res = jnp.abs(jnp.einsum("rcki,rci->rck", pts, normal) + d_off[..., None])
    good = jnp.all(jnp.where(val, res < cfg.plane_res_thresh, True), axis=-1)
    enough = jnp.sum(w, axis=-1) >= 5
    return normal, d_off, good & enough & img.valid


def _subregion_topk(values, mask, cfg: LidarConfig, k, largest=True):
    """Per (ring, subregion) top-k by value -> flat cell indices + validity."""
    R, C = values.shape
    S = cfg.num_subregions
    w = C // S
    v = values[:, : S * w].reshape(R, S, w)
    m = mask[:, : S * w].reshape(R, S, w)
    v = jnp.where(m, v, -jnp.inf if largest else jnp.inf)
    vv = v if largest else -v
    top_v, top_i = jax.lax.top_k(vv, k)  # (R, S, k)
    ok = jnp.isfinite(top_v)
    cols = top_i + (jnp.arange(S) * w)[None, :, None]
    rows = jnp.broadcast_to(jnp.arange(R)[:, None, None], cols.shape)
    flat = (rows * C + cols).reshape(-1)
    return flat, ok.reshape(-1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_features_jit(
    points: jnp.ndarray, cfg: LidarConfig = LidarConfig()
) -> LidarFeatures:
    """Jitted standalone entry (pair with `pad_cloud` so scan-size
    variation reuses one compiled program). Inside `build_frame` the tracer
    already covers extraction; run eagerly, the standalone LiDAR odometry
    path would dispatch hundreds of separate ops per scan."""
    return extract_features(points, cfg)


def extract_features(points: jnp.ndarray, cfg: LidarConfig = LidarConfig()) -> LidarFeatures:
    """Full feature extraction: range image -> segmentation -> curvature ->
    corner/flat picks -> plane normals. Fixed capacities from cfg caps."""
    img = build_range_image(points, cfg)
    labels = segment_labels(img, cfg)
    seg_ok = segment_valid_mask(labels, cfg)
    c = curvature(img, cfg)
    normal, d_off, plane_ok = _neighborhood_plane_fit(img, cfg)

    R, C = img.depth.shape
    xyz_flat = img.xyz.reshape(-1, 3)

    corner_mask = img.valid & seg_ok & (~img.ground) & (c > cfg.corner_thresh)
    flat_mask = img.valid & (c >= 0) & (c < cfg.flat_thresh)

    sharp_idx, sharp_ok = _subregion_topk(c, corner_mask, cfg, cfg.sharp_per_sub)
    ls_idx, ls_ok = _subregion_topk(c, corner_mask, cfg, cfg.less_sharp_per_sub)
    flat_idx, flat_ok = _subregion_topk(c, flat_mask & plane_ok, cfg, cfg.flat_per_sub, largest=False)

    # Less-flat: all smooth cells, column-downsampled by 4 (the reference
    # voxel-filters these at 0.4 m; a stride is the grid-native equivalent).
    lf_mask = flat_mask & (jnp.arange(C)[None, :] % 4 == 0)
    lf_idx, lf_ok = _subregion_topk(-c, lf_mask, cfg, cfg.less_sharp_per_sub)

    return LidarFeatures(
        sharp=xyz_flat[sharp_idx],
        sharp_valid=sharp_ok,
        less_sharp=xyz_flat[ls_idx],
        less_sharp_valid=ls_ok,
        flat=xyz_flat[flat_idx],
        flat_normal=normal.reshape(-1, 3)[flat_idx],
        flat_d=d_off.reshape(-1)[flat_idx],
        flat_valid=flat_ok,
        less_flat=xyz_flat[lf_idx],
        less_flat_valid=lf_ok,
    )


def transform_features(feat: LidarFeatures, R: jnp.ndarray, t: jnp.ndarray) -> LidarFeatures:
    """Rigidly transform feature clouds (and plane normals/offsets) by
    p' = R p + t — the reference's lidar->camera extrinsic application after
    extraction (Frame.cc:461-466). Plane n.p + d = 0 maps to
    n' = R n, d' = d - n'.t."""

    def pts(p):
        return p @ R.T + t

    n_new = feat.flat_normal @ R.T
    d_new = feat.flat_d - jnp.sum(n_new * t, axis=-1)
    return feat._replace(
        sharp=pts(feat.sharp),
        less_sharp=pts(feat.less_sharp),
        flat=pts(feat.flat),
        flat_normal=n_new,
        flat_d=d_new,
        less_flat=pts(feat.less_flat),
    )
