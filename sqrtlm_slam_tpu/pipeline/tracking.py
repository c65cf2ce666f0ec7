"""Tracking: per-frame state machine driving jitted matching + pose stages.

JAX redesign of `Tracking` (/root/reference/src/frontend/Tracking.cc):
  * state machine NOT_INITIALIZED / OK / LOST (Tracking.h:141-147)
  * `FusionInitialization` (:930-1012) — first frame with enough
    depth-carrying keypoints becomes the map seed; every depth>0 keypoint
    becomes a landmark.
  * `TrackWithMotionModel` (:1503-1584) — constant-velocity prediction,
    projection search radius 15 (fallback widened x2), pose-only LM.
  * `TrackLocalMap` (:1602-1668) — covisibility local map projection search,
    second pose optimization, inlier gate >= 30 (>= 50 after reloc).
  * `NeedNewKeyFrame`/`CreateNewKeyFrame` (:1683-1953) with the close-point
    rule (tracked close < 125 && non-tracked close > 70 -> need KF :1747).
  * Relocalization (:2334-2554) — `Tracker._relocalize` below: BoW
    candidate search, PnP RANSAC bank, pose optimization.

The device side is two fused stages (match+optimize each); the host side is
only the decision logic. Local-map gathering is a numpy scatter from the
SoA store into fixed-capacity device buffers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithm import pnp
from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3
from ..lidar import odometry as lidar_odometry
from ..lidar import voxel_map
from ..mapstore import MapStore
from ..optim import pose_opt
from . import initializer
from .frame import Frame


class TrackingConfig(NamedTuple):
    match_radius_motion: float = 15.0  # SearchByProjection r (Tracking.cc:1503)
    match_radius_local: float = 7.0
    min_matches_motion: int = 20
    min_inliers_track: int = 10
    min_inliers_local: int = 30  # TrackLocalMap gate (Tracking.cc:1648)
    local_map_capacity: int = 2048  # projected-landmark buffer
    local_kf_cap: int = 20  # covisible KFs forming the local map (cap 80 ref)
    init_min_depth_kp: int = 200  # FusionInitialization needs >500 kp (ref)
    kf_min_interval: int = 0
    kf_max_interval: int = 10
    kf_tracked_ratio: float = 0.75  # insert KF if inliers < ratio * ref
    close_depth: float = 40.0  # ThDepth-scaled close/far split (cfg ThDepth 125 -> ~40 m)
    kf_close_tracked: int = 100  # close-point rule (Tracking.cc:1747)
    kf_close_untracked: int = 70
    max_landmarks_per_kf: int = 300
    # LiDAR tight coupling (g2oOptimizer.cc:560-641).
    lidar_min_map_pts: int = 100  # only couple if the local map is populated
    lidar_match_dist: float = 0.45  # NN gate, sqrt(0.2 m^2) reference radius
    lidar_map_kfs: int = 10  # KFs aggregated into the lidar local map
    # Pyramid shape for scale-aware projection search (ORBmatcher.cc:88-105);
    # MUST match the extractor's ORBConfig (SlamSystem syncs them).
    num_levels: int = 8
    scale_factor: float = 1.2
    # Deferred-fetch steady-state tracking (see Tracker.track): frame t's
    # results are fetched only after frame t+1's dispatch, overlapping the
    # host<->device sync with device work. Off by default: the sync driver is deterministic
    # (tests, evaluation) and has no one-frame decision latency.
    pipelined: bool = False


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class LocalMapBuffer(NamedTuple):
    """Fixed-capacity landmark buffer gathered from the store."""

    ids: jnp.ndarray  # (M,) landmark ids (host bookkeeping)
    pos: jnp.ndarray  # (M, 3)
    desc: jnp.ndarray  # (M, 8) uint32
    valid: jnp.ndarray  # (M,)
    max_dist: jnp.ndarray  # (M,) scale-invariance ceiling (inf = not set)


def _scale_aware_window(
    x_c, uv_pred, lm: LocalMapBuffer, frame: Frame, radius_px,
    num_levels: int = 8, scale_factor: float = 1.2,
):
    """Projection window with the reference's scale-aware semantics
    (ORBmatcher.cc:88-105): per-landmark radius = r * scaleFactor^predicted
    level, keypoint octave gated to [pred-1, pred+1]. Landmarks whose scale
    range is not yet set (max_dist inf) keep the base radius and no gate.
    num_levels/scale_factor MUST match the extractor's pyramid — a predicted
    level the extractor cannot produce would gate out every candidate."""
    dist = jnp.linalg.norm(x_c, axis=-1)
    pred = matching.predict_octave(
        dist, lm.max_dist, scale_factor=scale_factor, num_levels=num_levels
    )
    gate = jnp.isfinite(lm.max_dist)
    radius = radius_px * jnp.power(scale_factor, pred.astype(jnp.float32))
    # slack 2 (reference uses [pred-1, pred]): our octave estimate is
    # noisier — the grid detector re-fires the same corner on several
    # levels and keeps per-level budgets, so the DETECTED level wobbles
    # ±1 around the physical one; a 1-level gate costs ~25% of true
    # matches on the ring domain where margins decide tracking survival.
    return matching.projection_window_mask(
        uv_pred, frame.kp.xy, radius,
        octave_pred=pred, octave_kp=frame.kp.octave, octave_gate=gate,
        level_slack=2,
    )


@functools.partial(
    jax.jit, static_argnames=("cam", "radius_px", "num_levels", "scale_factor")
)
def match_and_optimize(
    pose_guess: se3.SE3,
    lm: LocalMapBuffer,
    frame: Frame,
    cam: Camera,
    radius_px: float,
    num_levels: int = 8,
    scale_factor: float = 1.2,
):
    """One tracking stage: project landmarks, window-match, pose-only LM.

    ``radius_px <= 0`` disables the projection window — the
    TrackReferenceKeyFrame fallback (BoW/descriptor-only matching with the
    stricter 0.75 ratio, Tracking.cc:1317-1377) used when the motion-model
    prediction is unreliable (first frame after init, post-loss).

    Returns (pose, lm_match_idx (M,), lm_match_valid (M,), num_inliers).
    """
    # Project landmarks with the pose guess.
    x_c = se3.act(pose_guess, lm.pos)
    uv_pred = cam.project(x_c)
    in_front = x_c[..., 2] > 0.5
    proj_ok = lm.valid & in_front

    if radius_px > 0:
        window = _scale_aware_window(
            x_c, uv_pred, lm, frame, radius_px, num_levels, scale_factor
        )
        # Reference TrackLocalMap matching (ORBmatcher.cc:196-247): ratio
        # 0.8 applied only when best/second share the octave, one landmark
        # per keypoint by best-claim — NOT global mutual best (which costs
        # ~30% of true matches once the map holds near-duplicate points).
        ratio, mutual, octave_t = 0.8, "claim", frame.kp.octave
    else:
        window = None
        proj_ok = lm.valid  # no frustum gate either — pose guess is distrusted
        ratio, mutual, octave_t = 0.75, True, None
    res = matching.match_descriptors(
        lm.desc,
        frame.kp.desc,
        proj_ok,
        frame.kp.valid,
        window_mask=window,
        max_dist=matching.TH_HIGH,
        ratio=ratio,
        mutual=mutual,
        octave_t=octave_t,
    )

    obs = pose_opt.VisualObs(
        points_w=lm.pos,
        uvr=frame.uvr[res.idx],
        inv_sigma2=frame.inv_sigma2[res.idx],
        valid=res.valid,
    )
    result = pose_opt.optimize_pose(pose_guess, obs, cam)
    return result.pose, res.idx, res.valid & result.inlier_mask, result.num_inliers


@functools.partial(
    jax.jit,
    static_argnames=("cam", "radius_px", "match_dist", "num_levels", "scale_factor"),
)
def match_and_optimize_fused(
    pose_guess: se3.SE3,
    lm: LocalMapBuffer,
    frame: Frame,
    cam: Camera,
    radius_px: float,
    lidar_map: lidar_odometry.LocalMap,
    match_dist: float,
    num_levels: int = 8,
    scale_factor: float = 1.2,
):
    """Tracking stage with LiDAR tight coupling: visual window matching +
    voxel-hash NN association of the frame's corner/flat features against
    the keyframe-window lidar local map, then ONE fused pose optimization
    over reprojection + point-to-point + point-to-plane residuals
    (g2oOptimizer.cc:560-641: EdgeLidarCornerPoint info=30, EdgeLidarFlatPoint
    info=50)."""
    x_c = se3.act(pose_guess, lm.pos)
    uv_pred = cam.project(x_c)
    proj_ok = lm.valid & (x_c[..., 2] > 0.5)
    window = _scale_aware_window(
        x_c, uv_pred, lm, frame, radius_px, num_levels, scale_factor
    )
    res = matching.match_descriptors(
        lm.desc, frame.kp.desc, proj_ok, frame.kp.valid,
        window_mask=window, max_dist=matching.TH_HIGH, ratio=0.8,
        mutual="claim", octave_t=frame.kp.octave,
    )
    obs = pose_opt.VisualObs(
        points_w=lm.pos,
        uvr=frame.uvr[res.idx],
        inv_sigma2=frame.inv_sigma2[res.idx],
        valid=res.valid,
    )

    lf = frame.lidar
    # Associate at the pose guess (the reference associates once per
    # optimization stage via kd-tree NN, then optimizes 10 iterations).
    c_pts, c_val = lf.sharp, lf.sharp_valid
    f_pts, f_val = lf.flat, lf.flat_valid
    c_w = se3.act(se3.inverse(pose_guess), c_pts)
    f_w = se3.act(se3.inverse(pose_guess), f_pts)
    ci, cd2, cok = voxel_map.knn(lidar_map.corner, c_w, k=1, max_dist=match_dist)
    fi, fd2, fok = voxel_map.knn(lidar_map.flat, f_w, k=1, max_dist=match_dist)
    c_target = lidar_map.corner.points[ci[:, 0]]
    f_target = lidar_map.flat.points[fi[:, 0]]
    f_normal = lidar_map.flat.payload[fi[:, 0]]
    f_d = -jnp.sum(f_normal * f_target, axis=-1)

    lobs = pose_opt.LidarObs(
        flat_pts=f_pts,
        plane_n=f_normal,
        plane_d=f_d,
        flat_valid=fok[:, 0] & f_val,
        corner_pts=c_pts,
        corner_target=c_target,
        corner_valid=cok[:, 0] & c_val,
    )
    n_lidar = jnp.sum(lobs.flat_valid) + jnp.sum(lobs.corner_valid)
    result = pose_opt.optimize_pose(pose_guess, obs, cam, lidar_obs=lobs)
    return (
        result.pose, res.idx, res.valid & result.inlier_mask,
        result.num_inliers, n_lidar,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "r_motion", "r_local", "min_inliers", "close_depth", "match_dist",
        "num_levels", "scale_factor",
    ),
)
def track_frame_step(
    prev_pose: se3.SE3,
    velocity: jnp.ndarray,
    lm: LocalMapBuffer,
    frame: Frame,
    cam: Camera,
    r_motion: float,
    r_local: float,
    min_inliers: int,
    close_depth: float,
    lidar_map=None,
    match_dist: float = 0.45,
    num_levels: int = 8,
    scale_factor: float = 1.2,
):
    """The WHOLE per-frame device computation in one dispatch.

    Motion-model prediction (constant-velocity retract), stage A matching +
    pose LM at `r_motion` with the reference's widened-window retry as a
    lax.cond (Tracking.cc:1503-1584), stage B local-map tracking at
    `r_local` (LiDAR-tightly-coupled when a lidar local map is given), the
    next constant-velocity estimate, and the keyframe-policy close-point
    counters (Tracking.cc:1730-1754) — so the host state machine needs
    exactly ONE dispatch and ONE two-leaf fetch per frame: every extra
    dispatch or fetch is a host<->device synchronisation.

    Returns (pose, new_velocity, packed_i (3, M) int32 [match idx, match
    valid, frustum-visible], packed_f (17,) f32 [R.ravel(9), t(3),
    n_inliers, nA, n_lidar, tracked_close, total_close]). pose/new_velocity stay device-resident
    for the next frame; only the packed pair needs fetching.
    """
    guess = se3.retract(prev_pose, velocity)
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    outA = match_and_optimize(guess, lm, frame, cam, r_motion, **pyr)

    def widen(_):
        return match_and_optimize(guess, lm, frame, cam, r_motion * 2, **pyr)

    def keep(_):
        return outA

    poseA, _, _, nA = jax.lax.cond(outA[3] < min_inliers, widen, keep, None)

    if lidar_map is not None:
        poseB, _, _, n_inlB, _ = match_and_optimize_fused(
            poseA, lm, frame, cam, r_local, lidar_map, match_dist, **pyr
        )
        # Stage C: one re-match + re-opt from the IMPROVED pose. When the
        # motion prediction was marginal (corner entry/apex), stage B's
        # windows were centred tens of px off and missed most true
        # candidates; re-centring on poseB recovers them. This is
        # the batched form of the reference's iterate-until-stable
        # association loops (it re-associates per optimization stage in the
        # LiDAR path, lidarOdom.cc:341-1340).
        pose, m_idx, m_valid, n_inl, n_lidar = match_and_optimize_fused(
            poseB, lm, frame, cam, r_local, lidar_map, match_dist, **pyr
        )
    else:
        poseB, _, _, n_inlB = match_and_optimize(
            poseA, lm, frame, cam, r_local, **pyr
        )
        pose, m_idx, m_valid, n_inl = match_and_optimize(
            poseB, lm, frame, cam, r_local, **pyr
        )
        n_lidar = jnp.asarray(0, jnp.int32)

    new_velocity = se3.local_delta(pose, prev_pose)

    # Close-point keyframe-rule counters (Tracking.cc:1730-1754): keypoints
    # with associated depth in (0, close_depth), split tracked / untracked.
    close = (frame.depth > 0) & (frame.depth < close_depth)
    # Count per KEYPOINT, not per match: two landmarks matched to the same
    # keypoint must contribute one close point (scatter-max de-duplicates;
    # invalid matches contribute False regardless of where m_idx points).
    kp_tracked = jnp.zeros(close.shape, bool).at[m_idx].max(m_valid)
    tracked_close = jnp.sum(kp_tracked & close)
    total_close = jnp.sum(close)

    # Per-landmark visibility under the FINAL pose — feeds the host's
    # IncreaseVisible/IncreaseFound counters (Tracking.cc:1588-1600), whose
    # found/visible ratio is MapPointCulling's duplicate-killer
    # (LocalMapping.cc:270). Image bounds approximated by 2*cx x 2*cy (the
    # principal point is central for KITTI; the <=1% border band only
    # biases the counter, never geometry).
    x_vis = se3.act(pose, lm.pos)
    uv_vis = cam.project(x_vis)
    d_vis = jnp.linalg.norm(x_vis, axis=-1)
    visible = (
        lm.valid
        & (x_vis[..., 2] > 0.3)
        & (uv_vis[:, 0] >= 0.0) & (uv_vis[:, 0] < 2.0 * cam.cx)
        & (uv_vis[:, 1] >= 0.0) & (uv_vis[:, 1] < 2.0 * cam.cy)
        & jnp.where(
            jnp.isfinite(lm.max_dist), d_vis < 1.25 * lm.max_dist, True
        )
    )

    packed_i = jnp.stack(
        [m_idx.astype(jnp.int32), m_valid.astype(jnp.int32),
         visible.astype(jnp.int32)]
    )
    packed_f = jnp.concatenate(
        [
            pose.R.reshape(-1),
            pose.t,
            jnp.stack([n_inl, nA, n_lidar, tracked_close, total_close]).astype(
                jnp.float32
            ),
        ]
    )
    return pose, new_velocity, packed_i, packed_f


@functools.partial(jax.jit, static_argnames=("cam",))
def recover_pose_no_prior(
    key: jnp.ndarray, lm: LocalMapBuffer, frame: Frame, cam: Camera
):
    """Pose recovery without a motion prior: descriptor-only matching + 3D-3D
    RANSAC on depth-carrying keypoints.

    This is the TrackReferenceKeyFrame / Relocalization geometry
    (Tracking.cc:1317-1377, 2334-2554 — BoW match then EPnP RANSAC): the LM
    optimizer cannot pull a pose in from 50+ px initial error, so a robust
    closed-form estimate seeds it instead. Returns (pose, num_inliers).
    """
    res = matching.match_descriptors(
        lm.desc, frame.kp.desc, lm.valid, frame.kp.valid,
        max_dist=matching.TH_HIGH, ratio=0.9, mutual=True,
    )
    depth = frame.depth[res.idx]
    uv = frame.kp.xy[res.idx]
    is2 = frame.inv_sigma2[res.idx]
    # Depth-carrying matches -> 3D-3D Horn RANSAC (stronger); depth-less
    # (mono) -> 2D-3D DLT resection. Run both banks, keep the better.
    k1, k2 = jax.random.split(key)
    pts_c = cam.backproject(uv, depth)
    ok3d = res.valid & (depth > 0)
    out3 = pnp.ransac_pose_3d3d(k1, lm.pos, pts_c, uv, ok3d, is2, cam)
    out2 = pnp.ransac_pnp_2d3d(k2, lm.pos, uv, res.valid, is2, cam)
    use3 = out3.num_inliers >= out2.num_inliers
    pose = se3.SE3(
        jnp.where(use3, out3.pose.R, out2.pose.R),
        jnp.where(use3, out3.pose.t, out2.pose.t),
    )
    return pose, jnp.maximum(out3.num_inliers, out2.num_inliers)


@jax.jit
def _pack_kf_fields(pose: se3.SE3, frame: Frame):
    """Pack the keyframe-record fields into 3 fetchable leaves: (N,7) f32
    [xy(2), uvr(3), depth, angle], (N,10) u32 [desc(8), octave, valid],
    (12,) f32 [R.ravel, t]."""
    kp = frame.kp
    pf = jnp.concatenate(
        [kp.xy, frame.uvr, frame.depth[:, None], kp.angle[:, None]], axis=-1
    )
    pi = jnp.concatenate(
        [
            kp.desc,
            kp.octave[:, None].astype(jnp.uint32),
            kp.valid[:, None].astype(jnp.uint32),
        ],
        axis=-1,
    )
    ps = jnp.concatenate([pose.R.reshape(-1), pose.t])
    return pf, pi, ps


class Tracker:
    """Host-side tracking state machine (one instance per SLAM system)."""

    def __init__(self, store: MapStore, cam: Camera, cfg: TrackingConfig = TrackingConfig()):
        self.store = store
        self.cam = cam
        self.cfg = cfg
        self.state = TrackState.NOT_INITIALIZED
        self.pose = se3.identity()  # T_cw of the last tracked frame
        self.velocity = jnp.zeros(6)
        # False right after (re)localization: no motion model exists yet, so
        # the next frame searches with a widened stage-A window (the
        # reference's TrackReferenceKeyFrame-until-mVelocity-exists phase,
        # Tracking.cc:1100-1114). Set True once a frame tracks normally.
        self.velocity_valid = False
        self.ref_kf: int = -1
        self.frames_since_kf = 0
        self.frame_idx = -1
        self.last_inliers = 0
        # Per-frame relative poses for trajectory recovery
        # (mlRelativeFramePoses, Tracking.cc:566-587): (frame_id, ref_kf, T_rel).
        self.trajectory: list = []
        self.last_lm_ids: Optional[np.ndarray] = None  # landmarks seen last frame
        self.new_kf_callback = None  # set by the system (local mapping hook)
        self.vocab_hook = None  # set by the system: (desc, valid) -> (words, bow)
        self._key = jax.random.PRNGKey(42)  # RANSAC seeds (fallback/reloc)
        self.reloc_db = None  # KeyFrameDatabase set by the system
        self.frames_lost = 0
        self.localization_only = False  # ActivateLocalizationMode (System.cc:304)
        # Coarse map lock (Map::mMutexMapUpdate equivalent) — a real RLock
        # when the system runs async mapping, a no-op context otherwise.
        import contextlib
        self.map_lock = contextlib.nullcontext()
        self._init_ref: Optional[Frame] = None  # mono init reference frame
        self.last_lidar_matches = 0  # tight-coupling association count
        # Device-resident gather caches keyed by (ref_kf, store.version):
        # between keyframes the local map does not change, so the host->device
        # buffer transfers (4+ arrays/frame) are skipped entirely.
        self._lm_cache_key = None
        self._lm_cache: Optional[LocalMapBuffer] = None
        self._lidar_cache_key = None
        self._lidar_cache = None
        # Deferred frame (pipelined mode): results of the newest dispatched
        # step, fetched at the next track()/flush().
        self._pending = None

    # ------------------------------------------------------------------

    def _gather_local_map(self) -> tuple:
        """Local map = landmarks of ref KF + its best covisible KFs
        (UpdateLocalKeyFrames/Points, Tracking.cc:2114-2260). Cached on
        device across frames until the map mutates (store.version)."""
        key = (self.ref_kf, self.store.version)
        if self._lm_cache_key == key:
            return self._lm_cache
        cap = self.cfg.local_map_capacity
        with self.map_lock:
            kfs = [self.ref_kf] + list(
                self.store.best_covisible(self.ref_kf, self.cfg.local_kf_cap)
            )
            lm_ids = np.unique(self.store.kf_obs_lm[kfs])
            lm_ids = lm_ids[(lm_ids >= 0)]
            lm_ids = lm_ids[self.store.lm_valid[lm_ids]]
            if len(lm_ids) > cap:
                # Over capacity: keep the NEWEST landmark ids — they were
                # triangulated from recent keyframes, so they are the ones
                # most likely in the current frustum with fresh descriptors
                # (truncating to the oldest silently serves a stale map).
                lm_ids = lm_ids[-cap:]
            buf = self._buffer_from_ids(lm_ids)
        self._lm_cache_key = key
        self._lm_cache = buf
        return buf

    def _buffer_from_ids(self, lm_ids: np.ndarray) -> LocalMapBuffer:
        cap = self.cfg.local_map_capacity
        n = len(lm_ids)
        ids = np.full(cap, -1, np.int32)
        pos = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        valid = np.zeros(cap, bool)
        max_dist = np.full(cap, np.inf, np.float32)
        ids[:n] = lm_ids
        pos[:n] = self.store.lm_pos[lm_ids]
        desc[:n] = self.store.lm_desc[lm_ids]
        valid[:n] = True
        max_dist[:n] = self.store.lm_max_dist[lm_ids]
        return LocalMapBuffer(
            ids=jnp.asarray(ids),
            pos=jnp.asarray(pos),
            desc=jnp.asarray(desc),
            valid=jnp.asarray(valid),
            max_dist=jnp.asarray(max_dist),
        )

    # ------------------------------------------------------------------

    def _gather_lidar_local_map(self):
        """Aggregate the local KFs' stored corner/flat clouds into world-frame
        voxel-hash maps (UpdateLidarLocalPoints, Tracking.cc:2263-2320:
        aggregate per-KF clouds of the visual local KFs, voxel-filter,
        rebuild the NN structure)."""
        key = (self.ref_kf, self.store.version)
        if self._lidar_cache_key == key:
            return self._lidar_cache
        store, cfg = self.store, self.cfg
        with self.map_lock:
            out = self._gather_lidar_local_map_locked(store, cfg)
        self._lidar_cache_key = key
        self._lidar_cache = out
        return out

    def _gather_lidar_local_map_locked(self, store, cfg):
        kfs = [self.ref_kf] + [
            int(x) for x in store.best_covisible(self.ref_kf, cfg.lidar_map_kfs)
        ]
        kfs = [k for k in kfs if k >= 0 and store.kf_corner_valid[k].any()]
        if not kfs:
            return None
        # Fixed-capacity aggregation (static shapes -> no jit retraces as the
        # keyframe window grows).
        n_slots = cfg.lidar_map_kfs + 1
        Nc, Nf = store.corner_per_kf, store.flat_per_kf
        corner = np.zeros((n_slots * Nc, 3), np.float32)
        corner_v = np.zeros(n_slots * Nc, bool)
        flat = np.zeros((n_slots * Nf, 3), np.float32)
        flat_n = np.zeros((n_slots * Nf, 3), np.float32)
        flat_v = np.zeros(n_slots * Nf, bool)
        for i, k in enumerate(kfs[:n_slots]):
            R, t = store.kf_R[k], store.kf_t[k]
            corner[i * Nc : (i + 1) * Nc] = (store.kf_corner[k] - t) @ R  # R^T(p-t)
            corner_v[i * Nc : (i + 1) * Nc] = store.kf_corner_valid[k]
            flat[i * Nf : (i + 1) * Nf] = (store.kf_flat[k] - t) @ R
            flat_n[i * Nf : (i + 1) * Nf] = store.kf_flat_normal[k] @ R
            flat_v[i * Nf : (i + 1) * Nf] = store.kf_flat_valid[k]
        corner = jnp.asarray(corner)
        corner_v = jnp.asarray(corner_v)
        flat = jnp.asarray(flat)
        flat_n = jnp.asarray(flat_n)
        flat_v = jnp.asarray(flat_v)
        n_pts = int(corner_v.sum()) + int(flat_v.sum())
        if n_pts < cfg.lidar_min_map_pts:
            return None
        return lidar_odometry.build_local_map(
            corner, corner_v, flat, flat_v, flat_n,
            lidar_odometry.OdomConfig(),
        )

    def _store_kf_lidar(self, kf: int, frame: Frame):
        """Downsample the frame's features into the KF cloud slots."""
        lf = frame.lidar
        store = self.store
        c_ds, c_ok = voxel_map.voxel_downsample(
            lf.less_sharp, lf.less_sharp_valid, 0.4, store.corner_per_kf
        )
        # Flat points keep their fitted normals (payload-aware downsample).
        stacked = jnp.concatenate([lf.flat, lf.flat_normal], axis=-1)
        f6, f_ok = lidar_odometry._voxel_downsample_payload(
            stacked, lf.flat_valid, 0.4, store.flat_per_kf
        )
        store.set_kf_lidar(
            kf,
            np.asarray(c_ds), np.asarray(c_ok),
            np.asarray(f6[:, :3]), np.asarray(f6[:, 3:]), np.asarray(f_ok),
        )

    def _initialize(self, frame: Frame) -> bool:
        """FusionInitialization (depth path) or monocular two-view init."""
        depth_ok = np.asarray(frame.depth > 0)
        kp_ok = np.asarray(frame.kp.valid)
        usable = depth_ok & kp_ok
        if usable.sum() < self.cfg.init_min_depth_kp:
            if depth_ok.sum() == 0:
                return self._initialize_mono(frame)
            return False

        self.pose = se3.identity()
        kf = self._insert_keyframe(frame)
        self.state = TrackState.OK
        self.last_inliers = int(usable.sum())
        self._record_trajectory()
        return True

    def _initialize_mono(self, frame: Frame) -> bool:
        """Monocular two-view initialization (Initializer.cc semantics +
        CreateInitialMapMonocular, Tracking.cc:650-930): hold a reference
        frame, match, run the batched H/F RANSAC initializer, normalize the
        map scale to median depth 1."""
        if self._init_ref is None:
            if int(frame.kp.valid.sum()) >= 100:
                self._init_ref = frame
            return False
        ref = self._init_ref

        window = matching.projection_window_mask(ref.kp.xy, frame.kp.xy, 100.0)
        res = matching.match_descriptors(
            ref.kp.desc, frame.kp.desc, ref.kp.valid, frame.kp.valid,
            window_mask=window, max_dist=matching.TH_LOW, ratio=0.9, mutual=True,
            angles=(ref.kp.angle, frame.kp.angle),
        )
        if int(res.valid.sum()) < 100:
            self._init_ref = frame  # reference resets when matching fails
            return False

        self._key, sub = jax.random.split(self._key)
        init = initializer.initialize_two_view(
            sub, ref.kp.xy, frame.kp.xy[res.idx], res.valid, self.cam
        )
        if not bool(init.success):
            return False

        good = np.asarray(init.good)
        pts = np.asarray(init.points_w)
        # Scale normalization: median scene depth -> 1 (Tracking.cc:880-905).
        med = float(np.median(pts[good][:, 2]))
        if med <= 0:
            return False
        pts = pts / med
        T21 = se3.SE3(init.T_21.R, init.T_21.t / med)

        # Keyframe 1 at identity, keyframe 2 at T21.
        self.pose = se3.identity()
        self.last_lm_ids = None
        kf1 = self._insert_keyframe(ref)
        self.pose = T21
        kf2 = self._insert_keyframe(frame)

        idx2 = np.asarray(res.idx)
        store = self.store
        for i in np.where(good)[0]:
            if store.num_lm >= store.max_landmarks:
                break
            lm = store.add_landmark(pts[i], np.asarray(ref.kp.desc[i]), kf1)
            store.add_observation(lm, kf1, int(i))
            store.add_observation(lm, kf2, int(idx2[i]))
        store.update_connections(kf1)
        store.update_connections(kf2)
        new_lms = store.kf_obs_lm[kf2]
        store.update_landmark_stats(new_lms[new_lms >= 0])

        self.state = TrackState.OK
        self.last_inliers = int(good.sum())
        self.velocity = jnp.zeros(6)
        self._init_ref = None
        self._record_trajectory()
        return True

    def _insert_keyframe(
        self, frame: Frame, pose_R_h=None, pose_t_h=None, frame_id=None
    ) -> int:
        """Create a keyframe + landmarks from depth (CreateNewKeyFrame).

        New landmarks come from depth-carrying keypoints not already matched
        to the map, nearest-first, capped (UpdateLastFrame/CreateNewKeyFrame
        close-point creation, Tracking.cc:1385-1492, 1846-1953)."""
        with self.map_lock:
            return self._insert_keyframe_locked(frame, pose_R_h, pose_t_h, frame_id)

    def _insert_keyframe_locked(
        self, frame: Frame, pose_R_h=None, pose_t_h=None, frame_id=None
    ) -> int:
        store = self.store
        kp = frame.kp
        words = bow = None
        if self.vocab_hook is not None:
            words, bow = self.vocab_hook(kp.desc, kp.valid)
        # ONE packed fetch (3 leaves) of everything the keyframe record
        # needs — fetching the 9 fields separately costs a host<->device
        # synchronisation per leaf.
        pf, pi, ps = jax.device_get(_pack_kf_fields(self.pose, frame))
        xy, uvr, depth_a, angle = pf[:, :2], pf[:, 2:5], pf[:, 5], pf[:, 6]
        desc = pi[:, :8]
        octave = pi[:, 8].astype(np.int32)
        kp_valid = pi[:, 9].astype(bool)
        if pose_R_h is not None:
            R, t = pose_R_h, pose_t_h
        else:
            R, t = ps[:9].reshape(3, 3), ps[9:12]
        kf = store.add_keyframe(
            R=np.asarray(R),
            t=np.asarray(t),
            xy=xy,
            uvr=uvr,
            depth=depth_a,
            desc=desc,
            angle=angle,
            octave=octave,
            kp_valid=kp_valid,
            words=words,
            bow=bow,
            frame_id=self.frame_idx if frame_id is None else frame_id,
        )

        # Existing map matches from the last tracking stage.
        matched_kp = set()
        if self.last_lm_ids is not None:
            for lm_id, kp_idx in self.last_lm_ids:
                store.add_observation(int(lm_id), kf, int(kp_idx))
                matched_kp.add(int(kp_idx))

        # New landmarks from unmatched depth keypoints, nearest-first.
        depth = depth_a  # host copies fetched above
        valid = kp_valid & (depth > 0)
        cand = [i for i in np.argsort(np.where(valid, depth, np.inf)) if valid[i] and i not in matched_kp]
        R = np.asarray(R)
        t = np.asarray(t)
        T_wc_R = R.T
        C = -R.T @ t
        n_new = 0
        for i in cand:
            if n_new >= self.cfg.max_landmarks_per_kf:
                break
            z = depth[i]
            x_cam = np.array(
                [
                    (xy[i, 0] - self.cam.cx) * z / self.cam.fx,
                    (xy[i, 1] - self.cam.cy) * z / self.cam.fy,
                    z,
                ],
                np.float32,
            )
            pos_w = T_wc_R @ x_cam + C
            lm = store.add_landmark(pos_w, desc[i], kf)
            store.add_observation(lm, kf, int(i))
            n_new += 1

        store.update_connections(kf)
        new_lms = store.kf_obs_lm[kf]
        store.update_landmark_stats(new_lms[new_lms >= 0])
        if frame.lidar is not None:
            self._store_kf_lidar(kf, frame)
        self.ref_kf = kf
        self.frames_since_kf = 0
        if self.new_kf_callback is not None:
            self.new_kf_callback(kf)
        return kf

    # ------------------------------------------------------------------

    def _need_keyframe(
        self, num_inliers: int, tracked_close: int, untracked_close: int
    ) -> bool:
        """Keyframe policy ((c1a||c1b||c1c)&&c2 + close-point rule,
        Tracking.cc:1683-1835). The close-point counters come from the fused
        device step (no extra depth fetch)."""
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        # Reference matches against landmarks of the ref KF tracked in >=
        # nMinObs keyframes (TrackedMapPoints(nMinObs), Tracking.cc:1706-1711)
        # — counting ALL observations inflates ref_obs and turned every frame
        # into a keyframe early on.
        min_obs = 3 if self.store.num_kf > 2 else 2
        ref_lms = self.store.kf_obs_lm[self.ref_kf]
        ref_lms = ref_lms[ref_lms >= 0]
        ref_obs = int((self.store.lm_n_obs[ref_lms] >= min_obs).sum())
        weak = num_inliers < self.cfg.kf_tracked_ratio * max(ref_obs, 1)

        # Close-point rule: few tracked close points but many creatable ones.
        close_rule = (
            tracked_close < self.cfg.kf_close_tracked
            and untracked_close > self.cfg.kf_close_untracked
        )
        # The reference gates the whole OR on a minimum match count
        # (mnMatchesInliers > 15, Tracking.cc:1758).
        return (weak or close_rule) and num_inliers > 15

    def _relocalize(self, frame: Frame) -> bool:
        """Try BoW reloc candidates (plus the last reference KF); on success
        reset pose/ref_kf and let the normal stages refine this frame."""
        cand = [self.ref_kf]
        if self.reloc_db is not None and self.vocab_hook is not None:
            _, bow = self.vocab_hook(frame.kp.desc, frame.kp.valid)
            if bow is not None:
                cand = self.reloc_db.detect_reloc_candidates(bow)[:5] + cand
        for kf in cand:
            if kf < 0 or not self.store.kf_valid[kf]:
                continue
            kfs = [kf] + [int(x) for x in self.store.best_covisible(kf, 10)]
            lm_ids = np.unique(self.store.kf_obs_lm[kfs])
            lm_ids = lm_ids[lm_ids >= 0]
            lm_ids = lm_ids[self.store.lm_valid[lm_ids]]
            if len(lm_ids) > self.cfg.local_map_capacity:
                # Keep the NEWEST ids (freshest descriptors) — see
                # _gather_local_map.
                lm_ids = lm_ids[-self.cfg.local_map_capacity:]
            if len(lm_ids) < 30:
                continue
            buf = self._buffer_from_ids(lm_ids)
            self._key, sub = jax.random.split(self._key)
            pose, n = recover_pose_no_prior(sub, buf, frame, self.cam)
            if int(n) >= self.cfg.min_inliers_track:
                self.pose = pose
                self.velocity = jnp.zeros(6)
                self.velocity_valid = False
                self.ref_kf = kf
                self.state = TrackState.OK
                self.frames_lost = 0
                return True
        return False

    def _record_trajectory(self, pose_R_h=None, pose_t_h=None, frame_idx=None):
        """Store T_cur_ref = T_cw · T_ref_w^{-1} (relative to ref KF).

        Pure numpy (no device round trip): callers on the hot path pass the
        already-fetched pose; others fall back to fetching it."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        if pose_R_h is None:
            pose_R_h, pose_t_h = jax.device_get((self.pose.R, self.pose.t))
        pose_R_h = np.asarray(pose_R_h)
        pose_t_h = np.asarray(pose_t_h)
        with self.map_lock:
            R_ref = self.store.kf_R[self.ref_kf].copy()
            t_ref = self.store.kf_t[self.ref_kf].copy()
        # T_rel = T_cw · T_ref_w^{-1}: R_rel = R_cw R_ref^T,
        # t_rel = t_cw - R_rel t_ref.
        R_rel = pose_R_h @ R_ref.T
        t_rel = pose_t_h - R_rel @ t_ref
        self.trajectory.append((frame_idx, self.ref_kf, R_rel, t_rel))

    # ------------------------------------------------------------------

    def track(self, frame: Frame) -> Optional[se3.SE3]:
        """Track one frame; returns the frame pose T_cw (None while
        uninitialized). The reference's TrackFusion (Tracking.cc:366-588).

        With cfg.pipelined=True the steady-state FETCH of frame t's packed
        results is deferred until frame t+1's step has been dispatched: the
        device computes frame t while the host renders/feeds frame t+1, and
        pose/velocity chain device-to-device with no host sync between
        frames. This replaces the reference's tracking/mapping thread
        overlap (SURVEY §2.10 P1): no frame waits on a synchronous fetch of
        its own results. Consequences (documented
        semantics, all bounded to ONE frame of latency): LOST detection,
        the no-prior fallback, and keyframe insertion for frame t happen
        while t+1 is already in flight — on a correction the in-flight step
        is re-dispatched from the corrected state; a new keyframe becomes
        visible to the local map one frame later than in sync mode."""
        self.frame_idx += 1
        self.frames_since_kf += 1
        if self.cfg.pipelined and self.state == TrackState.OK:
            return self._track_pipelined(frame)
        self.flush()
        return self._track_sync(frame)

    def _track_sync(self, frame: Frame) -> Optional[se3.SE3]:
        if self.state == TrackState.NOT_INITIALIZED:
            if self._initialize(frame):
                return self.pose
            return None

        if self.state == TrackState.LOST:
            # Lost soon after init with a tiny map -> full reset and
            # re-initialize (Tracking.cc:547-556, System::Reset).
            if self.store.num_kf <= 5:
                self.store.reset()
                self.state = TrackState.NOT_INITIALIZED
                self.ref_kf = -1
                self.trajectory.clear()
                self.last_lm_ids = None
                if self._initialize(frame):
                    return self.pose
                return None
            # Relocalization (Tracking.cc:2334-2554): BoW candidate KFs ->
            # 3D-3D RANSAC against their local landmarks -> re-seed tracking.
            if not self._relocalize(frame):
                self.frames_lost += 1
                return None

        return self._track_steady(frame)

    def _dispatch_step(self, frame: Frame):
        """Launch the whole per-frame device computation (ONE dispatch, no
        host sync — motion model + both match/pose-LM stages + velocity +
        keyframe counters, Tracking.cc:1503-1668)."""
        lm_buffer = self._gather_local_map()
        lidar_map = self._gather_lidar_local_map() if frame.lidar is not None else None
        prev_pose = self.pose
        pose, velocity, packed_i, packed_f = track_frame_step(
            self.pose, self.velocity, lm_buffer, frame, self.cam,
            self.cfg.match_radius_motion, self.cfg.match_radius_local,
            self.cfg.min_inliers_track, self.cfg.close_depth,
            lidar_map=lidar_map, match_dist=self.cfg.lidar_match_dist,
            num_levels=self.cfg.num_levels, scale_factor=self.cfg.scale_factor,
        )
        return (frame, self.frame_idx, lm_buffer, lidar_map,
                pose, velocity, packed_i, packed_f, prev_pose)

    def _track_steady(self, frame: Frame) -> Optional[se3.SE3]:
        """Synchronous steady-state frame: dispatch + immediate consume."""
        pending = self._dispatch_step(frame)
        ok, _ = self._consume_step(pending, commit_pose=True)
        return self.pose if ok else None

    def _track_pipelined(self, frame: Frame) -> Optional[se3.SE3]:
        """Deferred-fetch steady state: dispatch frame t+1 FIRST, then
        finalize frame t's already-computed results."""
        cur = self._dispatch_step(frame)
        prev, self._pending = self._pending, cur
        # Chain pose/velocity device-to-device (no host sync).
        self.pose, self.velocity = cur[4], cur[5]
        if prev is not None:
            ok, corrected = self._consume_step(prev, commit_pose=False)
            if not ok or corrected:
                # The in-flight step chained off a bad/corrected pose.
                self._pending = None
                if self.state == TrackState.OK:
                    return self._track_steady(frame)  # redo from corrected
                return None  # lost with frame t; t+1 relocalizes next call
        return self.pose

    def flush(self) -> None:
        """Finalize any deferred frame (pipelined mode). Must run before
        reading trajectory/state or mutating the map externally."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._consume_step(prev, commit_pose=False)

    def _consume_step(self, pending, commit_pose: bool):
        """Fetch + host bookkeeping for one dispatched step. Returns
        (ok, corrected): ok=False means tracking was lost at this frame;
        corrected=True means the no-prior fallback replaced the pose (any
        step chained off the original dispatch must be redone)."""
        (frame, frame_idx, lm_buffer, lidar_map,
         pose, velocity, packed_i, packed_f, prev_pose) = pending
        packed_i, packed_f = jax.device_get((packed_i, packed_f))
        corrected = False

        if int(packed_f[13]) < self.cfg.min_inliers_track:  # nA
            # No-prior fallback: descriptor-only match + 3D-3D RANSAC seed
            # (TrackReferenceKeyFrame geometry, Tracking.cc:1317-1377).
            self._key, sub = jax.random.split(self._key)
            seed_pose, n_ransac = recover_pose_no_prior(
                sub, lm_buffer, frame, self.cam
            )
            if int(n_ransac) >= self.cfg.min_inliers_track:
                pose, velocity, packed_i, packed_f = track_frame_step(
                    seed_pose, jnp.zeros(6), lm_buffer, frame, self.cam,
                    self.cfg.match_radius_motion, self.cfg.match_radius_local,
                    self.cfg.min_inliers_track, self.cfg.close_depth,
                    lidar_map=lidar_map, match_dist=self.cfg.lidar_match_dist,
                    num_levels=self.cfg.num_levels,
                    scale_factor=self.cfg.scale_factor,
                )
                # The reference recomputes mVelocity from the LAST TWO frame
                # poses after EVERY tracked frame, including the
                # TrackReferenceKeyFrame fallback (Tracking.cc:1108-1114 /
                # :1503-1510); only true relocalization clears it. The
                # in-step velocity above is local_delta(final, seed) ~ the
                # LM refinement only — keeping it (or zero) mid-turn makes
                # the NEXT prediction lag by the full yaw rate and the
                # fallback re-fires every frame until tracking dies (the r5
                # corner death spiral).
                velocity = se3.local_delta(pose, prev_pose)
                packed_i, packed_f = jax.device_get((packed_i, packed_f))
                corrected = True

        pose_R_h = packed_f[:9].reshape(3, 3)
        pose_t_h = packed_f[9:12]
        n = int(packed_f[12])
        n_lidar = int(packed_f[14])
        tracked_close = int(packed_f[15])
        untracked_close = int(packed_f[16]) - tracked_close
        if lidar_map is not None:
            self.last_lidar_matches = n_lidar

        if n < self.cfg.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = jnp.zeros(6)
            self.velocity_valid = False
            return False, True

        # Bookkeeping: matched landmark -> keypoint pairs (host side).
        ids = np.asarray(lm_buffer.ids)
        mi, mv = packed_i[0], packed_i[1].astype(bool)
        sel = mv & (ids >= 0)
        self.last_lm_ids = np.stack([ids[sel], mi[sel]], axis=-1)

        # IncreaseVisible / IncreaseFound (Tracking.cc:1588-1600): the
        # found/visible ratio is what lets MapPointCulling kill duplicate
        # landmarks (in view every frame, rarely winning the mutual match).
        vis = packed_i[2].astype(bool) & (ids >= 0)
        with self.map_lock:
            self.store.lm_visible[ids[vis]] += 1
            self.store.lm_found[ids[sel]] += 1

        if commit_pose or corrected:
            # pose/velocity stay device-resident (next frame's step inputs).
            self.velocity = velocity
            self.pose = pose
        self.state = TrackState.OK
        self.velocity_valid = True
        self.last_inliers = n

        if not self.localization_only and self._need_keyframe(
            n, tracked_close, untracked_close
        ):
            self._insert_keyframe(
                frame, pose_R_h=pose_R_h, pose_t_h=pose_t_h, frame_id=frame_idx
            )
        self._record_trajectory(pose_R_h, pose_t_h, frame_idx=frame_idx)
        return True, corrected
