"""LOAM-style LiDAR odometry: scan-to-local-map alignment + keyframe window.

JAX redesign of `art::Odom` (/root/reference/src/algorithm/lidarOdom.cc):
  * `FrontEndForSLAM` (:1369-1572) — 5 outer iterations of {NN association
    against a voxel-filtered local map of the last 30 keyframes, Ceres solve
    with corner point-to-point (`LidarDistanceFactor`) and flat
    point-to-plane (`LidarPlaneNormFactor`) residuals}.
  * keyframe policy: dt > 2 m or dtheta > 5 deg (:1501-1510); local map kept
    in `CircularBuffer`s (:1384-1385) and voxel-filtered at 0.4 m (:1528-1542).

Here the inner solve is a damped Gauss-Newton on SE(3) (analytic Jacobians
from factors/lidar.py), association is the voxel-hash knn (lidar/voxel_map),
and each outer iteration is one jit-compiled device computation. The keyframe
ring buffer is a fixed-capacity device array pair managed by a thin host
driver (`LidarOdometry`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..factors import lidar as lf
from ..geometry import se3
from . import features as feat
from . import voxel_map as vmap


class OdomConfig(NamedTuple):
    outer_iters: int = 5  # lidarOdom.cc:1419 (5 outer Ceres solves)
    gn_iters: int = 3  # damped GN steps per association round
    kf_window: int = 30  # CircularBuffer capacity (lidarOdom.cc:1384)
    map_cell: float = 0.8  # voxel cell for the NN grid (>= search radius)
    downsample_cell: float = 0.4  # map voxel filter leaf (lidarOdom.cc:1528)
    max_match_dist: float = 1.0  # association gate (m)
    corner_weight: float = 30.0
    flat_weight: float = 50.0
    kf_dist: float = 2.0  # keyframe translation threshold (m)
    kf_angle_deg: float = 5.0  # keyframe rotation threshold
    map_capacity: int = 8192  # downsampled local-map point budget
    damping: float = 1e-4


class LocalMap(NamedTuple):
    """Voxel-hash maps for both feature classes (world frame)."""

    corner: vmap.VoxelMap
    flat: vmap.VoxelMap  # payload = (normal_xyz,) world frame


def build_local_map(
    corner_pts_w, corner_valid, flat_pts_w, flat_valid, flat_normals_w, cfg: OdomConfig
) -> LocalMap:
    """Downsample world-frame feature clouds and build the NN grids."""
    c_ds, c_ok = vmap.voxel_downsample(
        corner_pts_w, corner_valid, cfg.downsample_cell, cfg.map_capacity
    )
    corner = vmap.build(c_ds, c_ok, cfg.map_cell)
    # For flats, keep the normal of the representative point: downsample by
    # stacking xyz+normal and selecting per-voxel representatives jointly.
    stacked = jnp.concatenate([flat_pts_w, flat_normals_w], axis=-1)
    f_ds6, f_ok = _voxel_downsample_payload(
        stacked, flat_valid, cfg.downsample_cell, cfg.map_capacity
    )
    flat = vmap.build(f_ds6[:, :3], f_ok, cfg.map_cell, payload=f_ds6[:, 3:])
    return LocalMap(corner=corner, flat=flat)


def _voxel_downsample_payload(stacked, valid, cell, capacity):
    """voxel_downsample for points with payload columns (first 3 = xyz)."""
    pts = stacked[:, :3]
    ijk = jnp.floor(pts / cell).astype(jnp.int32)
    keys = jnp.where(valid, vmap._voxel_key(ijk), vmap._INVALID_KEY)
    order = jnp.argsort(keys)
    skeys = keys[order]
    srows = stacked[order]
    first = jnp.concatenate([jnp.array([True]), skeys[1:] != skeys[:-1]]) & (
        skeys != vmap._INVALID_KEY
    )
    rank = jnp.cumsum(first) - 1
    slot = jnp.clip(jnp.where(first, rank, capacity), 0, capacity)
    D = stacked.shape[1]
    out = jnp.zeros((capacity + 1, D), dtype=stacked.dtype).at[slot].set(srows)
    ok = jnp.zeros((capacity + 1,), dtype=bool).at[slot].set(first)
    return out[:capacity], ok[:capacity]


def _association(pose: se3.SE3, pts_s, valid, grid: vmap.VoxelMap, max_dist):
    """World-project sensor points and find their nearest map neighbor."""
    p_w = lf.point_world(pose, pts_s)
    idx, d2, ok = vmap.knn(grid, p_w, k=1, max_dist=max_dist)
    return idx[:, 0], ok[:, 0] & valid


# DoF-restriction presets mirroring the reference's analytic per-DoF factors
# `LidarPlaneFactor_{z_rot_xy_trans, z_trans, x_rot, y_rot, xy_rot_z_trans,
# xyz_rot_xyz_trans}` (lidarFactor.h:493-901). Tangent order is
# [tx, ty, tz, rx, ry, rz] (se3.retract); a zero masks that DoF out of the
# solve (the batched equivalent of a SizedCostFunction with zeroed Jacobian
# columns — one masked solve replaces six hand-written factor classes).
DOF_PRESETS = {
    "z_rot_xy_trans": jnp.array([1.0, 1.0, 0.0, 0.0, 0.0, 1.0]),
    "z_trans": jnp.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0]),
    "x_rot": jnp.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]),
    "y_rot": jnp.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
    "xy_rot_z_trans": jnp.array([0.0, 0.0, 1.0, 1.0, 1.0, 0.0]),
    "xyz_rot_xyz_trans": jnp.ones(6),
}


@functools.partial(jax.jit, static_argnames=("cfg",))
def align_scan(
    pose0: se3.SE3,
    corner_pts: jnp.ndarray,
    corner_valid: jnp.ndarray,
    flat_pts: jnp.ndarray,
    flat_valid: jnp.ndarray,
    local_map: LocalMap,
    cfg: OdomConfig,
    dof_mask: Optional[jnp.ndarray] = None,
):
    """Scan-to-map alignment: outer re-association x inner damped GN.

    pose0: initial guess T_lw (world -> lidar). Returns (pose, stats dict).
    One fused XLA computation — the reference's per-iteration kd-tree queries
    + Ceres solves (lidarOdom.cc:1419-1495) become gathers + 6x6 solves.
    `dof_mask` (6,) restricts the update to a DoF subset (see DOF_PRESETS).
    """
    if dof_mask is None:
        dof_mask = jnp.ones(6)

    def outer(pose, _):
        c_idx, c_ok = _association(
            pose, corner_pts, corner_valid, local_map.corner, cfg.max_match_dist
        )
        c_target = local_map.corner.points[c_idx]
        f_idx, f_ok = _association(
            pose, flat_pts, flat_valid, local_map.flat, cfg.max_match_dist
        )
        f_target = local_map.flat.points[f_idx]
        f_normal = local_map.flat.payload[f_idx]
        # Plane through target with the map normal: d = -n . q.
        f_d = -jnp.sum(f_normal * f_target, axis=-1)

        def gn(pose, _):
            rc, Jc = lf.point_residual_jac(pose, corner_pts, c_target)
            wc = cfg.corner_weight * c_ok.astype(rc.dtype)
            Hc = jnp.einsum("eki,e,ekj->ij", Jc, wc, Jc)
            bc = jnp.einsum("eki,e,ek->i", Jc, wc, rc)
            chic = jnp.sum(wc * jnp.sum(rc * rc, axis=-1))

            rf, Jf = lf.plane_residual_jac(pose, flat_pts, f_normal, f_d)
            wf = cfg.flat_weight * f_ok.astype(rf.dtype)
            Hf = jnp.einsum("ei,e,ej->ij", Jf, wf, Jf)
            bf = jnp.einsum("ei,e,e->i", Jf, wf, rf)
            chif = jnp.sum(wf * rf * rf)

            H = Hc + Hf
            b = bc + bf
            # DoF restriction: zero masked rows/cols, pin their diagonal.
            m = dof_mask.astype(H.dtype)
            H = H * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
            b = b * m
            lam = cfg.damping * jnp.maximum(jnp.max(jnp.abs(jnp.diag(H))), 1e-9)
            dx = jnp.linalg.solve(H + lam * jnp.eye(6, dtype=H.dtype), -b)
            return se3.retract(pose, dx * m), chic + chif

        pose, chi2 = jax.lax.scan(gn, pose, None, length=cfg.gn_iters)
        n_matched = jnp.sum(c_ok) + jnp.sum(f_ok)
        return pose, (chi2[-1], n_matched)

    pose, (chi2s, n_matched) = jax.lax.scan(outer, pose0, None, length=cfg.outer_iters)
    return pose, {"chi2": chi2s[-1], "matches": n_matched[-1]}


class LidarOdometry:
    """Host driver: keyframe ring buffer + jitted alignment.

    API parity with `art::Odom::EstimatePoseForSLAM` (lidarOdom.cc:222):
    feed raw clouds (`process`) or pre-extracted features
    (`process_features`); get the world pose T_lw back.
    """

    def __init__(
        self,
        cfg: OdomConfig = OdomConfig(),
        feat_cfg: feat.LidarConfig = feat.LidarConfig(),
    ):
        self.cfg = cfg
        self.feat_cfg = feat_cfg
        self.pose = se3.identity()  # T_lw (world -> lidar)
        self.last_kf_pose: Optional[se3.SE3] = None
        self.velocity = jnp.zeros(6)  # constant-velocity motion model
        self._kf_corner: list = []  # world-frame (pts, valid) per keyframe
        self._kf_flat: list = []  # world-frame (pts, valid, normals)
        self._local_map: Optional[LocalMap] = None
        self.num_keyframes = 0
        # Modes (art::Odom variants, lidarOdom.cc):
        #   "slam"         — FrontEndForSLAM (:1369): sliding keyframe window
        #   "mapping"      — FrontEndForMapping (:1575): unbounded map growth
        #   "localization" — FrontEndForLocalization (:1952): align against a
        #                    fixed prior map, never modify it
        self.mode = "slam"

    # -- keyframe management -------------------------------------------------

    def _is_keyframe(self, pose: se3.SE3) -> bool:
        if self.last_kf_pose is None:
            return True
        d = se3.local_delta(pose, self.last_kf_pose)
        dt = float(jnp.linalg.norm(d[:3]))
        dr = float(jnp.linalg.norm(d[3:]))
        return dt > self.cfg.kf_dist or dr > math.radians(self.cfg.kf_angle_deg)

    def _insert_keyframe(self, pose: se3.SE3, f: feat.LidarFeatures):
        corner_w = lf.point_world(pose, f.less_sharp)
        flat_w = lf.point_world(pose, f.less_flat)
        # Rotate flat normals to world (approximate per-KF normals: reuse the
        # sharp-flat normals where available, else up-vector placeholder).
        Rt = jnp.swapaxes(pose.R, -1, -2)
        # For less_flat we need normals: recompute from flat set by nearest
        # association is overkill here; store plane normals from the flat set
        # transformed to world, padded to the less_flat capacity.
        n_w = jnp.einsum("ij,nj->ni", Rt, f.flat_normal)
        flat_src_w = lf.point_world(pose, f.flat)
        self._kf_corner.append((np.asarray(corner_w), np.asarray(f.less_sharp_valid)))
        self._kf_flat.append(
            (np.asarray(flat_src_w), np.asarray(f.flat_valid), np.asarray(n_w))
        )
        if self.mode != "mapping" and len(self._kf_corner) > self.cfg.kf_window:
            self._kf_corner.pop(0)
            self._kf_flat.pop(0)
        self.last_kf_pose = pose
        self.num_keyframes += 1

        c_pts = jnp.asarray(np.concatenate([c for c, _ in self._kf_corner]))
        c_ok = jnp.asarray(np.concatenate([v for _, v in self._kf_corner]))
        f_pts = jnp.asarray(np.concatenate([p for p, _, _ in self._kf_flat]))
        f_ok = jnp.asarray(np.concatenate([v for _, v, _ in self._kf_flat]))
        f_n = jnp.asarray(np.concatenate([n for _, _, n in self._kf_flat]))
        self._local_map = build_local_map(
            c_pts, c_ok, f_pts, f_ok, f_n, self.cfg
        )

    # -- main entry ----------------------------------------------------------

    def set_prior_map(
        self, corner_w, corner_valid, flat_w, flat_valid, flat_normals_w
    ):
        """Load a fixed world-frame prior map and enter localization mode
        (art::Odom::FrontEndForLocalization, lidarOdom.cc:1952-2466)."""
        self._local_map = build_local_map(
            jnp.asarray(corner_w), jnp.asarray(corner_valid),
            jnp.asarray(flat_w), jnp.asarray(flat_valid),
            jnp.asarray(flat_normals_w), self.cfg,
        )
        self.mode = "localization"

    def process(self, points: jnp.ndarray, dof: Optional[str] = None) -> se3.SE3:
        """Track one raw LiDAR cloud (N, 3) in the sensor frame. The cloud
        is bucket-padded so variable scan sizes share one jit shape."""
        f = feat.extract_features_jit(feat.pad_cloud(points), self.feat_cfg)
        return self.process_features(f, dof=dof)

    def process_features(
        self, f: feat.LidarFeatures, dof: Optional[str] = None
    ) -> se3.SE3:
        """Track one pre-extracted feature scan. `dof` optionally names a
        DOF_PRESETS entry restricting the solve (per-DoF estimation, the
        reference's restricted LidarPlaneFactor_* family)."""
        if self._local_map is None:
            if self.mode == "localization":
                raise RuntimeError("localization mode requires set_prior_map()")
            self._insert_keyframe(self.pose, f)
            return self.pose

        guess = se3.retract(self.pose, self.velocity)
        pose, _stats = align_scan(
            guess,
            f.sharp,
            f.sharp_valid,
            f.flat,
            f.flat_valid,
            self._local_map,
            self.cfg,
            dof_mask=None if dof is None else DOF_PRESETS[dof],
        )
        self.velocity = se3.local_delta(pose, self.pose)
        self.pose = pose
        if self.mode != "localization" and self._is_keyframe(pose):
            self._insert_keyframe(pose, f)
        return pose

    # -- backend (loop / GNSS pose graph) ------------------------------------

    def record_pose(self):
        """Append the current pose to the backend trajectory chain."""
        if not hasattr(self, "_chain"):
            self._chain = []
        self._chain.append(self.pose)

    def backend_for_loop(self, i: int, j: int, T_ji: se3.SE3, iters: int = 20):
        """Relax the recorded pose chain with a loop constraint
        (art::Odom::BackEndForLoop, lidarOdom.cc:2467-2531). Returns the
        corrected chain and updates the current pose to the corrected tail."""
        from . import backend as _backend

        g = _backend.build_chain_graph(self._chain, [(i, j, T_ji)])
        out, _ = _backend.optimize_se3_graph(g, num_iters=iters)
        self._chain = [
            se3.SE3(out.R[k], out.t[k]) for k in range(len(self._chain))
        ]
        self.pose = self._chain[-1]
        return self._chain

    def backend_for_gnss(self, anchors, iters: int = 20):
        """Relax the chain against GNSS-style world-position anchors
        (art::Odom::BackEndForGNSS, lidarOdom.cc:2534-2601).
        anchors: [(frame_idx, xyz world position)]."""
        from . import backend as _backend

        g = _backend.build_chain_graph(self._chain, [], anchors=anchors)
        out, _ = _backend.optimize_se3_graph(g, num_iters=iters)
        self._chain = [
            se3.SE3(out.R[k], out.t[k]) for k in range(len(self._chain))
        ]
        self.pose = self._chain[-1]
        return self._chain
