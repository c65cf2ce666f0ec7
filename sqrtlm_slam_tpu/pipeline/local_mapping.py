"""Local mapping: keyframe processing, culling, and local bundle adjustment.

JAX redesign of `LocalMapping` (/root/reference/src/backend/LocalMapping.cc):
  * `ProcessNewKeyFrame` (:203-263) — observation/descriptor/covisibility
    updates (largely handled at insertion by the tracker + store).
  * `MapPointCulling` (:270-328) — found-ratio < 0.25 or too few observers.
  * `SearchInNeighbors` fuse (:661-787) — duplicate landmark merging.
  * `Optimizer::LocalBundleAdjustment` (g2oOptimizer.cc:704-1191) — here
    the gather into a fixed-capacity BAProblem + the jitted Schur engine
    (optim/schur.py) + write-back/outlier-pruning under no lock at all
    (functional snapshots instead of Map::mMutexMapUpdate).
  * `KeyFrameCulling` (:931-1033) — >= 90% of landmarks seen >= 3x elsewhere.

The reference runs this on a dedicated thread consuming a KF queue (P1 in
SURVEY §2.10); here `process_keyframe` is invoked synchronously per KF by
default (single-host determinism) and is cheap enough to overlap via the
async driver in pipeline/system.py later.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3
from ..mapstore import MapStore
from ..optim import schur_bucketed
from . import triangulation


def _project_and_match_impl(
    pose_R, pose_t, lm_pos, lm_desc, lm_valid,
    lm_normal, lm_min_dist, lm_max_dist,
    kp_xy, kp_desc, kp_valid, cam: Camera, radius_px: float,
):
    """Project landmarks into a keyframe and Hamming-match within a window —
    with the reference's Fuse acceptance gates (ORBmatcher.cc:1109):
    positive depth, distance inside the scale-invariance range
    [0.8 minDist, 1.2 maxDist], and viewing angle < 60 deg to the mean
    normal. Without these, fusing over-merges distinct landmarks."""
    pose = se3.SE3(pose_R, pose_t)
    x_c = se3.act(pose, lm_pos)
    uv = cam.project(x_c)

    C = -jnp.einsum("ji,j->i", pose_R, pose_t)  # camera center in world
    v = lm_pos - C
    dist = jnp.linalg.norm(v, axis=-1)
    dist_ok = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    n_norm = jnp.linalg.norm(lm_normal, axis=-1)
    cos_view = jnp.sum(v * lm_normal, axis=-1) / jnp.maximum(dist * n_norm, 1e-9)
    angle_ok = (cos_view > 0.5) | (n_norm < 1e-6)  # < 60 deg (or no normal yet)

    ok = lm_valid & (x_c[..., 2] > 0.3) & dist_ok & angle_ok
    window = matching.projection_window_mask(uv, kp_xy, radius_px)
    return matching.match_descriptors(
        lm_desc, kp_desc, ok, kp_valid,
        window_mask=window, max_dist=matching.TH_LOW, mutual=True,
    )


_project_and_match = functools.partial(jax.jit, static_argnames=("cam", "radius_px"))(
    _project_and_match_impl
)


@functools.partial(jax.jit, static_argnames=("cam", "radius_px"))
def _project_and_match_many(
    pose_R, pose_t, lm_pos, lm_desc, lm_valid,
    lm_normal, lm_min_dist, lm_max_dist,
    kp_xy, kp_desc, kp_valid, cam: Camera, radius_px: float,
):
    """Batched variant: one landmark set projected into B keyframes at once
    (leading axis on pose/keypoint arrays) — the reverse direction of
    SearchInNeighbors as ONE dispatch instead of one per neighbor."""
    return jax.vmap(
        lambda R, t, xy, dsc, kv: _project_and_match_impl(
            R, t, lm_pos, lm_desc, lm_valid,
            lm_normal, lm_min_dist, lm_max_dist,
            xy, dsc, kv, cam, radius_px,
        )
    )(pose_R, pose_t, kp_xy, kp_desc, kp_valid)


class LocalMappingConfig(NamedTuple):
    pose_cap: int = 32  # P: local + frontier keyframes
    point_cap: int = 4096  # L
    obs_cap: int = 8  # K: per-landmark observation slots (bucketed layout)
    local_kf_cap: int = 16  # covisible window size
    min_found_ratio: float = 0.25  # MapPointCulling (LocalMapping.cc:270)
    min_obs_after: int = 2  # required observers once mature
    cull_redundancy: float = 0.9  # KeyFrameCulling 90% rule
    cull_min_obs: int = 3
    triangulate: bool = True  # CreateNewMapPoints (LocalMapping.cc:329)
    tri_neighbors: int = 6  # covisible neighbors searched (10/20 in ref)
    tri_max_new: int = 200  # new landmarks per keyframe pair cap
    backend: str = "bucketed"  # optim.facade backend (Optimizer.cc:26-28)


class LocalMapper:
    def __init__(self, store: MapStore, cam: Camera, cfg: LocalMappingConfig = LocalMappingConfig()):
        self.store = store
        self.cam = cam
        self.cfg = cfg
        from ..optim import facade

        self._optimizer = facade.Optimizer(cfg.backend)
        self._ba_jit = jax.jit(
            lambda p: self._optimizer.local_bundle_adjustment(p, cam)
        )
        self.recent_landmarks: list = []  # (lm_id, created_at_kf)

    # ------------------------------------------------------------------

    def process_keyframe(self, kf: int):
        """Full local-mapping pass for a freshly inserted keyframe."""
        self.store.update_connections(kf)
        self.map_point_culling(kf)
        if self.cfg.triangulate and self.store.num_kf >= 2:
            self.create_new_map_points(kf)
        self.search_in_neighbors(kf)
        if self.store.num_kf >= 3:
            self.local_ba(kf)
        self.keyframe_culling(kf)

    # ------------------------------------------------------------------

    def search_in_neighbors(self, kf: int, fuse_cap: int = 4096):
        """Two-level neighbor fuse (SearchInNeighbors, LocalMapping.cc:661-787):
        project neighbors' landmarks into kf and kf's landmarks into each
        neighbor; matches onto keypoints already bound to a landmark MERGE
        the two (keep the better-observed one), unbound matches become new
        observations."""
        store, cfg = self.store, self.cfg
        first = [int(x) for x in store.best_covisible(kf, 10)]
        neighbors = list(first)
        for nb in first[:5]:
            for nb2 in store.best_covisible(nb, 5):
                if int(nb2) != kf and int(nb2) not in neighbors:
                    neighbors.append(int(nb2))

        def lm_of(k):
            ids = store.kf_obs_lm[k]
            ids = np.unique(ids[ids >= 0])
            return ids[store.lm_valid[ids]][-fuse_cap:]

        def lm_buffer(lm_ids):
            cap = fuse_cap
            pos = np.zeros((cap, 3), np.float32)
            desc = np.zeros((cap, 8), np.uint32)
            val = np.zeros(cap, bool)
            normal = np.zeros((cap, 3), np.float32)
            dmin = np.zeros(cap, np.float32)
            dmax = np.full(cap, np.inf, np.float32)
            m = len(lm_ids)
            pos[:m] = store.lm_pos[lm_ids]
            desc[:m] = store.lm_desc[lm_ids]
            val[:m] = True
            normal[:m] = store.lm_normal[lm_ids]
            dmin[:m] = store.lm_min_dist[lm_ids]
            dmax[:m] = store.lm_max_dist[lm_ids]
            return pos, desc, val, normal, dmin, dmax

        def fuse_dispatch(target_kf, lm_ids):
            """Launch the projection match (async) — NO host sync here."""
            pos, desc, val, normal, dmin, dmax = lm_buffer(lm_ids)
            return _project_and_match(
                jnp.asarray(store.kf_R[target_kf]), jnp.asarray(store.kf_t[target_kf]),
                jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(val),
                jnp.asarray(normal), jnp.asarray(dmin), jnp.asarray(dmax),
                jnp.asarray(store.kf_xy[target_kf]),
                jnp.asarray(store.kf_desc[target_kf]),
                jnp.asarray(store.kf_kp_valid[target_kf]),
                self.cam, 3.0,
            )

        def fuse_apply(target_kf, lm_ids, res_valid, res_idx):
            m = len(lm_ids)
            hits = np.where(res_valid[:m])[0]
            kp_idx = res_idx[:m]
            n_fused = 0
            for j in hits:
                lm = int(lm_ids[j])
                kp = int(kp_idx[j])
                if not store.lm_valid[lm]:
                    continue  # merged away by an earlier apply
                existing = int(store.kf_obs_lm[target_kf, kp])
                if existing == lm:
                    continue
                if existing >= 0 and store.lm_valid[existing]:
                    # Merge: keep the better-observed landmark (MapPoint::Replace).
                    if store.lm_n_obs[existing] >= store.lm_n_obs[lm]:
                        store.replace_landmark(lm, existing)
                    else:
                        store.replace_landmark(existing, lm)
                else:
                    store.add_observation(lm, target_kf, kp)
                n_fused += 1
            return n_fused

        total = 0
        gathered = []
        for nb in neighbors:
            gathered.append(lm_of(nb))
        if gathered:
            # Keep the NEWEST ids when over capacity (np.unique sorts
            # ascending = oldest-first): duplicates needing a merge are the
            # recently created landmarks, and truncating them away made the
            # forward fuse a no-op once the map outgrew the cap.
            ids = np.unique(np.concatenate(gathered))[-fuse_cap:]
            if len(ids):
                res = fuse_dispatch(kf, ids)
                rv, ri = jax.device_get((res.valid, res.idx))
                total += fuse_apply(kf, ids, rv, ri)
        # Reverse direction: ONE vmapped dispatch over a fixed-capacity
        # neighbor batch (padded rows have kp_valid all-False -> no matches,
        # and the fixed B avoids per-neighbor-count recompiles).
        own = lm_of(kf)
        if len(own):
            # The neighbor list can reach 10 first-order + 5x5 second-order
            # = 35 entries; process it in fixed-size chunks of B so every
            # dispatch keeps ONE compiled shape while no neighbor is dropped.
            B = 24
            pos, desc, val, normal, dmin, dmax = lm_buffer(own)
            for start in range(0, len(neighbors), B):
                nbs = neighbors[start:start + B]
                bR = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
                bt = np.zeros((B, 3), np.float32)
                bxy = np.zeros((B,) + store.kf_xy.shape[1:], np.float32)
                bdesc = np.zeros((B,) + store.kf_desc.shape[1:], np.uint32)
                bval = np.zeros((B,) + store.kf_kp_valid.shape[1:], bool)
                for i, nb in enumerate(nbs):
                    bR[i] = store.kf_R[nb]
                    bt[i] = store.kf_t[nb]
                    bxy[i] = store.kf_xy[nb]
                    bdesc[i] = store.kf_desc[nb]
                    bval[i] = store.kf_kp_valid[nb]
                res = _project_and_match_many(
                    jnp.asarray(bR), jnp.asarray(bt),
                    jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(val),
                    jnp.asarray(normal), jnp.asarray(dmin), jnp.asarray(dmax),
                    jnp.asarray(bxy), jnp.asarray(bdesc), jnp.asarray(bval),
                    self.cam, 3.0,
                )
                rv, ri = jax.device_get((res.valid, res.idx))
                for i, nb in enumerate(nbs):
                    total += fuse_apply(nb, own, rv[i], ri[i])
        if total:
            touched = lm_of(kf)
            store.update_landmark_stats(touched[:512])
            store.update_connections(kf)
        return total

    # ------------------------------------------------------------------

    def create_new_map_points(self, kf: int):
        """Triangulate new landmarks against the best covisible neighbors
        (CreateNewMapPoints, LocalMapping.cc:329-661). Only keypoints not
        already bound to a landmark participate; accepted pairs become
        landmarks observed in both keyframes."""
        store, cfg = self.store, self.cfg
        T1 = se3.SE3(jnp.asarray(store.kf_R[kf]), jnp.asarray(store.kf_t[kf]))
        free1 = store.kf_kp_valid[kf] & (store.kf_obs_lm[kf] < 0)
        sigma2 = (1.2 ** (2 * store.kf_octave[kf])).astype(np.float32)
        n_created = 0
        # Dispatch all neighbor triangulations against the same free-keypoint
        # snapshot (in flight concurrently), then ONE batched fetch — the
        # double-binding the sequential reference avoids by re-masking is
        # handled by the kf_obs_lm guard in the apply loop below.
        handles = []
        for nb in store.best_covisible(kf, cfg.tri_neighbors):
            nb = int(nb)
            # Baseline check: skip neighbors too close for parallax
            # (LocalMapping.cc:398-420 baseline/medianDepth gate, simplified).
            base = np.linalg.norm(store.kf_center(kf) - store.kf_center(nb))
            if base < 0.05:
                continue
            T2 = se3.SE3(jnp.asarray(store.kf_R[nb]), jnp.asarray(store.kf_t[nb]))
            free2 = store.kf_kp_valid[nb] & (store.kf_obs_lm[nb] < 0)
            res = triangulation.match_and_triangulate(
                T1, T2, self.cam,
                jnp.asarray(store.kf_xy[kf]), jnp.asarray(store.kf_desc[kf]),
                jnp.asarray(free1), jnp.asarray(sigma2),
                jnp.asarray(store.kf_xy[nb]), jnp.asarray(store.kf_desc[nb]),
                jnp.asarray(free2),
                jnp.asarray((1.2 ** (2 * store.kf_octave[nb])).astype(np.float32)),
                angles1=jnp.asarray(store.kf_angle[kf]),
                angles2=jnp.asarray(store.kf_angle[nb]),
            )
            handles.append((nb, res))
        fetched = jax.device_get(
            [(r.valid, r.points_w, r.idx2) for _, r in handles]
        )
        for (nb, _), (res_valid, pts, idx2) in zip(handles, fetched):
            ok = np.where(res_valid)[0]
            new_here = []
            for i in ok[: cfg.tri_max_new]:
                if store.kf_obs_lm[kf, i] >= 0 or store.kf_obs_lm[nb, idx2[i]] >= 0:
                    continue  # bound by an earlier neighbor pass
                if store.num_lm >= store.max_landmarks:
                    break
                lm = store.add_landmark(pts[i], store.kf_desc[kf, i], kf)
                store.add_observation(lm, kf, int(i))
                store.add_observation(lm, nb, int(idx2[i]))
                new_here.append(lm)
                n_created += 1
            if new_here:
                store.update_landmark_stats(np.asarray(new_here))
                self.watch_landmarks(np.asarray(new_here), kf)
        if n_created:
            store.update_connections(kf)
        return n_created

    # ------------------------------------------------------------------

    def map_point_culling(self, current_kf: int):
        """Cull recently created landmarks that underperform
        (found-ratio < 0.25, or <= min_obs after 2 KFs)."""
        store = self.store
        keep = []
        for lm, born_kf in self.recent_landmarks:
            if not store.lm_valid[lm]:
                continue
            age = current_kf - born_kf
            ratio = store.lm_found[lm] / max(store.lm_visible[lm], 1)
            if ratio < self.cfg.min_found_ratio:
                store.erase_landmark(lm)
            elif age >= 2 and store.lm_n_obs[lm] <= self.cfg.min_obs_after:
                store.erase_landmark(lm)
            elif age >= 3:
                pass  # survived probation — drop from the watch list
            else:
                keep.append((lm, born_kf))
        self.recent_landmarks = keep

    def watch_landmarks(self, lm_ids, born_kf: int):
        for lm in np.atleast_1d(lm_ids):
            if lm >= 0:
                self.recent_landmarks.append((int(lm), born_kf))

    # ------------------------------------------------------------------

    def gather_problem(self, center_kf: int):
        """Build a fixed-capacity landmark-bucketed BA problem around
        `center_kf` (optim/schur_bucketed.py — the scatter-free engine; the
        map store is already landmark-bucketed so the gather is direct).

        Local KFs = center + best covisible; fixed frontier = other observers
        of the local landmarks (g2oOptimizer.cc:708-760). Returns
        (problem, (kf_ids, lm_ids, e_kf (L,K), e_kp (L,K))) for write-back."""
        store, cfg = self.store, self.cfg
        local = [center_kf] + [
            int(x) for x in store.best_covisible(center_kf, cfg.local_kf_cap - 1)
        ]
        local_set = set(local)

        lm_ids = np.unique(store.kf_obs_lm[local])
        lm_ids = lm_ids[lm_ids >= 0]
        lm_ids = lm_ids[store.lm_valid[lm_ids]][: cfg.point_cap]
        lm_slot = {int(l): i for i, l in enumerate(lm_ids)}

        # Frontier: observers of local landmarks outside the local window.
        observers = store.lm_obs_kf[lm_ids]
        obs_flat = observers[observers >= 0]
        frontier = [int(k) for k in np.unique(obs_flat) if k not in local_set]
        kf_ids = (local + frontier)[: cfg.pose_cap]
        kf_slot = {int(k): i for i, k in enumerate(kf_ids)}
        n_local_in = len([k for k in local if k in kf_slot])

        P, L, K = cfg.pose_cap, cfg.point_cap, cfg.obs_cap
        nk = len(kf_ids)
        nl = len(lm_ids)

        # Bucketed observation slots, landmark-major — fully vectorized
        # (the per-slot python loop was ~L*O iterations per keyframe and
        # dominated local-mapping host time at point_cap=4096).
        obs_cam = np.zeros((L, K), np.int32)
        obs_uvr = np.full((L, K, 3), -1.0, np.float32)
        obs_is2 = np.ones((L, K), np.float32)
        obs_valid = np.zeros((L, K), bool)
        e_kf = np.full((L, K), -1, np.int32)
        e_kp = np.full((L, K), -1, np.int32)
        if nl:
            slot_of = np.full(store.max_keyframes + 1, -1, np.int32)
            slot_of[np.asarray(kf_ids, np.int64)] = np.arange(nk, dtype=np.int32)
            okf = store.lm_obs_kf[lm_ids]  # (nl, O)
            oidx = store.lm_obs_idx[lm_ids]
            sel = (okf >= 0) & (slot_of[np.clip(okf, 0, None)] >= 0)
            # Compact each row's selected slots to the front, keep first K.
            order = np.argsort(~sel, axis=1, kind="stable")  # selected first
            okf_c = np.take_along_axis(okf, order, axis=1)[:, :K]
            oidx_c = np.take_along_axis(oidx, order, axis=1)[:, :K]
            sel_c = np.take_along_axis(sel, order, axis=1)[:, :K]
            okf_c = np.where(sel_c, okf_c, 0)
            oidx_c = np.where(sel_c, oidx_c, 0)
            obs_cam[:nl] = np.where(sel_c, slot_of[okf_c], 0)
            obs_uvr[:nl] = np.where(
                sel_c[..., None], store.kf_uvr[okf_c, oidx_c], -1.0
            )
            obs_is2[:nl] = np.where(
                sel_c, 1.0 / (1.2 ** (2 * store.kf_octave[okf_c, oidx_c])), 1.0
            )
            obs_valid[:nl] = sel_c
            e_kf[:nl] = np.where(sel_c, okf_c, -1)
            e_kp[:nl] = np.where(sel_c, oidx_c, -1)

        pose_R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        pose_t = np.zeros((P, 3), np.float32)
        pose_R[:nk] = store.kf_R[kf_ids]
        pose_t[:nk] = store.kf_t[kf_ids]
        pose_fixed = np.ones(P, bool)  # padding poses fixed
        for i, k in enumerate(kf_ids):
            # frontier fixed; also fix the oldest local KF as gauge anchor.
            pose_fixed[i] = (i >= n_local_in) or (k == min(local))
        pose_valid = np.zeros(P, bool)
        pose_valid[:nk] = True

        points = np.zeros((L, 3), np.float32)
        points[:nl] = store.lm_pos[lm_ids]
        point_valid = np.zeros(L, bool)
        point_valid[:nl] = True

        problem = schur_bucketed.BucketedBAProblem(
            pose_R=jnp.asarray(pose_R),
            pose_t=jnp.asarray(pose_t),
            pose_fixed=jnp.asarray(pose_fixed),
            pose_valid=jnp.asarray(pose_valid),
            points=jnp.asarray(points),
            point_valid=jnp.asarray(point_valid),
            obs_cam=jnp.asarray(obs_cam),
            obs_uvr=jnp.asarray(obs_uvr),
            obs_inv_sigma2=jnp.asarray(obs_is2),
            obs_valid=jnp.asarray(obs_valid),
        )
        meta = (kf_ids, lm_ids, e_kf, e_kp)
        return problem, meta

    def local_ba(self, center_kf: int):
        """Gather -> jitted Schur LM -> write back -> prune outliers.

        When the keyframes carry LiDAR feature clouds, a tight-coupling
        stage follows (g2oOptimizer.cc:978-1117): the optimized neighbor
        poses rebuild the lidar local maps, the center KF's features are
        re-associated, and its pose is refined with fused visual + lidar
        residuals."""
        problem, (kf_ids, lm_ids, e_kf, e_kp) = self.gather_problem(center_kf)
        result, survivors, stats = self._ba_jit(problem)

        store = self.store
        nk, nl = len(kf_ids), len(lm_ids)
        new_R, new_t, new_pts, surv = jax.device_get(
            (result.pose_R, result.pose_t, result.points, survivors)
        )
        fixed = np.asarray(problem.pose_fixed[:nk])
        for i, k in enumerate(kf_ids):
            if not fixed[i]:
                store.set_kf_pose(k, new_R[i], new_t[i])
        store.lm_pos[lm_ids] = new_pts[:nl]
        store.version += 1

        # Erase observations gated out by chi2/depth (g2oOptimizer.cc:1119-1189).
        # (e_kf >= 0) is the host copy of obs_valid — no extra device fetch.
        dropped = (e_kf >= 0) & ~surv
        for li, j in zip(*np.nonzero(dropped)):
            store.erase_observation(int(lm_ids[li]), int(e_kf[li, j]))

        if store.kf_corner_valid[center_kf].any():
            self._lidar_stage(center_kf)
        return stats

    def _lidar_stage(self, kf: int, match_dist: float = 0.45):
        """Fused visual+LiDAR refinement of the center keyframe pose against
        the post-BA lidar local map (the reference's 20-iteration lidar
        stage of local BA, g2oOptimizer.cc:978-1117)."""
        from ..lidar import odometry as lidar_odometry
        from ..lidar import voxel_map
        from ..optim import pose_opt

        store = self.store
        # Lidar local map from the OPTIMIZED neighbor poses.
        neighbors = [int(x) for x in store.best_covisible(kf, 10)]
        neighbors = [k for k in neighbors if store.kf_corner_valid[k].any()]
        if not neighbors:
            return
        n_slots = 10
        Nc, Nf = store.corner_per_kf, store.flat_per_kf
        corner = np.zeros((n_slots * Nc, 3), np.float32)
        corner_v = np.zeros(n_slots * Nc, bool)
        flat = np.zeros((n_slots * Nf, 3), np.float32)
        flat_n = np.zeros((n_slots * Nf, 3), np.float32)
        flat_v = np.zeros(n_slots * Nf, bool)
        for i, k in enumerate(neighbors[:n_slots]):
            R, t = store.kf_R[k], store.kf_t[k]
            corner[i * Nc : (i + 1) * Nc] = (store.kf_corner[k] - t) @ R
            corner_v[i * Nc : (i + 1) * Nc] = store.kf_corner_valid[k]
            flat[i * Nf : (i + 1) * Nf] = (store.kf_flat[k] - t) @ R
            flat_n[i * Nf : (i + 1) * Nf] = store.kf_flat_normal[k] @ R
            flat_v[i * Nf : (i + 1) * Nf] = store.kf_flat_valid[k]
        if corner_v.sum() + flat_v.sum() < 100:
            return
        lmap = lidar_odometry.build_local_map(
            jnp.asarray(corner), jnp.asarray(corner_v),
            jnp.asarray(flat), jnp.asarray(flat_v), jnp.asarray(flat_n),
            lidar_odometry.OdomConfig(),
        )

        # Visual observations of the center KF from its landmark bindings.
        pose = se3.SE3(jnp.asarray(store.kf_R[kf]), jnp.asarray(store.kf_t[kf]))
        kp_lm = store.kf_obs_lm[kf]
        sel = kp_lm >= 0
        cap = 1024
        pts = np.zeros((cap, 3), np.float32)
        uvr = np.full((cap, 3), -1.0, np.float32)
        is2 = np.ones(cap, np.float32)
        val = np.zeros(cap, bool)
        idx = np.where(sel)[0][:cap]
        pts[: len(idx)] = store.lm_pos[kp_lm[idx]]
        uvr[: len(idx)] = store.kf_uvr[kf, idx]
        is2[: len(idx)] = 1.0 / (1.2 ** (2 * store.kf_octave[kf, idx]))
        val[: len(idx)] = True
        obs = pose_opt.VisualObs(
            points_w=jnp.asarray(pts), uvr=jnp.asarray(uvr),
            inv_sigma2=jnp.asarray(is2), valid=jnp.asarray(val),
        )

        # Associate the KF's own (stored, KF-frame) features at its pose.
        c_pts = jnp.asarray(store.kf_corner[kf])
        c_val = jnp.asarray(store.kf_corner_valid[kf])
        f_pts = jnp.asarray(store.kf_flat[kf])
        f_val = jnp.asarray(store.kf_flat_valid[kf])
        c_w = se3.act(se3.inverse(pose), c_pts)
        f_w = se3.act(se3.inverse(pose), f_pts)
        ci, _, cok = voxel_map.knn(lmap.corner, c_w, k=1, max_dist=match_dist)
        fi, _, fok = voxel_map.knn(lmap.flat, f_w, k=1, max_dist=match_dist)
        f_target = lmap.flat.points[fi[:, 0]]
        f_normal = lmap.flat.payload[fi[:, 0]]
        lobs = pose_opt.LidarObs(
            flat_pts=f_pts,
            plane_n=f_normal,
            plane_d=-jnp.sum(f_normal * f_target, axis=-1),
            flat_valid=fok[:, 0] & f_val,
            corner_pts=c_pts,
            corner_target=lmap.corner.points[ci[:, 0]],
            corner_valid=cok[:, 0] & c_val,
        )
        result = pose_opt.optimize_pose(
            pose, obs, self.cam, lidar_obs=lobs, rounds=1, iters_per_round=5,
            lidar_iters=20,
        )
        store.set_kf_pose(kf, np.asarray(result.pose.R), np.asarray(result.pose.t))

    # ------------------------------------------------------------------

    def keyframe_culling(self, current_kf: int):
        """Cull covisible KFs whose landmarks are >= 90% redundantly observed
        (LocalMapping.cc:931-1033). The most recent KF and KF 0 are kept."""
        store, cfg = self.store, self.cfg
        for kf in store.best_covisible(current_kf, cfg.local_kf_cap):
            kf = int(kf)
            if kf == 0 or kf == current_kf or not store.kf_valid[kf]:
                continue
            lms = store.kf_obs_lm[kf]
            lms = lms[lms >= 0]
            if len(lms) == 0:
                continue
            redundant = (store.lm_n_obs[lms] >= cfg.cull_min_obs + 1).sum()
            if redundant > cfg.cull_redundancy * len(lms):
                self._cull_keyframe(kf)

    def _cull_keyframe(self, kf: int):
        store = self.store
        lms = store.kf_obs_lm[kf]
        for i, lm in enumerate(lms):
            if lm >= 0:
                store.erase_observation(int(lm), kf)
        store.kf_valid[kf] = False
        store.covis[kf] = 0
        store.covis[:, kf] = 0
        # Re-parent children in the spanning tree.
        children = np.where(store.parent == kf)[0]
        store.parent[children] = store.parent[kf]
        # Direct writes above bypass the store's mutating methods; bump the
        # version explicitly so the tracker's device-resident local-map cache
        # (keyed on store.version) cannot serve a stale map containing this
        # culled keyframe even if every erase_observation above was a no-op.
        store.version += 1
