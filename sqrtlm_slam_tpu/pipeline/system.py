"""SLAM system facade: wiring tracking + local mapping (+ loop closing).

JAX equivalent of `ORB_SLAM2::System`
(/root/reference/src/System.cc): constructs the map store, tracker and local
mapper, cross-wires them (System.cc:130-165), exposes `track_*` entry points
(TrackFusion System.h:130 / TrackMonocular :127), trajectory savers in KITTI
format (System.cc:503-560) and TUM format (:364-499), `reset` (:338) and the
relative-pose trajectory recovery (Tracking.cc:566-587: each frame stores its
pose relative to a reference keyframe, so keyframe corrections from BA/loop
closure propagate to the full trajectory at save time).

The reference spawns LocalMapping/LoopClosing threads; here local mapping
runs synchronously per keyframe (deterministic; the XLA computations inside
are already asynchronous w.r.t. the host) and loop closing hooks in via
`loop/` when enabled.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..factors.reprojection import Camera
from ..frontend import orb, vocab as vocab_mod
from ..geometry import se3
from ..mapstore import MapStore
from .frame import Frame, build_frame_jit
from .local_mapping import LocalMapper, LocalMappingConfig
from .tracking import Tracker, TrackingConfig, TrackState


class SystemConfig(NamedTuple):
    orb: orb.ORBConfig = orb.ORBConfig()
    tracking: TrackingConfig = TrackingConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    max_keyframes: int = 512
    max_landmarks: int = 60000
    loop_detection: bool = False  # SLAM.LoopDetection flag (fusionsystem.cc:9)
    lidar: Optional[object] = None  # lidar.features.LidarConfig for fusion
    use_shipped_vocab: bool = True  # load assets/orbvoc_*.npz when no vocab given
    # Run local mapping + loop closing on a background worker thread,
    # overlapping them with tracking — the reference's 3-pthread pipeline
    # (System.cc:139-154, SURVEY §2.10 P1). Off by default: the sequential
    # driver is deterministic (tests, evaluation); async mode trades that
    # for per-frame latency. A coarse map lock replaces Map::mMutexMapUpdate.
    async_mapping: bool = False


class SlamSystem:
    def __init__(
        self,
        cam: Camera,
        cfg: SystemConfig = SystemConfig(),
        vocabulary: Optional["vocab_mod.Vocabulary"] = None,
        loop_cfg=None,
    ):
        from ..utils.cache import configure_jax

        configure_jax()
        self.cam = cam
        self.cfg = cfg
        if vocabulary is None and cfg.use_shipped_vocab:
            # The committed synthetic-domain vocabulary asset (the
            # counterpart of the reference's ORBvoc load, System.cc:109);
            # falls back to lazy on-the-fly training when absent.
            vocabulary = vocab_mod.load_default()
        self.vocabulary = vocabulary
        self.store = MapStore(
            max_keyframes=cfg.max_keyframes,
            max_landmarks=cfg.max_landmarks,
            feats_per_kf=cfg.orb.max_features,
            num_words=vocabulary.num_words if vocabulary is not None else 1000,
        )
        # The tracker's scale-aware projection search must agree with the
        # extractor's pyramid shape (predicted octaves the extractor cannot
        # produce would gate out every candidate).
        tracking_cfg = cfg.tracking._replace(
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor
        )
        self.tracker = Tracker(self.store, cam, tracking_cfg)
        self.local_mapper = LocalMapper(self.store, cam, cfg.local_mapping)
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.vocab_hook = self._assign_words
        from ..loop.database import KeyFrameDatabase

        self.tracker.reloc_db = KeyFrameDatabase(self.store)
        self.loop_closer = None
        if cfg.loop_detection:
            from ..loop import LoopCloser, LoopClosingConfig

            self.loop_closer = LoopCloser(
                self.store, cam, voc=vocabulary,
                cfg=loop_cfg or LoopClosingConfig(),
            )

        # Async mapping worker (the reference's LocalMapping/LoopClosing
        # threads, System.cc:139-154). The map lock is the coarse equivalent
        # of Map::mMutexMapUpdate: the tracker holds it only for its
        # store-touching host sections, so the per-frame device dispatches
        # overlap with mapping/loop work.
        self._kf_queue = None
        self._worker = None
        self._shutdown = False
        if cfg.async_mapping:
            import queue
            import threading

            self.map_lock = threading.RLock()
            self.tracker.map_lock = self.map_lock
            if self.loop_closer is not None:
                # Async mode: GBA runs on its own thread under the shared
                # map lock and is abortable by a newer loop (the reference's
                # LoopClosing GBA thread + mbStopGBA, LoopClosing.cc:649-660).
                self.loop_closer.map_lock = self.map_lock
                self.loop_closer.async_gba = True
            self._kf_queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._mapping_worker, daemon=True
            )
            self._worker.start()

    def _mapping_worker(self):
        while True:
            kf = self._kf_queue.get()
            try:
                if kf is None:
                    return
                with self.map_lock:
                    self.local_mapper.process_keyframe(kf)
                    if self.loop_closer is not None:
                        self.loop_closer.insert_keyframe(kf)
            finally:
                self._kf_queue.task_done()

    def flush(self):
        """Block until all queued keyframes are mapped (async mode no-op
        otherwise) — call before reading trajectories/maps for evaluation."""
        if self._kf_queue is not None:
            self._kf_queue.join()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    def shutdown(self):
        """System::Shutdown (System.cc:346-360): drain + stop the worker."""
        self.tracker.flush()
        if self._kf_queue is not None and not self._shutdown:
            self._kf_queue.join()
            self._kf_queue.put(None)
            self._worker.join()
            self._shutdown = True
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    def _assign_words(self, desc, valid):
        """Word ids + BoW vector for a new keyframe; trains a vocabulary
        lazily from the first keyframe's descriptors when none was given
        (the reference loads a pre-trained 100 MB ORBvoc binary,
        System.cc:109 — see frontend/vocab.py for why on-domain training
        is the JAX substitute)."""
        import numpy as np

        if self.vocabulary is None:
            d = np.asarray(desc)[np.asarray(valid)]
            if len(d) < 50:
                return None, None
            self.vocabulary = vocab_mod.train(d, k=10, depth=3)
            if self.loop_closer is not None:
                self.loop_closer.voc = self.vocabulary
        voc = self.vocabulary
        import jax

        words = vocab_mod.assign_words(voc, jnp.asarray(desc), jnp.asarray(valid))
        bow = vocab_mod.bow_vector(voc, words)
        return jax.device_get((words, bow))

    def _on_new_keyframe(self, kf: int):
        if self._kf_queue is not None:
            self._kf_queue.put(kf)
            return
        self.local_mapper.process_keyframe(kf)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf)

    # ------------------------------------------------------------------
    # Tracking entry points (System::TrackFusion / TrackMonocular parity)
    # ------------------------------------------------------------------

    def track_fusion(
        self,
        image: jnp.ndarray,
        cloud_lidar: jnp.ndarray,
        T_cam_lidar=None,
    ):
        """Visual-LiDAR fusion (System::TrackFusion): the LiDAR-frame cloud
        supplies keypoint depth AND (with cfg.lidar set) corner/flat
        features for tight coupling. `T_cam_lidar` = (R, t) extrinsics
        (KITTI `Tr`, fusionsystem.cc:51-90). The cloud is bucket-padded so
        the variable per-scan point count shares one jit shape."""
        from ..lidar.features import pad_cloud

        frame = build_frame_jit(
            image, self.cam, self.cfg.orb, cloud_lidar=pad_cloud(cloud_lidar),
            T_cam_lidar=T_cam_lidar, lidar_cfg=self.cfg.lidar,
        )
        return self.tracker.track(frame)

    def track_depth(self, image: jnp.ndarray, depth_img: jnp.ndarray):
        """RGBD-style entry (depth image already in the camera frame)."""
        frame = build_frame_jit(image, self.cam, self.cfg.orb, depth_img=depth_img)
        return self.tracker.track(frame)

    def track_stereo(self, img_left: jnp.ndarray, img_right: jnp.ndarray):
        """Stereo entry (System::TrackStereo): row-constrained left-right ORB
        matching supplies the u_right/depth observations."""
        from .frame import build_frame_stereo_jit

        frame = build_frame_stereo_jit(img_left, img_right, self.cam, self.cfg.orb)
        return self.tracker.track(frame)

    def track_monocular(self, image: jnp.ndarray):
        """Monocular entry (System::TrackMonocular, System.h:127): two-view
        H/F-RANSAC initialization, then mono tracking with landmarks from
        local-mapping triangulation."""
        frame = build_frame_jit(image, self.cam, self.cfg.orb)
        return self.tracker.track(frame)

    def track_frame(self, frame: Frame):
        """Pre-built frame entry (tests / custom frontends)."""
        return self.tracker.track(frame)

    # ------------------------------------------------------------------

    @property
    def state(self) -> int:
        return self.tracker.state

    def num_keyframes(self) -> int:
        return int(self.store.kf_valid.sum())

    def num_landmarks(self) -> int:
        return int(self.store.lm_valid.sum())

    # ------------------------------------------------------------------
    # Checkpoint / resume (the SaveMap/LoadMap the reference left TODO,
    # System.h:178-181)
    # ------------------------------------------------------------------

    def save(self, path: str):
        from ..mapstore import checkpoint

        checkpoint.save_map(self.store, path, vocabulary=self.vocabulary)

    @classmethod
    def load(cls, path: str, cam: Camera, cfg: SystemConfig = SystemConfig(),
             loop_cfg=None) -> "SlamSystem":
        """Resume from a map checkpoint: the session starts LOST and
        relocalizes against the loaded map (localization-mode semantics)."""
        from ..mapstore import checkpoint

        store, voc = checkpoint.load_map(path)
        sys_ = cls(cam, cfg, vocabulary=voc, loop_cfg=loop_cfg)
        sys_.store.__dict__.update(store.__dict__)
        sys_.tracker.state = TrackState.LOST
        sys_.tracker.ref_kf = max(store.num_kf - 1, 0)
        return sys_

    def activate_localization_mode(self):
        """Track against the frozen map without inserting keyframes
        (System::ActivateLocalizationMode, System.cc:304-319)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """System::Reset (System.cc:338): clear map + tracking state."""
        self.store.reset()
        self.tracker.__init__(self.store, self.cam, self.cfg.tracking)
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.local_mapper.__init__(self.store, self.cam, self.cfg.local_mapping)

    def get_slam_result(self) -> dict:
        """Visualization snapshot mirroring the reference's `SLAMresult`
        struct (System.h:44-87 / System::getSLAMresult, System.cc:33-52):
        keyframe poses, tracking state, the landmarks seen last frame, the
        global map cloud, the local-map cloud around the reference KF, and
        the current KF's LiDAR feature clouds. Pure numpy — safe to hand to
        a separate plotting/rviz-style consumer."""
        self.tracker.flush()
        store, tracker = self.store, self.tracker
        kfs = np.where(store.kf_valid[: store.num_kf])[0]
        lms = np.where(store.lm_valid[: store.num_lm])[0]
        local_lms = np.empty(0, np.int64)
        if tracker.ref_kf >= 0:
            window = [tracker.ref_kf] + [
                int(x) for x in store.best_covisible(tracker.ref_kf, 10)
            ]
            ids = np.unique(store.kf_obs_lm[window])
            ids = ids[ids >= 0]
            local_lms = ids[store.lm_valid[ids]]
        result = {
            "state": tracker.state,
            "ref_kf": tracker.ref_kf,
            "num_inliers": tracker.last_inliers,
            "kf_ids": kfs,
            "kf_R": store.kf_R[kfs].copy(),
            "kf_t": store.kf_t[kfs].copy(),
            "map_points": store.lm_pos[lms].copy(),
            "local_map_points": store.lm_pos[local_lms].copy(),
            "tracked_landmarks": (
                np.asarray([lm for lm, _ in tracker.last_lm_ids])
                if tracker.last_lm_ids is not None
                else np.empty(0, np.int64)
            ),
            "trajectory": self.get_trajectory(),
        }
        if tracker.ref_kf >= 0 and store.kf_corner_valid[tracker.ref_kf].any():
            k = tracker.ref_kf
            result["lidar_corner"] = store.kf_corner[k][store.kf_corner_valid[k]]
            result["lidar_flat"] = store.kf_flat[k][store.kf_flat_valid[k]]
        return result

    # ------------------------------------------------------------------
    # Trajectory recovery + savers
    # ------------------------------------------------------------------

    def get_trajectory(self) -> np.ndarray:
        """Per-frame camera-to-world 4x4 poses, recovered as
        T_wc = (T_rel · T_ref_w)^{-1} with the *current* (BA/loop-corrected)
        reference keyframe poses (System.cc:503-560 semantics)."""
        self.tracker.flush()  # finalize any deferred (pipelined) frame
        out = []
        for frame_id, ref_kf, R_rel, t_rel in self.tracker.trajectory:
            R_ref = self.store.kf_R[ref_kf]
            t_ref = self.store.kf_t[ref_kf]
            R_cw = R_rel @ R_ref
            t_cw = R_rel @ t_ref + t_rel
            R_wc = R_cw.T
            t_wc = -R_cw.T @ t_cw
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = R_wc
            T[:3, 3] = t_wc
            out.append(T)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    def trajectory_frame_ids(self) -> np.ndarray:
        """Frame ids matching get_trajectory() rows. Lost frames record no
        trajectory entry (Tracking.cc:578-586 skips them), so callers must
        index ground truth by these ids rather than by row position."""
        self.tracker.flush()
        return np.asarray(
            [fid for fid, _, _, _ in self.tracker.trajectory], np.int64
        )

    def save_trajectory_kitti(self, path: str):
        """KITTI 3x4 row-major format (System::SaveTrajectoryKITTI)."""
        T = self.get_trajectory()
        with open(path, "w") as f:
            for P in T:
                row = P[:3].reshape(-1)
                f.write(" ".join(f"{x:.9e}" for x in row) + "\n")

    def save_trajectory_tum(self, path: str, timestamps=None):
        """TUM format: `t tx ty tz qx qy qz qw` (System.cc:364-499)."""
        from ..geometry import so3

        T = self.get_trajectory()
        with open(path, "w") as f:
            for i, P in enumerate(T):
                ts = timestamps[i] if timestamps is not None else float(i)
                q = np.asarray(so3.mat_to_quat(jnp.asarray(P[:3, :3])))  # w x y z
                t = P[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )
