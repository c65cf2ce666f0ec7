#!/usr/bin/env python
"""KITTI sequence runner — CLI replacing the reference's three ROS nodes.

Covers `fusion_slam` (visual-LiDAR SLAM), `lidar_slam` (LOAM-style odometry)
and `kittiHelper` (dataset feeding) from /root/reference/Node/ in one
ROS-free command:

    python run_kitti.py --root /data/kitti --seq 04 --mode fusion \
        --out traj_04.txt [--loop] [--frames N] [--checkpoint map.npz]

Modes:
    fusion  — ORB tracking + LiDAR depth + tight coupling (TrackFusion path)
    depth   — ORB + LiDAR depth image only (no tight coupling)
    mono    — monocular (two-view init, triangulated landmarks)
    lidar   — standalone LiDAR odometry (art::Odom path)

Ends by writing the KITTI-format trajectory (System::SaveTrajectoryKITTI
parity) and printing evo-style ATE RMSE vs ground truth when available,
plus a per-stage timing table (SURVEY §5.1/§6 measurement protocol).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    """Run one sequence; `argv` defaults to the command line. Returns the
    JSON summary dict (also printed with --json)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--seq", default="04")
    ap.add_argument("--mode", default="fusion",
                    choices=["fusion", "depth", "mono", "lidar"])
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--loop", action="store_true", help="enable loop closing")
    ap.add_argument("--checkpoint", default=None, help="save map here at end")
    ap.add_argument("--resume", default=None, help="resume from map checkpoint")
    ap.add_argument("--max-features", type=int, default=2000)
    ap.add_argument("--max-keyframes", type=int, default=1200)
    ap.add_argument("--max-landmarks", type=int, default=400000)
    ap.add_argument(
        "--async-mapping", action="store_true",
        help="local mapping + loop closing on a background worker thread "
             "(the reference's 3-pthread pipeline, System.cc:139-154)",
    )
    ap.add_argument(
        "--pipelined", action="store_true",
        help="deferred-fetch pipelined tracking (frame t's fetch overlaps "
             "frame t+1's dispatch)",
    )
    ap.add_argument("--json", action="store_true", help="print one JSON summary line")
    ap.add_argument("--plot", default=None, help="write top-down trajectory PNG here")
    ap.add_argument(
        "--viz-every", type=int, default=0, metavar="N",
        help="write an incremental SLAM-state snapshot PNG every N frames "
             "(<plot-or-out stem>_live.png — the headless equivalent of the "
             "reference's live rviz Visualization() thread)",
    )
    ap.add_argument("--profile", default=None,
                    help="capture a jax.profiler trace into this directory")
    args = ap.parse_args(argv)

    import jax
    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()
    import jax.numpy as jnp

    from sqrtlm_slam_tpu.eval.ate import ate_rmse
    from sqrtlm_slam_tpu.io import kitti
    from sqrtlm_slam_tpu.utils import StageTimer, kitti_sequence_config

    seq = kitti.KittiSequence(args.root, args.seq)
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))
    cfg_seq = kitti_sequence_config(args.seq)
    timer = StageTimer()

    # Native prefetching loader (C++ thread pool) when built; IO overlaps
    # the device compute of the previous frame.
    native = None
    try:
        from sqrtlm_slam_tpu.io.native_loader import NativeKittiLoader

        if NativeKittiLoader.available():
            native = NativeKittiLoader(
                seq.image_dir if args.mode != "lidar" else None,
                seq.velo_dir, n,
            )
            native.prefetch(0)
            print("[io] native prefetching loader active", file=sys.stderr)
    except Exception as e:  # fall back to Python IO
        print(f"[io] native loader unavailable: {e}", file=sys.stderr)

    def load_frame(i):
        if native is not None:
            native.prefetch(i)
            img_np, velo_np = native.frame(i)
            return img_np, velo_np
        return (
            seq.image(i) if args.mode != "lidar" else None,
            seq.velodyne(i),
        )

    import contextlib

    prof_ctx = (
        jax.profiler.trace(args.profile) if args.profile else contextlib.nullcontext()
    )
    prof_ctx.__enter__()

    if args.mode == "lidar":
        from sqrtlm_slam_tpu.lidar.odometry import LidarOdometry, OdomConfig

        odo = LidarOdometry(OdomConfig(), cfg_seq.lidar)
        poses = []
        for i in range(n):
            with timer.stage("io"):
                _, velo = load_frame(i)
            with timer.stage("lidar_odometry"):
                T = odo.process(jnp.asarray(velo[:, :3]))
            poses.append(np.asarray(_se3_to_mat_inv(T)))
        est = np.stack(poses)
        est_ids = np.arange(len(est))
    else:
        from sqrtlm_slam_tpu.frontend.orb import ORBConfig
        from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig

        sys_cfg = SystemConfig(
            orb=ORBConfig(max_features=args.max_features),
            tracking=cfg_seq.tracking._replace(pipelined=args.pipelined),
            loop_detection=args.loop,
            lidar=cfg_seq.lidar if args.mode == "fusion" else None,
            max_keyframes=args.max_keyframes,
            max_landmarks=args.max_landmarks,
            async_mapping=args.async_mapping,
        )
        if args.resume:
            slam = SlamSystem.load(args.resume, seq.calib.cam, sys_cfg)
        else:
            slam = SlamSystem(seq.calib.cam, sys_cfg)
        T_cl = (
            jnp.asarray(seq.calib.T_cam_velo[:3, :3]),
            jnp.asarray(seq.calib.T_cam_velo[:3, 3]),
        )
        tracked = 0
        for i in range(n):
            with timer.stage("io"):
                img_np, velo_np = load_frame(i)
                img = jnp.asarray(img_np)
            if args.mode == "mono":
                with timer.stage("track"):
                    p = slam.track_monocular(img)
            elif args.mode == "depth":
                with timer.stage("track"):
                    from sqrtlm_slam_tpu.pipeline.frame import (
                        project_cloud_to_depth_image,
                    )

                    from sqrtlm_slam_tpu.lidar.features import pad_cloud

                    T = seq.calib.T_cam_velo
                    cloud = pad_cloud(
                        velo_np[:, :3] @ T[:3, :3].T + T[:3, 3]
                    )
                    depth = project_cloud_to_depth_image(
                        cloud, seq.calib.cam, img.shape[0], img.shape[1]
                    )
                    p = slam.track_depth(img, depth)
            else:  # fusion
                with timer.stage("track"):
                    p = slam.track_fusion(
                        img, jnp.asarray(velo_np[:, :3]), T_cam_lidar=T_cl
                    )
            tracked += p is not None
            if (i + 1) % 50 == 0:
                print(
                    f"[{args.seq}] frame {i+1}/{n} tracked={tracked} "
                    f"kfs={slam.num_keyframes()} lms={slam.num_landmarks()}",
                    file=sys.stderr,
                )
            if args.viz_every > 0 and (i + 1) % args.viz_every == 0:
                # Live visualization stream (fusionsystem.cc:224-586 parity,
                # headless): overwrite one snapshot so a viewer polling the
                # file sees the map grow during the run.
                from sqrtlm_slam_tpu.eval.plot import render_slam_result

                stem = (args.plot or args.out or f"viz_{args.seq}").rsplit(".", 1)[0]
                try:
                    render_slam_result(
                        slam.get_slam_result(), stem + "_live.png",
                        gt=seq.gt_poses[: i + 1] if seq.gt_poses is not None else None,
                    )
                except Exception as e:
                    print(f"[viz] snapshot failed: {e}", file=sys.stderr)
        slam.shutdown()  # drain async mapping/GBA before any state read
        est = slam.get_trajectory()
        est_ids = slam.trajectory_frame_ids()
        if args.checkpoint:
            slam.save(args.checkpoint)
        print(f"tracked {tracked}/{n} frames", file=sys.stderr)

    prof_ctx.__exit__(None, None, None)
    if args.profile:
        print(f"profiler trace -> {args.profile} (view with xprof/tensorboard)",
              file=sys.stderr)

    out = args.out or f"traj_{args.seq}_{args.mode}.txt"
    kitti.write_kitti_poses(out, est)
    print(f"trajectory -> {out}", file=sys.stderr)

    if args.plot:
        from sqrtlm_slam_tpu.eval.plot import plot_trajectory

        lms = None
        if args.mode != "lidar":
            sel = slam.store.lm_valid[: slam.store.num_lm]
            lms = slam.store.lm_pos[: slam.store.num_lm][sel]
        plot_trajectory(
            args.plot, est,
            gt=seq.gt_poses[est_ids] if seq.gt_poses is not None else None,
            landmarks=lms, title=f"KITTI {args.seq} ({args.mode})",
        )
        print(f"plot -> {args.plot}", file=sys.stderr)
        if args.mode != "lidar":
            from sqrtlm_slam_tpu.eval.plot import render_slam_result

            snap_path = args.plot.rsplit(".", 1)[0] + "_snapshot.png"
            render_slam_result(
                slam.get_slam_result(), snap_path,
                gt=seq.gt_poses[: len(est)] if seq.gt_poses is not None else None,
            )
            print(f"slam-result snapshot -> {snap_path}", file=sys.stderr)

    import resource

    result = {"seq": args.seq, "mode": args.mode, "frames": int(n)}
    result["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
    )
    if args.mode != "lidar":
        result["tracked"] = int(tracked)
        result["keyframes"] = int(slam.num_keyframes())
        result["landmarks"] = int(slam.num_landmarks())
        if slam.loop_closer is not None:
            result["loops_closed"] = int(slam.loop_closer.num_loops_closed)
    stage = "lidar_odometry" if args.mode == "lidar" else "track"
    track_s = timer.totals.get(stage, 0.0)
    if track_s > 0:
        result["frames_per_s"] = round(n / track_s, 2)
    if seq.gt_poses is not None and len(est):
        # Align by recorded frame ids: lost frames record no trajectory
        # entry, so positional slicing would skew the metric (same fix as
        # eval/longrun.py).
        gt = seq.gt_poses[est_ids]
        rmse, _ = ate_rmse(est, gt, align_scale=(args.mode == "mono"))
        result["ate_rmse_m"] = round(float(rmse), 4)
        print(f"ATE RMSE ({'Sim3' if args.mode == 'mono' else 'SE3'}-aligned): "
              f"{rmse:.4f} m", file=sys.stderr)
    print(timer.summary(), file=sys.stderr)
    if args.json:
        print(json.dumps(result))
    return result


def _se3_to_mat_inv(T):
    import numpy as np

    M = np.eye(4)
    M[:3, :3] = np.asarray(T.R)
    M[:3, 3] = np.asarray(T.t)
    return np.linalg.inv(M)


if __name__ == "__main__":
    main()
