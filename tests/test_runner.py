"""End-to-end CLI runner on a synthesized mini KITTI-layout dataset."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Camera -> velodyne basis (x_l = z_c, y_l = -x_c, z_l = -y_c).
R_CL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)


def make_mini_kitti(root, n_frames=8):
    from sqrtlm_slam_tpu.io.kitti import write_png_gray

    seq_dir = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq_dir, "image_0"))
    os.makedirs(os.path.join(seq_dir, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))

    cam = DEFAULT_CAM
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        P0 = f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
        P1 = f"P1: {cam.fx} 0 {cam.cx} {-cam.bf} 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
        Tr = "Tr: " + " ".join(
            str(x) for x in np.hstack([R_CL, np.zeros((3, 1))]).reshape(-1)
        ) + "\n"
        f.write(P0 + P1 + Tr)
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{i * 0.1:.6f}\n")

    world = SyntheticWorld(seed=2, n_points=1000)
    poses = forward_trajectory(n_frames, step=0.35)
    gt_lines = []
    for i, T in enumerate(poses):
        img, depth = world.render(T, cam)
        write_png_gray(
            os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
            np.asarray(img).astype(np.uint8),
        )
        # Backproject depth -> camera cloud -> velodyne frame -> .bin.
        d = np.asarray(depth)
        H, W = d.shape
        vs, us = np.mgrid[0:H:2, 0:W:2]
        z = d[::2, ::2].reshape(-1)
        sel = z > 0
        x = (us.reshape(-1)[sel] - cam.cx) * z[sel] / cam.fx
        y = (vs.reshape(-1)[sel] - cam.cy) * z[sel] / cam.fy
        p_c = np.stack([x, y, z[sel]], -1).astype(np.float32)
        p_l = p_c @ R_CL  # R_CL^T p_c
        rec = np.concatenate([p_l, np.ones((len(p_l), 1), np.float32)], -1)
        rec.tofile(os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))

        M = np.eye(4)
        M[:3, :3] = np.asarray(T.R)
        M[:3, 3] = np.asarray(T.t)
        T_wc = np.linalg.inv(M)
        gt_lines.append(" ".join(f"{v:.9e}" for v in T_wc[:3].reshape(-1)))
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")


@pytest.mark.slow
def test_runner_depth_mode(tmp_path):
    root = str(tmp_path / "kitti")
    os.makedirs(root)
    make_mini_kitti(root)
    out = str(tmp_path / "traj.txt")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "run_kitti.py", "--root", root, "--seq", "00",
         "--mode", "depth", "--out", out, "--max-features", "600", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=560,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["frames"] == 8
    assert result["ate_rmse_m"] < 0.3, result
    traj = np.loadtxt(out)
    assert traj.shape == (8, 12)
