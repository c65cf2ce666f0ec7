"""KITTI-layout fusion e2e at REFERENCE resolution and gates.

Generates a short textured-surface (planeworld) sequence at the reference's
1226x370 KITTI 00-02 geometry (cfg/KITTI00-02.yaml) and drives it through
`run_kitti.py --mode fusion` — the same CLI + native-loader + SlamSystem
path as the long soak — with the DEFAULT reference-strength thresholds
(min_inliers_local=30, Tracking.cc:1648). This is the matchable-image-domain
guard the billboard-renderer e2e tests could not provide: the textured
renderer must keep every frame tracked without lowering any gate.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_kitti_layout_fusion_reference_gates(tmp_path):
    from sqrtlm_slam_tpu.eval.kitti_synth import generate

    root = str(tmp_path / "kitti")
    n = 30
    generate(root, seq="00", n_frames=n, seed=0, step=0.8, log=lambda *a: None)

    out = str(tmp_path / "traj.txt")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "run_kitti.py"),
            "--root", root, "--seq", "00", "--mode", "fusion",
            "--frames", str(n), "--out", out, "--json",
        ],
        capture_output=True, text=True, env=env, timeout=3600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # Reference gates, no concessions: every frame must track.
    assert summary["tracked"] == n, summary
    assert summary["ate_rmse_m"] < 0.5, summary
    assert summary["keyframes"] >= 2, summary
