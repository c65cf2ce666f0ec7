"""Multi-process distribution layer: ≥2 OS processes via jax.distributed.

The reference is single-process (SURVEY §2.10 P7); this is the
multi-process control plane the framework adds. The test spawns two REAL OS
processes (each with 2 virtual CPU devices → a 4-device global mesh over
gloo collectives), runs the full distributed Nielsen-LM across them, and
checks the result against the single-process engine on the same problem.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Problem shape shared by the workers (mp_worker defaults) and the reference.
POSES, LANDMARKS, OBS_PER_LM, ITERS, SEED = 5, 48, 5, 6, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env(devices_per_proc: int) -> dict:
    env = dict(os.environ)
    # The parent test process pins an 8-device CPU topology; workers need
    # their own (2 devices each) and must not inherit the parent's flags.
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("SQRTLM_TEST_GPU", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch_workers(nproc: int, out_path: str, devices_per_proc: int = 2):
    port = _free_port()
    procs = []
    for pid in range(nproc):
        cmd = [
            sys.executable, "-m", "sqrtlm_slam_tpu.parallel.mp_worker",
            "--coordinator", f"localhost:{port}",
            "--nproc", str(nproc), "--pid", str(pid),
            "--devices-per-proc", str(devices_per_proc),
            "--poses", str(POSES), "--landmarks", str(LANDMARKS),
            "--obs-per-lm", str(OBS_PER_LM), "--iters", str(ITERS),
            "--seed", str(SEED),
        ]
        if pid == 0:
            cmd += ["--out", out_path]
        procs.append(
            subprocess.Popen(
                cmd, cwd=REPO, env=_worker_env(devices_per_proc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out)
    return [p.returncode for p in procs], outputs


def _single_process_reference():
    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.optim import schur_bucketed as sb

    flat, _ = make_ba_problem(
        seed=SEED, P=POSES, L=LANDMARKS, obs_per_landmark=OBS_PER_LM
    )
    b = sb.from_flat(flat, K=OBS_PER_LM)
    ref, chi2_ref, acc_ref = sb.ba_iterate(
        b, DEFAULT_CAM, b.obs_valid, ITERS, robust_delta=None
    )
    return ref, float(chi2_ref), int(acc_ref)


def test_two_process_lm_matches_single_process(tmp_path):
    """2 OS processes × 2 devices: distributed Nielsen-LM across process
    boundaries must match the single-process engine on the same problem."""
    out_path = str(tmp_path / "mp_result.npz")
    rcs, outputs = _launch_workers(2, out_path)
    assert rcs == [0, 0], "worker failed:\n" + "\n---\n".join(outputs)
    assert os.path.exists(out_path), outputs[0]

    got = np.load(out_path)
    assert int(got["n_devices"]) == 4  # 2 processes x 2 devices

    ref, chi2_ref, acc_ref = _single_process_reference()
    # Same gates as the in-process mesh test (test_dist_ba): psum
    # reassociation may flip one marginal accept.
    assert abs(int(got["n_acc"]) - acc_ref) <= 1
    np.testing.assert_allclose(float(got["chi2"]), chi2_ref, rtol=0.05)
    np.testing.assert_allclose(
        got["pose_t"], np.asarray(ref.pose_t), atol=5e-3
    )
    np.testing.assert_allclose(
        got["points"], np.asarray(ref.points), atol=2e-2
    )


@pytest.mark.slow
def test_four_process_lm(tmp_path):
    """4 processes × 1 device each — the pure-DCN layout (every collective
    crosses a process boundary)."""
    out_path = str(tmp_path / "mp4_result.npz")
    rcs, outputs = _launch_workers(4, out_path, devices_per_proc=1)
    assert rcs == [0, 0, 0, 0], "worker failed:\n" + "\n---\n".join(outputs)
    got = np.load(out_path)
    assert int(got["n_devices"]) == 4
    _, chi2_ref, acc_ref = _single_process_reference()
    assert abs(int(got["n_acc"]) - acc_ref) <= 1
    np.testing.assert_allclose(float(got["chi2"]), chi2_ref, rtol=0.05)
