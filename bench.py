"""Headline benchmark: local-BA LM iterations/second on the Schur engine.

Prints the headline JSON line {"metric", "value", "unit", "vs_baseline",
"device"} as the last line of stdout; the tracked-frames/s metric and the
device description go to stderr. The problem size mirrors the reference's
local BA regime (~10^2 poses, ~10^4 landmarks, ~10^4+ observation edges,
/root/reference/src/backend/g2oOptimizer.cc:704-1191; SURVEY.md §3.2 calls
it the hottest backend loop).

Runs on a GPU only: with no GPU it exits non-zero instead of measuring the
CPU. Any failed phase exits non-zero.

Baseline: the reference publishes no numbers (BASELINE.md). `BASELINE_ITERS_S`
is the reference-regime estimate recorded there: g2o local BA at this scale
runs ~15 LM iterations in ~200-400 ms on a desktop CPU => ~50 iters/s.
vs_baseline = value / 50.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

from sqrtlm_slam_tpu.utils.cache import configure_jax

configure_jax()

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem  # noqa: E402
from sqrtlm_slam_tpu.optim import schur_bucketed  # noqa: E402
from sqrtlm_slam_tpu.utils.device import card_info  # noqa: E402

BASELINE_ITERS_S = 50.0

# Reference local-BA regime: ~10^2 poses, ~10^4 landmarks, ~10^4+ edges with
# sparse covisibility (SURVEY.md §3.2 — each landmark is seen by a handful
# of consecutive keyframes, NOT by every pose).
P, L, OBS_PER_LM = 96, 8192, 5
ITERS_PER_CALL = 15


def describe_device() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name and
    power limit from nvidia-smi. Fails when there is no GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {devices[0].platform!r}")
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card_info(),
    }


def measure_engine(problem) -> float:
    """Sustained LM iters/s: calls are chained (each solve consumes the
    previous solution, like consecutive local-BA invocations in the
    pipeline), the host waits once at the end with block_until_ready, and
    the best of SQRTLM_BENCH_REPEATS (default 3) timing loops is kept."""

    @jax.jit
    def ba_step(prob):
        out, chi2, _ = schur_bucketed.ba_iterate(
            prob, DEFAULT_CAM, prob.obs_valid, ITERS_PER_CALL, robust_delta=2.447
        )
        return out, chi2

    jax.block_until_ready(ba_step(problem))  # compile

    n_calls = 5
    repeats = int(os.environ.get("SQRTLM_BENCH_REPEATS", "3"))
    best_dt = float("inf")
    for rep in range(repeats):
        t0 = time.perf_counter()
        out = problem
        for _ in range(n_calls):
            out, chi2 = ba_step(out)
        jax.block_until_ready((out, chi2))
        dt = time.perf_counter() - t0
        best_dt = min(best_dt, dt)
        print(
            f"[bench] rep={rep} poses={P} landmarks={L} "
            f"{n_calls}x{ITERS_PER_CALL} LM iters in {dt:.4f}s "
            f"chi2 -> {float(chi2):.1f}",
            file=sys.stderr,
        )
    return n_calls * ITERS_PER_CALL / best_dt


def bench_tracking(n_frames: int = 24) -> dict:
    """Tracked frames/s on the 240x320 synthetic depth scene (sync mode):
    median per-frame wall time after 5 warm-up frames."""
    import numpy as np

    from sqrtlm_slam_tpu.eval.synthetic import SyntheticWorld, forward_trajectory
    from sqrtlm_slam_tpu.frontend import orb
    from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig

    world = SyntheticWorld(seed=1, n_points=1200)
    poses = forward_trajectory(n_frames, step=0.3)
    frames = [world.render(T, DEFAULT_CAM) for T in poses]
    s = SlamSystem(DEFAULT_CAM, SystemConfig(orb=orb.ORBConfig(max_features=1000)))
    warm = 5
    for img, depth in frames[:warm]:
        s.track_depth(img, depth)
    times = []
    tracked = 0
    for img, depth in frames[warm:]:
        t0 = time.perf_counter()
        tracked += s.track_depth(img, depth) is not None
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {
        "metric": "tracked_frames_per_s",
        "value": 1.0 / med,
        "unit": "frames/s",
        "median_ms": med * 1e3,
        "frames": len(times),
        "tracked": tracked,
    }


def main():
    device = describe_device()
    print(f"[bench] device: {json.dumps(device)}", file=sys.stderr)
    flat, _ = make_ba_problem(
        seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=OBS_PER_LM
    )
    problem = schur_bucketed.from_flat(flat, OBS_PER_LM)
    iters_s = measure_engine(problem)
    tracking = bench_tracking()
    tracking["device"] = device
    print(json.dumps(tracking), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "local_ba_lm_iters_per_s",
                "value": iters_s,
                "unit": "iters/s",
                "vs_baseline": iters_s / BASELINE_ITERS_S,
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
