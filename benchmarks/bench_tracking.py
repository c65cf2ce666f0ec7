"""Tracked frames/s benchmark on the synthetic world (per-device metric).

The BASELINE.md protocol asks for "tracked frames/s per device" alongside BA
iters/s. Runs the full per-frame path (frame build -> match -> pose opt)
over pre-rendered frames, excluding jit warm-up.

Usage: python benchmarks/bench_tracking.py [--frames 30]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local mapping on the background worker "
                         "(the reference's 3-thread pipeline) — measures "
                         "tracking-thread latency only")
    args = ap.parse_args()

    import jax
    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()

    from sqrtlm_slam_tpu.eval.synthetic import (
        DEFAULT_CAM, SyntheticWorld, forward_trajectory,
    )
    from sqrtlm_slam_tpu.frontend import orb
    from sqrtlm_slam_tpu.pipeline.system import SlamSystem, SystemConfig

    world = SyntheticWorld(seed=1, n_points=1200)
    poses = forward_trajectory(args.frames, step=0.3)
    frames = [world.render(T, DEFAULT_CAM) for T in poses]

    s = SlamSystem(
        DEFAULT_CAM,
        SystemConfig(
            orb=orb.ORBConfig(max_features=args.features),
            async_mapping=args.async_mapping,
        ),
    )
    # Warm-up on the first few frames (compiles all stages incl. KF path).
    warm = min(5, len(frames))
    for img, depth in frames[:warm]:
        s.track_depth(img, depth)

    import numpy as np

    times = []
    tracked = 0
    for img, depth in frames[warm:]:
        t0 = time.perf_counter()
        if s.track_depth(img, depth) is not None:
            tracked += 1
        times.append(time.perf_counter() - t0)
    n = len(frames) - warm
    s.flush()
    med = float(np.median(times))
    # Median per-frame time is robust to one-off jit compiles mid-run
    # (keyframe-path shapes compile on first use); mean includes them.
    print(json.dumps({
        "metric": "tracked_frames_per_s",
        "value": round(1.0 / med, 2),
        "median_ms": round(med * 1e3, 1),
        "p90_ms": round(float(np.percentile(times, 90)) * 1e3, 1),
        "mean_ms": round(float(np.mean(times)) * 1e3, 1),
        "frames": n,
        "tracked": tracked,
        "device": jax.devices()[0].platform,
        "async_mapping": args.async_mapping,
    }))


if __name__ == "__main__":
    main()
