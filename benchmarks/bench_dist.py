"""Distributed-BA scaling benchmark over a device mesh.

Measures LM iterations/s of the landmark-sharded distributed BA
(parallel/dist_ba.py) at mesh sizes 1/2/4/8 — the BASELINE.md north-star
protocol ("distributed BA >= 3x frames/s at 4 devices"). Under
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu the
same code validates the scaling shape on one host (no real speedup expected
— virtual devices share cores; the numbers to report come from GPU runs).

Usage:  python benchmarks/bench_dist.py [--poses 64] [--landmarks 16384]
Prints one JSON line per mesh size.
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
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=16384)
    ap.add_argument("--obs-per-landmark", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax

    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()
    import numpy as np
    from jax.sharding import Mesh

    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.parallel import dist_ba

    from sqrtlm_slam_tpu.optim import schur_bucketed

    devs = jax.devices()
    flat, _ = make_ba_problem(
        seed=0, P=args.poses, L=args.landmarks,
        obs_per_landmark=args.obs_per_landmark,
    )
    b = schur_bucketed.from_flat(flat, args.obs_per_landmark)
    sizes = [s for s in (1, 2, 4, 8) if s <= len(devs)]
    base = None
    for n in sizes:
        mesh = Mesh(np.array(devs[:n]), axis_names=("ba",))
        sharded, _ = dist_ba.partition_bucketed(b, n)
        # Production path: the full Nielsen-LM loop in one dispatch.
        iterate = dist_ba.make_bucketed_lm_iterate(
            mesh, DEFAULT_CAM, num_iters=args.iters
        )
        out, chi2, n_acc = iterate(sharded)  # compile
        chi2.block_until_ready()
        n_calls = 3
        t0 = time.perf_counter()
        s = sharded
        for _ in range(n_calls):
            s, chi2, n_acc = iterate(s)
        chi2.block_until_ready()
        dt = time.perf_counter() - t0
        iters_s = n_calls * args.iters / dt
        if base is None:
            base = iters_s
        print(json.dumps({
            "mesh": n,
            "lm_iters_per_s": round(iters_s, 2),
            "speedup_vs_1": round(iters_s / base, 2),
            "accepted": int(n_acc),
            "chi2": float(chi2),
        }), flush=True)


if __name__ == "__main__":
    main()
