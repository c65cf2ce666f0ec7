"""Worker entry point for multi-process distributed BA.

Each OS process runs:

    python -m sqrtlm_slam_tpu.parallel.mp_worker \
        --coordinator localhost:PORT --nproc N --pid I \
        [--devices-per-proc 2] [--out result.npz]

All workers build the SAME deterministic synthetic BA problem
(`eval.synthetic.make_ba_problem`), join the distributed runtime, and run the
full Nielsen-LM loop over the global mesh (`multiprocess.distributed_ba_lm`).
Process 0 writes the replicated result to `--out` so a test harness can
compare it against the single-process answer.

Workers run on the CPU platform only: this is test scaffolding for the
multi-process control plane (SURVEY §2.10 P7 / §5.8). On a GPU host one
process drives every card.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--poses", type=int, default=5)
    ap.add_argument("--landmarks", type=int, default=48)
    ap.add_argument("--obs-per-lm", type=int, default=5)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # Must land before the XLA backend client is created.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices_per_proc}"
        ).strip()

    from sqrtlm_slam_tpu.parallel import multiprocess

    multiprocess.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nproc,
        process_id=args.pid,
    )

    import jax
    import numpy as np

    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()

    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.optim import schur_bucketed

    flat, _ = make_ba_problem(
        seed=args.seed, P=args.poses, L=args.landmarks,
        obs_per_landmark=args.obs_per_lm,
    )
    b = schur_bucketed.from_flat(flat, K=args.obs_per_lm)

    mesh = multiprocess.global_mesh()
    out, chi2, n_acc = multiprocess.distributed_ba_lm(
        b, DEFAULT_CAM, mesh, num_iters=args.iters
    )

    print(
        f"[mp_worker {args.pid}/{args.nproc}] devices={len(jax.devices())} "
        f"(local {len(jax.local_devices())}) chi2={float(chi2):.4f} "
        f"accepted={int(n_acc)}/{args.iters}",
        flush=True,
    )

    if args.out and jax.process_index() == 0:
        np.savez(
            args.out,
            pose_R=np.asarray(out.pose_R),
            pose_t=np.asarray(out.pose_t),
            points=np.asarray(out.points),
            chi2=float(chi2),
            n_acc=int(n_acc),
            n_devices=len(jax.devices()),
        )
    # Leave the runtime cleanly so the coordinator does not flag a crash.
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
