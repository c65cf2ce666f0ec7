"""Deterministically (re)train the shipped ORB vocabulary asset.

The reference loads a pre-trained ~1M-word ORBvoc binary at startup
(/root/reference/src/System.cc:109, k=10 depth=6 trained on external
imagery). This repo's substitute is trained ON-DOMAIN: ORB descriptors are
extracted from many synthetic frames (the worlds the framework is evaluated
on — rings and forward corridors across several seeds), then hierarchical
binary k-medians builds a k=10, depth=4 tree (10^4 words). All seeds are
fixed, so `python scripts/train_vocab.py` regenerates the identical asset
at sqrtlm_slam_tpu/assets/orbvoc_synth_k10_d4.npz.

Usage: JAX_PLATFORMS=cpu python scripts/train_vocab.py [--depth 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def collect_descriptors(frames_per_traj: int = 24, max_features: int = 600):
    import numpy as np

    from sqrtlm_slam_tpu.eval.synthetic import (
        DEFAULT_CAM, SyntheticWorld, forward_trajectory, ring_trajectory,
        ring_world,
    )
    from sqrtlm_slam_tpu.frontend import orb
    from sqrtlm_slam_tpu.pipeline.frame import build_frame_jit

    cfg = orb.ORBConfig(max_features=max_features)
    chunks = []
    t0 = time.time()
    scenarios = []
    for seed in range(4):
        scenarios.append(
            (ring_world(seed=seed, n_points=2500),
             ring_trajectory(frames_per_traj, frac=1.0))
        )
        scenarios.append(
            (SyntheticWorld(seed=10 + seed, n_points=1400),
             forward_trajectory(frames_per_traj, step=0.5))
        )
    for wi, (world, poses) in enumerate(scenarios):
        for T in poses:
            img, _ = world.render(T, DEFAULT_CAM)
            frame = build_frame_jit(img, DEFAULT_CAM, cfg)
            desc = np.asarray(frame.kp.desc)
            valid = np.asarray(frame.kp.valid)
            chunks.append(desc[valid])
        print(
            f"[train_vocab] scenario {wi + 1}/{len(scenarios)}: "
            f"{sum(len(c) for c in chunks)} descriptors ({time.time() - t0:.0f}s)",
            flush=True,
        )
    return np.concatenate(chunks, axis=0)


def collect_descriptors_kitti(
    root: str, seq: str = "00", every: int = 1, max_features: int = 2000
):
    """Collect descriptors from a KITTI-layout image directory (the actual
    evaluation domain — reference trains ORBvoc on external imagery of the
    target domain class, System.cc:109). Extraction runs on whatever device
    is active."""
    import jax
    import numpy as np

    from sqrtlm_slam_tpu.frontend import orb
    from sqrtlm_slam_tpu.io.kitti import read_image

    img_dir = os.path.join(root, "sequences", seq, "image_0")
    names = sorted(os.listdir(img_dir))[::every]
    cfg = orb.ORBConfig(max_features=max_features)
    chunks = []
    t0 = time.time()
    extract = jax.jit(orb.extract, static_argnames=("cfg",))
    for i, name in enumerate(names):
        img = read_image(os.path.join(img_dir, name))
        kp = extract(img, cfg)
        desc = np.asarray(kp.desc)
        valid = np.asarray(kp.valid)
        chunks.append(desc[valid])
        if (i + 1) % 100 == 0:
            print(
                f"[train_vocab] {i + 1}/{len(names)} frames, "
                f"{sum(len(c) for c in chunks)} descriptors "
                f"({time.time() - t0:.0f}s)", flush=True,
            )
    return np.concatenate(chunks, axis=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kitti-root", default=None,
                    help="collect from a KITTI-layout sequence instead of "
                         "the billboard worlds")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--save-descs", default=None,
                    help="also save the collected descriptor corpus (npz)")
    ap.add_argument("--load-descs", default=None,
                    help="reuse a saved descriptor corpus")
    args = ap.parse_args()

    from sqrtlm_slam_tpu.frontend import vocab
    import numpy as np

    if args.load_descs:
        descs = np.load(args.load_descs)["descs"]
    elif args.kitti_root:
        descs = collect_descriptors_kitti(
            args.kitti_root, seq=args.seq, every=args.every
        )
    else:
        descs = collect_descriptors()
    if args.save_descs:
        np.savez_compressed(args.save_descs, descs=descs)
    print(f"[train_vocab] training k={args.k} depth={args.depth} on "
          f"{len(descs)} descriptors", flush=True)
    t0 = time.time()
    voc = vocab.train(descs, k=args.k, depth=args.depth, iters=args.iters, seed=0)
    out = args.out or os.path.normpath(vocab.DEFAULT_ASSET)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    vocab.save(voc, out)
    import numpy as np

    words = np.asarray(
        vocab.assign_words(voc, descs[:20000], np.ones(min(len(descs), 20000), bool))
    )
    used = len(np.unique(words))
    print(
        f"[train_vocab] done in {time.time() - t0:.0f}s -> {out} "
        f"({voc.num_words} words, {used} used by a 20k sample, "
        f"{os.path.getsize(out) / 1e6:.1f} MB)"
    )


if __name__ == "__main__":
    main()
