"""Place-recognition precision/recall on a checkpointed map store, per
vocabulary asset.

Re-assigns BoW words for every keyframe from its STORED descriptors under
each candidate vocabulary, rebuilds the KeyFrameDatabase, and measures
DetectLoopCandidates precision/recall against ground-truth revisits
(the detection stage of /root/reference/src/backend/KeyFrameDatabase.cc:104-263,
ahead of geometric verification) — the comparison protocol for choosing the
shipped vocabulary scale (System.cc:109 loads a k=10 d=6 ~10^6-word ORBvoc).

Usage:
    python scripts/eval_pr.py --checkpoint soak_map.npz \
        --poses /root/kitti_synth_1k/poses/00.txt \
        --vocab sqrtlm_slam_tpu/assets/orbvoc_synth_k10_d4.npz [--vocab ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reassign_bow(store, voc):
    """Recompute kf_words/kf_bow for all valid keyframes under `voc`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sqrtlm_slam_tpu.frontend import vocab as vocab_mod

    K = store.num_kf
    store.kf_bow = np.zeros((store.kf_bow.shape[0], voc.num_words), np.float32)
    assign = jax.jit(
        lambda d, v: (lambda w: (w, vocab_mod.bow_vector(voc, w)))(
            vocab_mod.assign_words(voc, d, v)
        )
    )
    for k in range(K):
        if not store.kf_valid[k]:
            continue
        words, bow = jax.device_get(
            assign(
                jnp.asarray(store.kf_desc[k]), jnp.asarray(store.kf_kp_valid[k])
            )
        )
        n = store.kf_words.shape[1]
        store.kf_words[k, :n] = words[:n]
        store.kf_bow[k] = bow


def eval_pr(store, centers_by_frame, min_gap=100, dist_thresh=6.0):
    """Precision/recall of the detection stage over genuine revisits."""
    import numpy as np

    from sqrtlm_slam_tpu.loop.database import KeyFrameDatabase

    db = KeyFrameDatabase(store)
    kfs = np.where(store.kf_valid[: store.num_kf])[0]
    frame_ids = store.kf_frame_id[kfs]
    centers = centers_by_frame[frame_ids]
    idx_of = {int(k): i for i, k in enumerate(kfs)}

    d = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    gap = np.abs(frame_ids[:, None] - frame_ids[None, :])
    true_pair = (d < dist_thresh) & (gap > min_gap)

    n_query = n_ret = n_ret_correct = n_recalled = 0
    t0 = time.time()
    for i, kf in enumerate(kfs):
        if not true_pair[i].any():
            continue
        n_query += 1
        min_score = db.min_covisible_score(int(kf))
        cand = db.detect_loop_candidates(int(kf), min_score)
        cand = [c for c in cand if int(c) in idx_of]
        correct = [c for c in cand if true_pair[i, idx_of[int(c)]]]
        n_ret += len(cand)
        n_ret_correct += len(correct)
        n_recalled += bool(correct)
    return {
        "keyframes": int(len(kfs)),
        "pr_queries": n_query,
        "pr_returned": n_ret,
        "pr_precision": round(n_ret_correct / max(n_ret, 1), 4),
        "pr_recall": round(n_recalled / max(n_query, 1), 4),
        "query_s": round((time.time() - t0) / max(n_query, 1), 4),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--poses", required=True, help="KITTI gt poses txt")
    ap.add_argument("--vocab", action="append", required=True)
    ap.add_argument("--min-gap", type=int, default=100)
    ap.add_argument("--dist-thresh", type=float, default=6.0)
    args = ap.parse_args()

    import numpy as np

    from sqrtlm_slam_tpu.frontend import vocab as vocab_mod
    from sqrtlm_slam_tpu.mapstore.checkpoint import load_map

    store, _ = load_map(args.checkpoint)
    # KITTI gt rows are 3x4 cam-to-world; camera centre is the translation.
    P = np.loadtxt(args.poses).reshape(-1, 3, 4)
    centers = P[:, :, 3]

    for path in args.vocab:
        voc = vocab_mod.load(path)
        t0 = time.time()
        reassign_bow(store, voc)
        out = eval_pr(
            store, centers, min_gap=args.min_gap, dist_thresh=args.dist_thresh
        )
        out.update(
            vocab=os.path.basename(path), words=int(voc.num_words),
            depth=int(voc.depth), reassign_s=round(time.time() - t0, 1),
        )
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
