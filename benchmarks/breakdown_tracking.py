"""Per-stage composition of the tracking hot path on the device.

Slope-timed (N reps inside one jit; PERF.md methodology) stages of one
tracked frame: frame build (ORB pyramid / blur+moments / descriptors /
depth association) and the fused track step (matching + pose LM). This is
the number that directs frontend kernel work — SURVEY §7.0 prescribes a
FAST/BRIEF kernel only if extraction dominates.

Run on a GPU:  python benchmarks/breakdown_tracking.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from sqrtlm_slam_tpu.utils.cache import configure_jax

configure_jax()

import numpy as np

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, SyntheticWorld, forward_trajectory
from sqrtlm_slam_tpu.frontend import orb
from sqrtlm_slam_tpu.pipeline import tracking as tr
from sqrtlm_slam_tpu.pipeline.frame import build_frame

if os.environ.get("SQRTLM_BREAKDOWN_RES", "") == "kitti":
    # Reference-resolution scene (1226x370, cfg/KITTI00-02.yaml geometry)
    # rendered by the textured-surface world — the shape the soak runs at.
    from sqrtlm_slam_tpu.eval.kitti_synth import (
        KITTI_BF, KITTI_CX, KITTI_CY, KITTI_FX, KITTI_FY, KITTI_H, KITTI_W,
    )
    from sqrtlm_slam_tpu.eval.planeworld import (
        circuit_trajectory, street_circuit_world,
    )
    from sqrtlm_slam_tpu.factors.reprojection import Camera

    CFG = orb.ORBConfig(max_features=2000)
    CAM = Camera(fx=KITTI_FX, fy=KITTI_FY, cx=KITTI_CX, cy=KITTI_CY,
                 bf=KITTI_BF)
    _pw = street_circuit_world(seed=0)
    T0 = circuit_trajectory(3)[0][2]
    IMG, DEPTH = _pw.render(T0, CAM, H=KITTI_H, W=KITTI_W)

    class _W:  # minimal stand-in for SyntheticWorld.points in m_track_step
        points = np.asarray(
            np.random.RandomState(0).uniform(-40, 40, size=(4000, 3)),
            np.float32,
        )

    world = _W()
else:
    CFG = orb.ORBConfig(max_features=1000)
    CAM = DEFAULT_CAM

    world = SyntheticWorld(seed=1, n_points=1200)
    T0 = forward_trajectory(2, step=0.3)[1]
    IMG, DEPTH = world.render(T0, CAM)


def slope(make_body, reps=(8, 40), n_timing=4):
    init, body, consume = make_body()

    @jax.jit
    def run(n, carry):
        return consume(jax.lax.fori_loop(0, n, lambda _, c: body(c), carry))

    times = {}
    for n in reps:
        nn = jnp.int32(n)
        jax.block_until_ready(run(nn, init))
        best = 1e9
        for _ in range(n_timing):
            t0 = time.perf_counter()
            jax.block_until_ready(run(nn, init))
            best = min(best, time.perf_counter() - t0)
        times[n] = best
    n0, n1 = reps
    return (times[n1] - times[n0]) / (n1 - n0) * 1e3


def eps_of(s):
    return 1.0 + jnp.sign(s) * 1e-6


def m_build_frame():
    # Consume EVERY output leaf: a partial consume lets XLA dead-code-
    # eliminate whole stages.
    def body(carry):
        img, s = carry
        f = build_frame(img, CAM, CFG, depth_img=DEPTH)
        s2 = (
            jnp.sum(f.kp.xy[:2]) + jnp.sum(f.depth[:2])
            + jnp.sum(f.kp.desc[0].astype(jnp.float32))
            + jnp.sum(f.kp.angle[:2]) + s * 0
        )
        return (img * eps_of(s2), s2)

    return (IMG, jnp.float32(0)), body, lambda c: c[1]


def _m_extract_consuming(consume):
    """Progressive-consumption measure: stage costs = DIFFERENCES between
    runs that consume successively more of the real extract graph (XLA
    dead-code-eliminates unconsumed stages), so every stage is timed in its
    true fusion context instead of a hand-rebuilt one."""

    def make():
        def body(carry):
            img, s = carry
            kp = orb.extract(img, CFG)
            s2 = consume(kp) + s * 0
            return (img * eps_of(s2), s2)

        return (IMG, jnp.float32(0)), body, lambda c: c[1]

    return make


m_extract = _m_extract_consuming(
    lambda kp: jnp.sum(kp.xy[:2])
    + jnp.sum(kp.desc[0].astype(jnp.float32))
    + jnp.sum(kp.angle[:2])
)
m_extract_fast_topk = _m_extract_consuming(lambda kp: jnp.sum(kp.xy[:2]))
m_extract_with_angle = _m_extract_consuming(
    lambda kp: jnp.sum(kp.xy[:2]) + jnp.sum(kp.angle[:2])
)


def m_fast_all_levels():
    from sqrtlm_slam_tpu.frontend.orb import fast_scores_dual, scale_factors

    scales = scale_factors(CFG)
    H, W = IMG.shape

    def body(carry):
        img, s = carry
        tot = s * 0
        for lvl in range(CFG.num_levels):
            img_l = img if lvl == 0 else jax.image.resize(
                img, (int(round(H / scales[lvl])), int(round(W / scales[lvl]))),
                method="linear",
            )
            hi, lo = fast_scores_dual(img_l, 20.0, 7.0)
            tot = tot + jnp.sum(hi[:2, :2]) + jnp.sum(lo[:2, :2])
        return (img * eps_of(tot), tot)

    return (IMG, jnp.float32(0)), body, lambda c: c[1]


def m_blur_moments_all_levels():
    from sqrtlm_slam_tpu.frontend.orb import _orientation_maps, gaussian_blur, scale_factors

    scales = scale_factors(CFG)
    H, W = IMG.shape

    def body(carry):
        img, s = carry
        tot = s * 0
        for lvl in range(CFG.num_levels):
            img_l = img if lvl == 0 else jax.image.resize(
                img, (int(round(H / scales[lvl])), int(round(W / scales[lvl]))),
                method="linear",
            )
            m10, m01 = _orientation_maps(img_l, CFG.patch_size)
            b = gaussian_blur(img_l)
            tot = tot + jnp.sum(m10[:2, :2]) + jnp.sum(m01[:2, :2]) + jnp.sum(b[:2, :2])
        return (img * eps_of(tot), tot)

    return (IMG, jnp.float32(0)), body, lambda c: c[1]


def m_track_step():
    frame = jax.jit(
        lambda img: build_frame(img, CAM, CFG, depth_img=DEPTH)
    )(IMG)
    M = 2048
    rng = np.random.RandomState(0)
    # Local map buffer at production capacity.
    lm = tr.LocalMapBuffer(
        ids=jnp.arange(M, dtype=jnp.int32),
        pos=jnp.asarray(world.points[rng.randint(0, len(world.points), M)]),
        desc=jnp.asarray(
            rng.randint(0, 2**32, size=(M, 8), dtype=np.uint64).astype(np.uint32)
        ),
        valid=jnp.ones(M, bool),
        max_dist=jnp.full(M, 40.0, jnp.float32),
    )
    cfgt = tr.TrackingConfig()

    def body(carry):
        pose_R, pose_t, vel, s = carry
        pose, velocity, pi, pf = tr.track_frame_step(
            tr.se3.SE3(pose_R, pose_t), vel, lm, frame, CAM,
            cfgt.match_radius_motion, cfgt.match_radius_local,
            cfgt.min_inliers_track, cfgt.close_depth,
        )
        s2 = pf[12] + s * 0
        e = eps_of(s2)
        return (pose.R * e, pose.t * e, velocity * e, s2)

    init = (T0.R, T0.t, jnp.zeros(6), jnp.float32(0))
    return init, body, lambda c: c[3]


def main():
    print(f"device={jax.devices()[0].platform}, img={IMG.shape}, "
          f"feats={CFG.max_features}, levels={CFG.num_levels}")
    for name, m in [
        ("build_frame (full, all leaves)", m_build_frame),
        ("  orb.extract (full)", m_extract),
        ("  extract: FAST+grid-topk only", m_extract_fast_topk),
        ("  extract: +moments/angle", m_extract_with_angle),
        ("track_frame_step (match+LM x2)", m_track_step),
    ]:
        print(f"{name:36s}: {slope(m):8.3f} ms", flush=True)
    print("(stage costs are DIFFERENCES between consume levels; "
          "blur+BRIEF = full - (+moments); moments = (+moments) - FAST)")


if __name__ == "__main__":
    main()
