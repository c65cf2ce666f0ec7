#!/usr/bin/env python
"""Smoke test of the SLAM system on one GPU: the quickest proof that the
main path still starts, compiles and computes the right thing on the card.

    python chip_smoke.py          # one GPU, every phase below
    python chip_smoke.py --four   # four GPUs: distributed BA only

Phases (one process, since a JAX process reserves most of the card):

1. device      platform must be "gpu"; prints the card's name and power limit
2. kernels     each hot op compiled for the card against a plain reference run
               on the CPU, at real widths: the ORB Hamming matrix, the
               local-BA reductions, and the 15-iteration local-BA LM loop
3. main path   a 30-frame 1226x370 KITTI-layout sequence with a 64-beam
               cloud (eval/kitti_synth.py, seed 0) through
               `run_kitti.main(["--mode", "fusion", ...])`, with the gates of
               tests/test_planeworld_fusion.py
4. global BA   the loop-closing PCG engine against the flat engine on the
               CPU, then at the 600-KF / 1.2e5-landmark map scale

Any failure exits non-zero before the last line. The last line of standard
output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SMOKE_DATA = os.path.join(REPO, ".smoke_data")  # gitignored

# Tolerances, each relative to the reference output's largest magnitude.
TOL_REDUCTIONS = 1e-5  # f32 sums of the same terms in another order
# The LM loops below run 15 iterations; by the last ones chi2 has converged
# and a step changes it by about its f32 rounding (~1e-3 on ~8e3), so the
# two engines' accept tests may decide such a no-op step differently. The
# final chi2 must still agree to 1e-4 and the accepted counts to within one.
TOL_LM_CHI2 = 1e-4
TOL_GBA_CHI2 = 1e-3  # inexact-Newton PCG steps (forcing term 1e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:.0e}")


def phase_device(jax, n_cards: int):
    from sqrtlm_slam_tpu.utils.device import card_info

    devices = jax.devices()
    log(f"[device] {devices}")
    dev = devices[0]
    log(f"[device] platform={dev.platform} kind={dev.device_kind} count={len(devices)}")
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found (platform {dev.platform!r}); not falling back")
    if len(devices) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, found {len(devices)}")
    info = card_info()
    log(f"[device] card (name, power limit): {info}")
    return dev, info


def phase_kernels(jax, gpu, cpu):
    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.frontend import matching
    from sqrtlm_slam_tpu.optim import schur
    from sqrtlm_slam_tpu.optim import schur_bucketed as sb

    log("[kernels] Hamming matrix, Q = T = 2000 (run_kitti --max-features)")
    rng = np.random.RandomState(0)
    q = rng.randint(0, 2**32, (2000, 8), dtype=np.uint64).astype(np.uint32)
    t = rng.randint(0, 2**32, (2000, 8), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(
        jax.jit(matching.hamming_matrix)(jax.device_put(q, gpu), jax.device_put(t, gpu))
    )
    want = np.unpackbits(
        np.bitwise_xor(q[:, None, :], t[None, :, :]).view(np.uint8), axis=-1
    ).sum(-1)
    n_bad = int((got != want).sum())
    log(f"  hamming: {n_bad} of {got.size} entries differ (tol 0: exact integers)")
    if n_bad:
        raise AssertionError("Hamming matrix differs from the numpy bit count")

    P, L, K = 96, 8192, 5  # bench.py's local-BA window
    log(f"[kernels] local-BA reductions, P={P} L={L} K={K} stereo_frac=0.6")
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K)
    flat_cpu = jax.device_put(flat, cpu)
    prob_gpu = jax.device_put(sb.from_flat(flat, K), gpu)
    cam, delta = DEFAULT_CAM, 2.447

    @jax.jit
    def reductions(p):
        return sb.assemble(p, sb.prepare_obs(p, p.obs_valid), cam, delta)

    red = jax.device_get(reductions(prob_gpu))
    with jax.default_device(cpu):
        Hpp, Hll, W, bp, bl, chi2 = jax.device_get(
            jax.jit(
                lambda f: schur.build_normal_equations(f, cam, f.obs_valid, delta)
            )(flat_cpu)
        )
    cam_t = np.asarray(prob_gpu.obs_cam).T
    u = red.u18.reshape(6, 3, K, L)
    W_rows = np.zeros((P, 6, L, 3), np.float64)
    for k in range(K):
        np.add.at(W_rows, (cam_t[k], slice(None), np.arange(L)),
                  u[:, :, k, :].transpose(2, 0, 1))
    check("Hll", rel_err(red.hll9.T.reshape(L, 3, 3), Hll), TOL_REDUCTIONS)
    check("bl", rel_err(red.bl3.T, bl), TOL_REDUCTIONS)
    check("U (as W)", rel_err(W_rows.reshape(P * 6, L, 3), W), TOL_REDUCTIONS)
    check("Hpp", rel_err(red.Hpp, Hpp), TOL_REDUCTIONS)
    check("bp", rel_err(red.bp, bp), TOL_REDUCTIONS)
    check("chi2", rel_err(red.chi2, chi2), TOL_REDUCTIONS)

    log("[kernels] local-BA LM loop, 15 iterations, Huber delta 2.447")
    lm = jax.jit(lambda p: sb.ba_iterate(p, cam, p.obs_valid, 15, delta))
    _, chi2_g, acc_g = lm(prob_gpu)
    chi2_g.block_until_ready()
    t0 = time.perf_counter()
    _, chi2_g, acc_g = lm(prob_gpu)
    chi2_g.block_until_ready()
    dt = time.perf_counter() - t0
    with jax.default_device(cpu):
        _, chi2_c, acc_c = jax.jit(
            lambda f: schur.ba_iterate(f, cam, f.obs_valid, 15, delta)
        )(flat_cpu)
    log(f"  card chi2 {float(chi2_g):.4f} accepted {int(acc_g)}; "
        f"flat engine on CPU chi2 {float(chi2_c):.4f} accepted {int(acc_c)}")
    log(f"  smoke timing: {15 / dt:.1f} LM iters/s (one warm call)")
    check("LM chi2", rel_err(chi2_g, chi2_c), TOL_LM_CHI2)
    if abs(int(acc_g) - int(acc_c)) > 1:
        raise AssertionError(f"accepted steps {int(acc_g)} vs {int(acc_c)}")


def phase_main_path(jax, gpu, info: str):
    import run_kitti
    from sqrtlm_slam_tpu.eval.kitti_synth import generate

    n = 30
    root = os.path.join(SMOKE_DATA, "kitti")
    log(f"[main path] generating {n} frames of 1226x370 + HDL-64 scans -> {root}")
    t0 = time.perf_counter()
    generate(root, seq="00", n_frames=n, seed=0, step=0.8, log=lambda *a: None)
    log(f"  generated in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    result = run_kitti.main([
        "--root", root, "--seq", "00", "--mode", "fusion",
        "--frames", str(n), "--max-features", "2000", "--json",
        "--out", os.path.join(SMOKE_DATA, "traj_00.txt"),
    ])
    wall = time.perf_counter() - t0
    peak = gpu.memory_stats().get("peak_bytes_in_use", 0)
    log(f"  tracked {result['tracked']}/{n}, ATE {result['ate_rmse_m']} m, "
        f"keyframes {result['keyframes']}, landmarks {result['landmarks']}")
    log(f"  smoke number, not a benchmark: {result.get('frames_per_s')} frames/s "
        f"(compilation included; {wall:.1f}s wall) on {info}; "
        f"peak_bytes_in_use {peak}")
    if result["tracked"] != n:
        raise AssertionError(f"tracked {result['tracked']} of {n} frames")
    if not result["ate_rmse_m"] < 0.5:
        raise AssertionError(f"ATE {result['ate_rmse_m']} m >= 0.5 m")
    if result["keyframes"] < 2:
        raise AssertionError(f"only {result['keyframes']} keyframes")


def phase_global_ba(jax, gpu, cpu):
    from sqrtlm_slam_tpu.eval.scale import make_scale_store
    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu.optim import schur
    from sqrtlm_slam_tpu.optim import schur_bucketed as sb

    cam = DEFAULT_CAM
    P, L, K = 32, 2048, 5
    log(f"[global BA] PCG engine vs the flat engine on the CPU, P={P} L={L}")
    flat, _ = make_ba_problem(seed=1, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K)
    _, _, chi2_g = sb.global_ba_cg(jax.device_put(sb.from_flat(flat, K), gpu), cam)
    with jax.default_device(cpu):
        _, _, stats = schur.global_ba_cg(jax.device_put(flat, cpu), cam)
    log(f"  card chi2 {float(chi2_g):.4f}; flat engine on CPU {float(stats.chi2):.4f}")
    check("GBA chi2", rel_err(chi2_g, stats.chi2), TOL_GBA_CHI2)

    log("[global BA] map scale: 600 KFs / 1.2e5 landmarks (bench_scale shape)")
    store, _, _ = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5, drift=4e-4)
    problem, _ = gather_global_problem_bucketed(store)
    problem = jax.device_put(problem, gpu)
    chi0 = float(sb.chi2_only(problem, cam, problem.obs_valid, None))
    t0 = time.perf_counter()
    out, survivors, chi2 = sb.global_ba_cg(problem, cam, num_iters=10)
    chi2.block_until_ready()
    dt = time.perf_counter() - t0
    chi1 = float(sb.chi2_only(out, cam, out.obs_valid, None))
    finite = bool(np.isfinite(np.asarray(out.points)).all()) and np.isfinite(chi1)
    log(f"  P={problem.num_poses} L={problem.num_points}: chi2 {chi0:.1f} -> "
        f"{chi1:.1f} in 10 LM iterations ({dt:.1f}s incl. compile), "
        f"{int(survivors.sum())} surviving edges")
    if not (finite and chi1 < chi0):
        raise AssertionError(f"global BA at scale: chi2 {chi0} -> {chi1}")


def phase_four(jax, info: str):
    from jax.sharding import Mesh

    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu.optim import schur_bucketed as sb
    from sqrtlm_slam_tpu.parallel import dist_ba

    devices = jax.devices()[:4]
    mesh = Mesh(np.array(devices), ("ba",))  # flat: NVLink joins all pairs
    P, L, K, iters, delta = 96, 32768, 5, 15, 2.447
    log(f"[four] distributed BA over {mesh.devices.tolist()}, P={P} L={L} K={K}")
    flat, _ = make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6, obs_per_landmark=K)
    b = sb.from_flat(flat, K)

    placed = dist_ba.place_on_mesh(dist_ba.partition_bucketed(b, 4)[0], mesh)
    shard_devices = {s.device for s in placed.points.addressable_shards}
    log(f"  landmark shards on {len(shard_devices)} devices: {sorted(map(str, shard_devices))}")
    if len(shard_devices) != 4:
        raise AssertionError("landmark shards are not on four distinct devices")

    def timed(fn):
        out = fn()
        jax.block_until_ready(out)  # compile + first run
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        return out, time.perf_counter() - t0

    b1 = jax.device_put(b, devices[0])
    one = jax.jit(lambda p: sb.ba_iterate(p, DEFAULT_CAM, p.obs_valid, iters, delta))
    (_, chi2_1, acc_1), t_1 = timed(lambda: one(b1))
    (_, chi2_4, acc_4), t_4 = timed(
        lambda: dist_ba.distributed_ba_lm(b, DEFAULT_CAM, mesh, iters, delta)
    )
    log(f"  one card : chi2 {float(chi2_1):.4f} accepted {int(acc_1)} "
        f"wall {t_1 * 1e3:.1f} ms")
    log(f"  four cards: chi2 {float(chi2_4):.4f} accepted {int(acc_4)} "
        f"wall {t_4 * 1e3:.1f} ms (host partition and gather included)")
    log(f"  cards: {info}")
    check("distributed chi2", rel_err(chi2_4, chi2_1), TOL_LM_CHI2)
    if abs(int(acc_4) - int(acc_1)) > 1:
        raise AssertionError(f"accepted steps {int(acc_4)} vs {int(acc_1)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed-BA phase")
    args = ap.parse_args(argv)

    import jax

    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()
    n_cards = 4 if args.four else 1
    gpu, info = phase_device(jax, n_cards)
    if args.four:
        phase_four(jax, info)
    else:
        cpu = jax.devices("cpu")[0]
        phase_kernels(jax, gpu, cpu)
        phase_main_path(jax, gpu, info)
        phase_global_ba(jax, gpu, cpu)
    devices = jax.devices()
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": n_cards if args.four else len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
