"""Bucketed Schur engine vs the flat-edge engine — identical algebra."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.optim import loss as losses
from sqrtlm_slam_tpu.optim import schur, schur_bucketed as sb

K = 5


@pytest.fixture(scope="module")
def problems():
    flat, _ = make_ba_problem(seed=3, P=12, L=128, stereo_frac=0.5, obs_per_landmark=K)
    bucketed = sb.from_flat(flat, K)
    return flat, bucketed


def test_damped_minv_inverts_damped_hll():
    """The closed-form rows factor gives Hll_d^{-1} = Minv^T Minv, with
    invalid landmarks mapped to identity blocks."""
    rng = np.random.RandomState(0)
    A = rng.randn(32, 3, 3).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    valid = np.arange(32) % 7 != 0
    mu = 1e-2
    minv6 = sb._damped_minv(jnp.asarray(M.reshape(32, 9).T), jnp.asarray(valid), mu)
    m11, m21, m22, m31, m32, m33 = np.asarray(minv6)
    z = np.zeros_like(m11)
    Minv = np.stack(
        [np.stack([m11, z, z], -1), np.stack([m21, m22, z], -1),
         np.stack([m31, m32, m33], -1)], -2,
    )
    M_d = M + mu * M * np.eye(3) + 1e-8 * np.eye(3)
    M_d[~valid] = np.eye(3)
    np.testing.assert_allclose(
        Minv.transpose(0, 2, 1) @ Minv @ M_d,
        np.broadcast_to(np.eye(3, dtype=np.float32), (32, 3, 3)),
        rtol=1e-3, atol=1e-3,
    )


def test_chi2_matches_flat(problems):
    flat, bucketed = problems
    c_flat = float(schur.chi2_only(flat, DEFAULT_CAM, flat.obs_valid, 2.447))
    c_b = float(sb.chi2_only(bucketed, DEFAULT_CAM, bucketed.obs_valid, 2.447))
    assert c_flat == pytest.approx(c_b, rel=1e-5)


def test_step_matches_flat(problems):
    flat, bucketed = problems
    mu = jnp.float32(1e-3)
    delta = math.sqrt(losses.CHI2_2DOF)
    Hpp, Hll, W, bp, bl, _ = schur.build_normal_equations(
        flat, DEFAULT_CAM, flat.obs_valid, delta
    )
    dxp_f, dxl_f = schur.reduce_and_solve(
        Hpp, Hll, W, bp, bl, flat.pose_fixed, flat.point_valid, mu
    )
    dxp_b, dxl_b, chi2, bp_b, bl_b = sb.reduce_and_solve(
        bucketed, DEFAULT_CAM, bucketed.obs_valid, delta, mu
    )
    np.testing.assert_allclose(np.asarray(bp_b), np.asarray(bp), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(bl_b), np.asarray(bl), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(dxp_b), np.asarray(dxp_f), rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dxl_b), np.asarray(dxl_f), rtol=2e-2, atol=2e-3)


def test_lm_loop_converges_like_flat(problems):
    flat, bucketed = problems
    out_f, chi2_f, _ = jax.jit(
        lambda p: schur.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 10, robust_delta=2.447)
    )(flat)
    out_b, chi2_b, _ = jax.jit(
        lambda p: sb.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 10, robust_delta=2.447)
    )(bucketed)
    c0 = float(schur.chi2_only(flat, DEFAULT_CAM, flat.obs_valid, 2.447))
    assert float(chi2_f) < 0.1 * c0
    assert float(chi2_b) == pytest.approx(float(chi2_f), rel=0.05)
    # Optimized poses agree.
    np.testing.assert_allclose(
        np.asarray(out_b.pose_t), np.asarray(out_f.pose_t), rtol=0.05, atol=1e-3
    )


def test_local_ba_protocol(problems):
    _, bucketed = problems
    out, survivors, chi2 = sb.local_ba(bucketed, DEFAULT_CAM)
    n_valid = int(jnp.sum(bucketed.obs_valid))
    n_surv = int(jnp.sum(survivors))
    assert n_surv > 0.8 * n_valid
    assert float(chi2) >= 0.0 and np.isfinite(float(chi2))


def test_cg_matches_dense_step(problems):
    """Matrix-free PCG step == dense-S step (same damping)."""
    _, bucketed = problems
    mu = jnp.float32(1e-3)
    dxp_d, dxl_d, _, _, _ = sb.reduce_and_solve(
        bucketed, DEFAULT_CAM, bucketed.obs_valid, None, mu
    )
    dxp_c, dxl_c, _, _, _, n = sb.cg_reduce_and_solve(
        bucketed, DEFAULT_CAM, bucketed.obs_valid, None, mu, cg_iters=300, cg_tol=1e-9
    )
    assert int(n) > 0
    np.testing.assert_allclose(np.asarray(dxp_c), np.asarray(dxp_d), rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dxl_c), np.asarray(dxl_d), rtol=2e-2, atol=2e-3)


def test_global_ba_cg_converges(problems):
    _, bucketed = problems
    c0 = float(sb.chi2_only(bucketed, DEFAULT_CAM, bucketed.obs_valid, 2.447))
    out, survivors, chi2 = sb.global_ba_cg(bucketed, DEFAULT_CAM, num_iters=10)
    assert float(chi2) < 0.1 * c0
    assert int(jnp.sum(survivors)) > 0.8 * int(jnp.sum(bucketed.obs_valid))


def test_schur_matvec_rows_matches():
    """The matrix-free CG matvec must reproduce the explicit reduced system
    S of the dense step (same damping) on the free poses."""
    P, L, K = 8, 256, 4
    flat, _ = make_ba_problem(seed=3, P=P, L=L, stereo_frac=0.5, obs_per_landmark=K)
    prob = sb.from_flat(flat, K)
    cam = DEFAULT_CAM
    mu = jnp.float32(1e-3)
    obs = sb.prepare_obs(prob, prob.obs_valid)
    red = sb.assemble(prob, obs, cam, 2.447)
    pieces = sb._pieces_tail(prob, red, mu, obs.cam)
    rng = np.random.RandomState(0)
    v = jnp.asarray(rng.randn(P, 6).astype(np.float32))
    free = ~np.asarray(prob.pose_fixed)
    v_free = jnp.where(prob.pose_fixed[:, None], 0.0, v)
    ref = (np.asarray(pieces.S_half) @ np.asarray(v_free).reshape(-1)).reshape(P, 6)
    got = sb._schur_matvec(
        v, red.u18, pieces.minv6, sb._damp_hpp(red.Hpp, mu), obs.cam,
        prob.pose_fixed,
    )
    np.testing.assert_allclose(
        np.asarray(got)[free], ref[free], rtol=1e-4,
        atol=1e-5 * float(np.abs(ref).max()),
    )
    np.testing.assert_array_equal(np.asarray(got)[~free], 0.0)
