"""The bucketed rows engine against the flat reference engine (optim/schur.py).

`schur_bucketed.assemble` computes residuals, Jacobians, Huber weights and
all reductions as (K, L) rows; here each output is checked against the
flat-edge normal equations of the same problem, and the LM loop against
the flat LM loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM, make_ba_problem
from sqrtlm_slam_tpu.optim import schur
from sqrtlm_slam_tpu.optim import schur_bucketed as sb

P, L, K = 8, 256, 4


def _problem(seed, stereo_frac, n_fixed=2):
    flat, _ = make_ba_problem(
        seed=seed, P=P, L=L, stereo_frac=stereo_frac, obs_per_landmark=K,
        n_fixed=n_fixed,
    )
    return flat, sb.from_flat(flat, K)


def _cross_blocks(red, cam_t):
    """Per-slot U (18, K, L) summed per (pose, landmark) -> flat W layout
    (P*6, L, 3)."""
    u = np.asarray(red.u18).reshape(6, 3, K, L)
    cam = np.asarray(cam_t)
    W = np.zeros((P, 6, L, 3), np.float64)
    for k in range(K):
        np.add.at(
            W, (cam[k], slice(None), np.arange(L)),
            u[:, :, k, :].transpose(2, 0, 1),
        )
    return W.reshape(P * 6, L, 3)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("stereo_frac", [0.0, 0.6])
@pytest.mark.parametrize("n_fixed", [1, 3])
def test_assemble_matches_flat_normal_equations(robust_delta, stereo_frac, n_fixed):
    flat, prob = _problem(0, stereo_frac, n_fixed)
    Hpp, Hll, W, bp, bl, chi2 = schur.build_normal_equations(
        flat, DEFAULT_CAM, flat.obs_valid, robust_delta
    )
    obs = sb.prepare_obs(prob, prob.obs_valid)
    red = sb.assemble(prob, obs, DEFAULT_CAM, robust_delta)
    # from_flat keeps landmark order, so the landmark axes line up.
    pairs = {
        "Hll": (np.asarray(red.hll9).T.reshape(L, 3, 3), Hll),
        "bl": (np.asarray(red.bl3).T, bl),
        "W": (_cross_blocks(red, obs.cam), W),
        "Hpp": (red.Hpp, Hpp),
        "bp": (red.bp, bp),
        "chi2": (red.chi2, chi2),
    }
    for name, (got, want) in pairs.items():
        # f32 sums in another order; relative to each output's largest entry.
        assert _rel_err(got, want) < 1e-5, name


@pytest.mark.parametrize("robust_delta", [None, 2.447])
@pytest.mark.parametrize("stereo_frac", [0.0, 0.6])
def test_ba_iterate_matches_flat_lm(robust_delta, stereo_frac):
    flat, prob = _problem(1, stereo_frac)
    out_f, chi2_f, _ = jax.jit(
        lambda p: schur.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 10, robust_delta)
    )(flat)
    out_b, chi2_b, _ = jax.jit(
        lambda p: sb.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 10, robust_delta)
    )(prob)
    c0 = float(schur.chi2_only(flat, DEFAULT_CAM, flat.obs_valid, robust_delta))
    assert float(chi2_b) < 0.1 * c0
    # The two loops damp differently from the first step on (schur.py
    # seeds mu from tau * max diag), so they agree at convergence level.
    np.testing.assert_allclose(float(chi2_b), float(chi2_f), rtol=0.05)
    np.testing.assert_allclose(
        np.asarray(out_b.pose_t), np.asarray(out_f.pose_t), rtol=0.05, atol=1e-3
    )


class TestChunkedSGram:
    """Banded chunked S_corr (plan_chunks/_chunked_S_corr) vs the dense
    Gram — same algebra, ~36x fewer flops on banded maps."""

    def _check(self, prob, Pn, plan):
        mu = jnp.float32(1e-3)
        obs = sb.prepare_obs(prob, prob.obs_valid)
        red = sb.assemble(prob, obs, DEFAULT_CAM, 2.447)
        dense = sb._pieces_tail(prob, red, mu, obs.cam, None)
        chunked = sb._pieces_tail(prob, red, mu, obs.cam, plan)
        S_ref = np.asarray(dense.S_half)
        np.testing.assert_allclose(
            np.asarray(chunked.S_half), S_ref,
            rtol=1e-4, atol=1e-5 * np.abs(S_ref).max(),
        )

    def test_banded_fully_covered(self):
        Pn, Ln, Kn = 24, 512, 4
        flat, _ = make_ba_problem(
            seed=5, P=Pn, L=Ln, stereo_frac=0.5, obs_per_landmark=Kn
        )
        prob = sb.from_flat(flat, Kn)
        plan = sb.plan_chunks(prob.obs_cam.T, prob.obs_valid.T, Pn, Lc=128, W=16)
        assert plan is not None
        assert int(plan.n_uncovered) == 0  # banded map: all chunk-covered
        self._check(prob, Pn, plan)

    def test_scrambled_uses_dense_fallback(self):
        """Random camera assignment: most landmarks escape their window —
        the lax.cond dense path must keep the result exact."""
        Pn, Ln, Kn = 24, 512, 4
        flat, _ = make_ba_problem(
            seed=6, P=Pn, L=Ln, stereo_frac=0.5, obs_per_landmark=Kn
        )
        prob = sb.from_flat(flat, Kn)
        rng = np.random.RandomState(0)
        cam_scrambled = jnp.asarray(
            rng.randint(0, Pn, size=prob.obs_cam.shape), jnp.int32
        )
        prob = prob._replace(obs_cam=cam_scrambled)
        plan = sb.plan_chunks(prob.obs_cam.T, prob.obs_valid.T, Pn, Lc=128, W=16)
        assert plan is not None
        assert int(plan.n_uncovered) > 0
        self._check(prob, Pn, plan)

    def test_lm_loop_with_plan_matches_dense(self):
        """The LM loop with a chunk plan vs without: final chi2 must agree
        (the plan only reorders exact sums for covered landmarks)."""
        Pn, Ln, Kn = 16, 256, 4
        flat, _ = make_ba_problem(
            seed=7, P=Pn, L=Ln, stereo_frac=0.5, obs_per_landmark=Kn
        )
        prob = sb.from_flat(flat, Kn)
        obs = sb.prepare_obs(prob, prob.obs_valid)
        plan = sb.plan_chunks(obs.cam, obs.w > 0, Pn, Lc=64, W=8)
        assert plan is not None
        _, chi_ref, _ = sb._lm_loop(prob, obs, DEFAULT_CAM, 2.447, 5, None)
        _, chi, _ = sb._lm_loop(prob, obs, DEFAULT_CAM, 2.447, 5, plan)
        np.testing.assert_allclose(float(chi), float(chi_ref), rtol=5e-3)


def test_plan_chunks_declines_unchunkable_shapes():
    cam_t = jnp.zeros((4, 300), jnp.int32)  # L not a multiple of Lc
    assert sb.plan_chunks(cam_t, cam_t >= 0, 32) is None
    cam_t = jnp.zeros((4, 512), jnp.int32)  # window as wide as the poses
    assert sb.plan_chunks(cam_t, cam_t >= 0, 16) is None


@pytest.mark.parametrize("query", ["default_backend", "devices"])
def test_ba_iterate_takes_no_platform_route(query, monkeypatch):
    """Tracing the LM loop never asks which platform it runs on."""
    _, prob = _problem(2, 0.5)

    def refuse(*_, **__):
        raise AssertionError(f"ba_iterate called jax.{query}")

    monkeypatch.setattr(jax, query, refuse)
    jax.make_jaxpr(lambda p: sb.ba_iterate(p, DEFAULT_CAM, p.obs_valid, 2, 2.447))(prob)


@pytest.mark.gpu
def test_engine_on_gpu_matches_cpu(gpu_device):
    """Compiled on the card with the precision policy of utils/cache.py, the
    reductions match the CPU run to a relative 1e-5 of each output."""
    flat, prob = _problem(0, 0.6)
    cpu = jax.devices("cpu")[0]

    def reductions(device):
        p = jax.device_put(prob, device)
        obs = sb.prepare_obs(p, p.obs_valid)
        return jax.device_get(
            jax.jit(sb.assemble, static_argnums=(2, 3))(p, obs, DEFAULT_CAM, 2.447)
        )

    got, want = reductions(gpu_device), reductions(cpu)
    for name, g, w in zip(sb.Reductions._fields, got, want):
        assert _rel_err(g, w) < 1e-5, name
