"""Utils: Kalman filter, timers, trajectory plot."""

import os

import jax.numpy as jnp
import numpy as np

from sqrtlm_slam_tpu.utils import StageTimer, TicToc
from sqrtlm_slam_tpu.utils import kalman


class TestKalman:
    def test_tracks_constant_velocity(self):
        rng = np.random.RandomState(0)
        v = np.array([1.0, 0.5, -0.2])
        s = kalman.init(jnp.zeros(3))
        for k in range(1, 40):
            z = jnp.asarray(v * k * 0.1 + rng.normal(0, 0.01, 3))
            s = kalman.step(s, z, dt=0.1)
        np.testing.assert_allclose(np.asarray(s.x[3:]), v, atol=0.05)
        np.testing.assert_allclose(np.asarray(s.x[:3]), v * 3.9, atol=0.05)

    def test_covariance_contracts(self):
        s = kalman.init(jnp.zeros(3), pos_var=10.0)
        p0 = float(jnp.trace(s.P))
        for _ in range(10):
            s = kalman.step(s, jnp.zeros(3), dt=0.1)
        assert float(jnp.trace(s.P)) < p0


class TestTimers:
    def test_tictoc_and_stage_timer(self):
        t = TicToc()
        assert t.toc() >= 0.0
        st = StageTimer()
        with st.stage("a"):
            pass
        with st.stage("a"):
            pass
        assert st.counts["a"] == 2
        assert "a" in st.summary()


def test_plot_trajectory(tmp_path):
    from sqrtlm_slam_tpu.eval.plot import plot_trajectory

    est = np.tile(np.eye(4), (20, 1, 1))
    est[:, 0, 3] = np.linspace(0, 10, 20)
    gt = est.copy()
    gt[:, 2, 3] = 0.1
    lm = np.random.RandomState(0).randn(100, 3)
    out = plot_trajectory(
        str(tmp_path / "traj.png"), est, gt=gt,
        comparisons={"prior": gt}, landmarks=lm,
    )
    assert os.path.getsize(out) > 1000


def test_load_yaml_config(tmp_path):
    """Reference-style OpenCV-YAML keys + section overrides both apply."""
    from sqrtlm_slam_tpu.utils.config import load_yaml_config

    p = tmp_path / "cfg.yaml"
    p.write_text(
        "ORBextractor.nFeatures: 1234\n"
        "ORBextractor.scaleFactor: 1.25\n"
        "ThDepth: 99\n"
        "tracking:\n  close_depth: 33.0\n"
    )
    cfg = load_yaml_config(str(p))
    assert cfg.orb.max_features == 1234
    assert abs(cfg.orb.scale_factor - 1.25) < 1e-9
    assert cfg.th_depth_scale == 99.0
    assert cfg.tracking.close_depth == 33.0


def test_render_slam_result(tmp_path):
    """Multi-panel SLAMresult snapshot (the Visualization() replacement)."""
    import numpy as np

    from sqrtlm_slam_tpu.eval.plot import render_slam_result

    rng = np.random.default_rng(0)
    res = {
        "state": 2, "ref_kf": 1, "num_inliers": 99,
        "kf_ids": np.arange(3),
        "kf_R": np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
        "kf_t": rng.normal(size=(3, 3)).astype(np.float32),
        "map_points": rng.normal(size=(200, 3)),
        "local_map_points": rng.normal(size=(40, 3)),
        "trajectory": np.tile(np.eye(4), (10, 1, 1)),
        "lidar_corner": rng.normal(size=(20, 3)),
        "lidar_flat": rng.normal(size=(100, 3)),
    }
    out = render_slam_result(
        res, str(tmp_path / "snap.png"),
        depth_image=rng.random((32, 64)), range_image=rng.random((16, 90)),
    )
    import os

    assert os.path.getsize(out) > 10000


class TestJaxSetup:
    def test_cache_dir_honours_env_var(self, monkeypatch, tmp_path):
        from sqrtlm_slam_tpu.utils import cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)

    def test_cache_dir_default_is_in_checkout(self, monkeypatch):
        from sqrtlm_slam_tpu.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_configure_jax_sets_precision_and_cache(self, monkeypatch):
        import jax

        from sqrtlm_slam_tpu.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        cache.configure_jax()
        assert jax.config.jax_default_matmul_precision == "highest"
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_CACHE_DIR
