"""Process-wide JAX setup: persistent compile cache and matmul precision.

Every entry point (run_kitti, bench, chip_smoke, benchmarks, the tests and
`SlamSystem` construction) calls `configure_jax()` before its first jit.

* Compile cache (SURVEY §3.4 startup-cost parity: the reference pays its
  startup loading a 100 MB vocabulary, ours is XLA compilation). The cache
  lives where `JAX_COMPILATION_CACHE_DIR` says when it is set, and
  otherwise at one fixed path inside the checkout, `<repo>/.jax_cache`
  (gitignored).
* Precision. f32 matrix products compute in true f32
  (`jax_default_matmul_precision="highest"`). Without it a GPU may run them
  in TF32 (~10 mantissa bits), which rounds the one-hot selections and the
  cancellation-heavy Hpp / S = Y Y^T sums of the BA engine; the CPU tests
  validate the f32 algebra.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The compile-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_jax() -> None:
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
