"""Generic damped Levenberg-Marquardt engine — jittable, vmap-safe.

JAX redesign of the reference's hand-written solver
(/root/reference/src/backend/mybackend/problem.cc):
  * `Problem::Solve` LM loop with Nielsen gain-ratio damping
    (problem.cc:92-167, ComputeLambdaInitLM :591-630, IsGoodStepInLM :679-713)
  * rollback on rejected steps (problem.cc:580) — here a functional
    select instead of mutation, so the whole loop stays inside one jit.

The engine is deliberately structure-agnostic: the caller supplies
``system_fn(params) -> (H, b, chi2)`` building the (damped-to-be) normal
equations ``H dx = -b`` with ``b = J^T W r``, and ``retract_fn(params, dx)``
applying a tangent update. Fixed variables / gauge freedoms are handled by the
caller (zeroed rows/cols + unit diagonal). Bundle adjustment does NOT go
through this dense engine — it uses the Schur-complement path in
`optim.schur` — but pose-only optimization, Sim3 refinement, and pose-graph
relaxation all do.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

SystemFn = Callable[[Any], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]
RetractFn = Callable[[Any, jnp.ndarray], Any]


class LMResult(NamedTuple):
    params: Any
    chi2: jnp.ndarray
    mu: jnp.ndarray
    num_accepted: jnp.ndarray


def _solve_damped(H: jnp.ndarray, b: jnp.ndarray, mu: jnp.ndarray) -> jnp.ndarray:
    """Solve (H + mu I) dx = -b via Cholesky with an LU fallback baked in.

    The systems this engine targets are small and dense (6 to a few
    hundred dims). The mu*I damping guarantees positive-definiteness for mu
    large enough, so no pivoting pathologies arise in practice.
    """
    D = H.shape[-1]
    A = H + mu * jnp.eye(D, dtype=H.dtype)
    return jnp.linalg.solve(A, -b)


def lm_optimize(
    params0: Any,
    system_fn: SystemFn,
    retract_fn: RetractFn,
    num_iters: int = 10,
    tau: float = 1e-5,
    min_chi2_decrease: float = 1e-6,
) -> LMResult:
    """Run `num_iters` LM iterations (fixed count — XLA-friendly).

    tau: initial damping scale relative to max diagonal of H
    (reference: lambda0 = 1e-5 * maxDiag, problem.cc:591-630).

    Each iteration costs exactly one `system_fn` evaluation: the candidate's
    normal equations double as the next iteration's, selected on acceptance.
    Convergence (chi2 decrease below threshold) freezes further updates via
    masking rather than early exit, keeping the loop trace static.
    """
    H0, b0, chi20 = system_fn(params0)
    max_diag = jnp.max(jnp.abs(jnp.diagonal(H0, axis1=-2, axis2=-1)))
    mu0 = tau * jnp.maximum(max_diag, 1e-10)

    def body(carry, _):
        params, H, b, chi2, mu, nu, done, n_acc = carry

        dx = _solve_damped(H, b, mu)
        candidate = retract_fn(params, dx)
        H_c, b_c, chi2_c = system_fn(candidate)

        # Nielsen gain ratio: actual / predicted decrease.
        predicted = 0.5 * jnp.sum(dx * (mu * dx - b))
        actual = chi2 - chi2_c
        rho = actual / jnp.maximum(predicted, 1e-12)
        accept = jnp.logical_and(rho > 0, jnp.isfinite(chi2_c)) & (~done)

        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        mu_new = jnp.where(accept, mu * factor, mu * nu)
        nu_new = jnp.where(accept, 2.0, nu * 2.0)

        sel = lambda a, b_: jnp.where(accept, a, b_)
        params_new = jax.tree_util.tree_map(lambda c, p: sel(c, p), candidate, params)
        H_new = sel(H_c, H)
        b_new = sel(b_c, b)
        chi2_new = sel(chi2_c, chi2)

        done_new = done | (accept & (actual < min_chi2_decrease * jnp.maximum(chi2, 1.0)))
        n_acc_new = n_acc + accept.astype(jnp.int32)
        return (params_new, H_new, b_new, chi2_new, mu_new, nu_new, done_new, n_acc_new), None

    init = (
        params0,
        H0,
        b0,
        chi20,
        mu0,
        jnp.asarray(2.0, dtype=H0.dtype),
        jnp.asarray(False),
        jnp.asarray(0, dtype=jnp.int32),
    )
    (params, _, _, chi2, mu, _, _, n_acc), _ = jax.lax.scan(
        body, init, None, length=num_iters
    )
    return LMResult(params, chi2, mu, n_acc)


def gauss_newton_step(H: jnp.ndarray, b: jnp.ndarray, damping: float = 1e-6) -> jnp.ndarray:
    """Single (lightly damped) GN step — used by inner loops that manage
    their own outer re-linearization schedule (e.g. LiDAR scan matching's
    5-outer-iteration protocol, lidarOdom.cc:1369-1572)."""
    return _solve_damped(H, b, jnp.asarray(damping, dtype=H.dtype))
