"""Robust loss functions (rho, rho', rho'') — batched, jit-safe.

JAX equivalent of the reference mybackend losses
(/root/reference/src/backend/mybackend/loss_function.h:23-92: Trivial, Huber,
Cauchy, Tukey) and the g2o Huber/Cauchy kernels used in pose optimization
(/root/reference/src/backend/g2oOptimizer.cc:505-552, myOptimizer.cc:36-231).

Each loss maps the squared error ``e2 = r^T W r`` to ``(rho, rho1, rho2)``.
Following standard practice (and the reference's `Edge::RobustInfo`), the IRLS
weight applied to an edge's (whitened) residual and Jacobian is ``rho1``; the
optional Triggs second-order correction is left to the caller.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp

LossFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]


class Loss(NamedTuple):
    """A robust loss: name + evaluation fn e2 -> (rho, rho1, rho2)."""

    name: str
    fn: LossFn

    def __call__(self, e2: jnp.ndarray):
        return self.fn(e2)

    def weight(self, e2: jnp.ndarray) -> jnp.ndarray:
        """IRLS weight rho'(e2), clipped to be nonnegative."""
        return jnp.maximum(self.fn(e2)[1], 0.0)


def trivial() -> Loss:
    def fn(e2):
        return e2, jnp.ones_like(e2), jnp.zeros_like(e2)

    return Loss("trivial", fn)


def huber(delta: float) -> Loss:
    """Huber: quadratic below delta^2, linear above (loss_function.h:38-56)."""
    d2 = delta * delta

    def fn(e2):
        sqrt_e2 = jnp.sqrt(jnp.maximum(e2, 1e-12))
        inlier = e2 <= d2
        rho = jnp.where(inlier, e2, 2.0 * delta * sqrt_e2 - d2)
        rho1 = jnp.where(inlier, jnp.ones_like(e2), delta / sqrt_e2)
        rho2 = jnp.where(inlier, jnp.zeros_like(e2), -0.5 * delta / (e2 * sqrt_e2))
        return rho, rho1, rho2

    return Loss("huber", fn)


def cauchy(c: float) -> Loss:
    """Cauchy: rho = c^2 log(1 + e2/c^2) (loss_function.h:58-74).

    The reference's pose optimization uses c = sqrt(5.991)
    (myOptimizer.cc:36-231, chi-square 0.05 quantile at 2 dof).
    """
    c2 = c * c
    inv_c2 = 1.0 / c2

    def fn(e2):
        aux = inv_c2 * e2 + 1.0
        rho = c2 * jnp.log(aux)
        rho1 = 1.0 / aux
        rho2 = -inv_c2 * rho1 * rho1
        return rho, rho1, rho2

    return Loss("cauchy", fn)


def tukey(c: float) -> Loss:
    """Tukey biweight: hard redescending loss (loss_function.h:76-92)."""
    c2 = c * c

    def fn(e2):
        e = jnp.sqrt(jnp.maximum(e2, 1e-12))
        inlier = e <= c
        aux = 1.0 - e2 / c2
        rho = jnp.where(inlier, c2 / 3.0 * (1.0 - aux**3), jnp.full_like(e2, c2 / 3.0))
        rho1 = jnp.where(inlier, aux * aux, jnp.zeros_like(e2))
        rho2 = jnp.where(inlier, -2.0 / c2 * aux, jnp.zeros_like(e2))
        return rho, rho1, rho2

    return Loss("tukey", fn)


# chi-square 0.05 upper quantiles used throughout the reference for inlier
# gating (g2oOptimizer.cc:493-552: 5.991 at 2 dof; 7.815 at 3 dof for stereo).
CHI2_2DOF = 5.991
CHI2_3DOF = 7.815
