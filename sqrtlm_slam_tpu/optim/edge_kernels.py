"""Small closed-form kernels for the BA engine.

The flat reference engine (optim/schur.py) keeps its einsum formulation
over (E, 3, 6) blocks; what lives here are the closed-form helpers it uses
in place of library calls.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate/det).

    `jnp.linalg.inv` lowers to an LU path that is slow for large batches of
    tiny matrices inside loops; the adjugate form is pure elementwise math.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E_ = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    idet = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    rows = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E_, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return rows * idet[..., None, None]
