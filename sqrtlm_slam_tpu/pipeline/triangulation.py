"""Two-view triangulation of new map points — batched, jittable.

JAX redesign of `LocalMapping::CreateNewMapPoints`
(/root/reference/src/backend/LocalMapping.cc:329-661) and the epipolar
search `ORBmatcher::SearchForTriangulation`
(/root/reference/src/frontend/ORBmatcher.cc:887): instead of per-pair BoW
node walks + per-point SVD calls, one jitted computation per keyframe pair
does descriptor matching under an epipolar-band mask, a batched 4x4 DLT
SVD for ALL candidate pairs, and the reference's acceptance gates
(parallax, positive depth in both views, reprojection chi2, scale
consistency) as vectorized masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3, so3

CHI2_MONO = 5.991


class TriangulationResult(NamedTuple):
    points_w: jnp.ndarray  # (N, 3) triangulated world points
    idx2: jnp.ndarray  # (N,) matched keypoint in view 2 for each view-1 kp
    valid: jnp.ndarray  # (N,) bool — passed all gates


def fundamental_matrix(T1w: se3.SE3, T2w: se3.SE3, cam: Camera) -> jnp.ndarray:
    """F12 with x2^T F12 x1 = 0 (pixels), from world->cam poses
    (ORBmatcher::ComputeF12 equivalent)."""
    T12 = se3.compose(T1w, se3.inverse(T2w))  # cam2 -> cam1
    R12, t12 = T12.R, T12.t
    K = jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=R12.dtype,
    )
    Kinv = jnp.linalg.inv(K)
    E = so3.hat(t12) @ R12  # x1_n^T E x2_n = 0
    F = Kinv.T @ E @ Kinv
    return F.T  # x2^T F12 x1


def _dlt_triangulate(uv1, uv2, P1, P2):
    """Batched DLT: rows from x (P row3) - (P row{0,1}) = 0. (N,2)x2 -> (N,3)."""
    def rows(uv, P):
        return jnp.stack(
            [
                uv[..., 0, None] * P[2] - P[0],
                uv[..., 1, None] * P[2] - P[1],
            ],
            axis=-2,
        )  # (N, 2, 4)

    A = jnp.concatenate([rows(uv1, P1), rows(uv2, P2)], axis=-2)  # (N, 4, 4)
    _, _, Vt = jnp.linalg.svd(A)
    X = Vt[..., -1, :]
    w = X[..., 3]
    return X[..., :3] / jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)[..., None]


@functools.partial(jax.jit, static_argnames=("cam",))
def match_and_triangulate(
    T1w: se3.SE3,
    T2w: se3.SE3,
    cam: Camera,
    xy1, desc1, valid1, sigma2_1,
    xy2, desc2, valid2, sigma2_2,
    angles1=None, angles2=None,
    min_parallax_cos: float = 0.9998,
    epipolar_band: float = 3.84,
) -> TriangulationResult:
    """Epipolar-gated matching + DLT triangulation + acceptance gates.

    valid1 should already exclude keypoints bound to existing landmarks.
    """
    # Epipolar band mask: point-line distance of kp2 to F12 @ kp1.
    F12 = fundamental_matrix(T1w, T2w, cam)
    x1h = jnp.concatenate([xy1, jnp.ones_like(xy1[..., :1])], axis=-1)  # (N1, 3)
    lines = x1h @ F12.T  # (N1, 3) lines in image 2
    x2h = jnp.concatenate([xy2, jnp.ones_like(xy2[..., :1])], axis=-1)
    num = jnp.abs(lines @ x2h.T)  # (N1, N2)
    den = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2 + 1e-12)[..., None]
    dist2 = (num / den) ** 2
    epi_ok = dist2 < epipolar_band * sigma2_2[None, :]

    res = matching.match_descriptors(
        desc1, desc2, valid1, valid2,
        window_mask=epi_ok,
        max_dist=matching.TH_LOW,
        ratio=0.75,  # SearchForTriangulation mfNNratio semantics
        mutual=True,
        angles=(angles1, angles2) if angles1 is not None else None,
    )

    uv1 = xy1
    uv2 = xy2[res.idx]

    # Projection matrices P = K [R|t].
    K = jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=xy1.dtype,
    )
    P1 = K @ jnp.concatenate([T1w.R, T1w.t[:, None]], axis=-1)
    P2 = K @ jnp.concatenate([T2w.R, T2w.t[:, None]], axis=-1)
    X = _dlt_triangulate(uv1, uv2, P1, P2)

    # Gates (LocalMapping.cc:430-620).
    x_c1 = se3.act(T1w, X)
    x_c2 = se3.act(T2w, X)
    depth_ok = (x_c1[..., 2] > 0.05) & (x_c2[..., 2] > 0.05)

    C1 = -T1w.R.T @ T1w.t
    C2 = -T2w.R.T @ T2w.t
    r1 = X - C1
    r2 = X - C2
    cos_par = jnp.sum(r1 * r2, axis=-1) / (
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + 1e-9
    )
    parallax_ok = cos_par < min_parallax_cos

    e1 = jnp.sum((cam.project(x_c1) - uv1) ** 2, axis=-1) / sigma2_1
    e2 = jnp.sum((cam.project(x_c2) - uv2) ** 2, axis=-1) / sigma2_2[res.idx]
    reproj_ok = (e1 < CHI2_MONO) & (e2 < CHI2_MONO)

    # Scale consistency: distance ratio bounded (ratioFactor semantics).
    d1 = jnp.linalg.norm(r1, axis=-1)
    d2 = jnp.linalg.norm(r2, axis=-1)
    ratio = d1 / jnp.maximum(d2, 1e-9)
    scale_ok = (ratio > 1.0 / 2.5) & (ratio < 2.5)

    valid = res.valid & depth_ok & parallax_ok & reproj_ok & scale_ok
    return TriangulationResult(points_w=X, idx2=res.idx, valid=valid)
