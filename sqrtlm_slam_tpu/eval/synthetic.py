"""Synthetic textured-point world renderer for end-to-end SLAM testing.

There is no camera simulator in the reference (it replays KITTI); this
module provides a deterministic stand-in so the full pipeline
(ORB -> matching -> pose opt -> keyframes -> local BA -> trajectory) can be
exercised hermetically in CI and benchmarked without dataset files
(SURVEY.md §4: the accelerator build must carry CPU-runnable checks).

Each world point carries a fixed random binary micro-pattern so BRIEF
descriptors are discriminative across frames (plain dots would be mutually
ambiguous and die in the ratio test).
"""

from __future__ import annotations

import numpy as np

from ..factors.reprojection import Camera
from ..geometry import se3

import jax.numpy as jnp


class SyntheticWorld:
    def __init__(
        self,
        seed: int = 0,
        n_points: int = 800,
        extent=((-10.0, 10.0), (-5.0, 5.0), (2.0, 80.0)),
        pattern_size: int = 7,
    ):
        rng = np.random.RandomState(seed)
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.points = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
        self.patterns = (
            rng.rand(n_points, pattern_size, pattern_size) > 0.45
        ).astype(np.float32) * rng.uniform(120, 230, size=(n_points, 1, 1)).astype(
            np.float32
        )
        self.pattern_size = pattern_size

    # Physical pattern size (m): patches project to `pattern_size` px at the
    # reference depth below, and scale with 1/z like real-world texture —
    # required for the scale-invariance model (MapPoint::PredictScale /
    # octave-gated projection search) to hold on synthetic imagery.
    ref_depth: float = 18.0

    def render(self, T_cw: se3.SE3, cam: Camera, H: int = 240, W: int = 320):
        """Render (image, depth) from pose T_cw. Far points first (painter).

        Pattern patches scale with projected size (nearest-neighbor resample
        of each point's fixed micro-pattern), so approaching a point makes
        its features detectable at higher pyramid octaves — matching the
        physical scale model the ORB pyramid and the scale-aware projection
        search assume."""
        R = np.asarray(T_cw.R)
        t = np.asarray(T_cw.t)
        x_c = self.points @ R.T + t
        z = x_c[:, 2]
        u = cam.fx * x_c[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * x_c[:, 1] / np.maximum(z, 1e-6) + cam.cy
        ps = self.pattern_size
        # Projected patch size in px: ps at ref_depth, ∝ 1/z, bounded.
        size = np.clip(
            np.round(ps * self.ref_depth / np.maximum(z, 1e-6)).astype(np.int32),
            3, 3 * ps,
        )
        size = size + (1 - size % 2)  # odd
        half_all = size // 2
        # Near clip at ref_depth/3: a physical patch closer than that would
        # exceed the size cap (breaking the 1/z scale model) and in reality
        # is motion-blurred / partially out of frame — drop it instead of
        # painting a degenerate giant over the mid-field texture.
        ok = (
            (z > self.ref_depth / 3.0)
            & (u >= half_all + 1) & (u < W - half_all - 1)
            & (v >= half_all + 1) & (v < H - half_all - 1)
        )

        img = np.full((H, W), 25.0, np.float32)
        depth = np.zeros((H, W), np.float32)
        order = np.argsort(-z)  # far -> near
        # Bilinear resample weights per distinct size (cached): NEAREST
        # resampling aliases as projected size changes between frames, which
        # flickers BRIEF bits and collapses frame-to-frame matchability
        # (measured ~25% mutual-match rate); bilinear is stable under
        # sub-pixel scale changes like a real camera's PSF.
        interp = {}
        for s in np.unique(size[ok]):
            s = int(s)
            if s >= ps:
                # Upsampling: bilinear (stable under sub-pixel scale change).
                g = np.linspace(0, ps - 1, s)
                i0 = np.floor(g).astype(np.int32)
                i1 = np.minimum(i0 + 1, ps - 1)
                w = (g - i0).astype(np.float32)
                interp[s] = (i0, i1, w)
            else:
                # Downsampling: nearest — bilinear averages neighboring
                # binary cells into midtones and washes small far patterns
                # below the FAST contrast threshold (measured: tracking on
                # the 42 m ring died at frame 39 with bilinear-down).
                interp[s] = ((np.arange(s) * ps // s).astype(np.int32),) * 2 + (
                    np.zeros(s, np.float32),
                )

        for i in order:
            if not ok[i]:
                continue
            s = int(size[i])
            half = s // 2
            i0, i1, w = interp[s]
            P = self.patterns[i]
            rows = P[i0] * (1 - w)[:, None] + P[i1] * w[:, None]
            pat = rows[:, i0] * (1 - w)[None, :] + rows[:, i1] * w[None, :]
            ui, vi = int(round(u[i])), int(round(v[i]))
            sl = (slice(vi - half, vi + half + 1), slice(ui - half, ui + half + 1))
            img[sl] = np.maximum(img[sl], pat)
            depth[sl] = z[i]
        return jnp.asarray(img), jnp.asarray(depth)


def ring_world(seed: int = 0, n_points: int = 2000, radius: float = 12.0,
               band: float = 6.0, pattern_size: int = 7) -> "SyntheticWorld":
    """World with points scattered in an annulus around a circular path —
    re-observable from every point of the ring (loop-closure scenarios)."""
    w = SyntheticWorld(seed=seed, n_points=n_points, pattern_size=pattern_size)
    rng = np.random.RandomState(seed + 1)
    a = rng.uniform(0, 2 * np.pi, n_points)
    r = radius + rng.uniform(-band, band, n_points)
    w.points = np.stack(
        [np.cos(a) * r, rng.uniform(-2.0, 2.0, n_points), np.sin(a) * r], axis=-1
    ).astype(np.float32)
    # Typical viewing distance on the ring: looking tangent, the circle
    # curves out of the band after arc length ~sqrt(2*radius*band) — that
    # IS the usable sight distance, so set the physical pattern scale to it
    # (points render at the nominal pattern size there; the near clip at
    # ref_depth/3 only drops genuinely degenerate close passes).
    w.ref_depth = float(max(band + 2.0, np.sqrt(2.0 * radius * band)))
    return w


def ring_trajectory(n_frames: int, radius: float = 12.0, frac: float = 1.0):
    """T_cw poses driving around a circle in the XZ plane, heading tangent.

    `frac` > 1 re-traverses the start (loop closure); camera +z = forward.
    """
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c_w = np.array([np.cos(a) * radius, 0.0, np.sin(a) * radius])
        fwd = np.array([-np.sin(a), 0.0, np.cos(a)])  # tangent (+z cam)
        up = np.array([0.0, -1.0, 0.0])  # cam +y down
        right = np.cross(up, fwd)
        R_wc = np.stack([right, -up, fwd], axis=-1)  # cols: cam x,y,z in world
        R_cw = R_wc.T
        t_cw = -R_cw @ c_w
        poses.append(
            se3.SE3(jnp.asarray(R_cw, dtype=jnp.float32), jnp.asarray(t_cw, dtype=jnp.float32))
        )
    return poses


def forward_trajectory(n_frames: int, step: float = 0.4, yaw_rate: float = 0.004):
    """Ground-truth T_cw poses for a gently curving forward path."""
    poses = []
    T = se3.identity()
    for i in range(n_frames):
        poses.append(T)
        delta = jnp.array([0.0, 0.0, -step, 0.0, yaw_rate, 0.0])
        # T_cw updates by the inverse of camera motion (camera moves +z world).
        T = se3.compose(se3.exp(delta), T)
    return poses


DEFAULT_CAM = Camera(fx=220.0, fy=220.0, cx=160.0, cy=120.0, bf=44.0)


def make_ba_problem(
    seed: int = 0,
    P: int = 8,
    L: int = 256,
    cam: Camera = DEFAULT_CAM,
    noise: float = 0.3,
    pose_noise: float = 0.05,
    point_noise: float = 0.05,
    stereo_frac: float = 0.6,
    n_fixed: int = 2,
    spacing: float = 0.15,
    obs_per_landmark: int = 0,
):
    """Synthetic BA problem for benches/dry-runs.

    Returns (BAProblem, true SE3 poses). Poses lie on a rough line looking
    down +z; landmarks sit ahead of the trajectory; the initial estimate is a
    perturbation the optimizer must undo.

    obs_per_landmark = 0 gives the dense observation matrix (every pose sees
    every landmark — small unit-test problems); > 0 gives the realistic
    sparse visibility of a SLAM covisibility window: each landmark is
    observed by `obs_per_landmark` consecutive poses around its home pose
    (the reference's local BA runs at ~10^2 poses / ~10^4 landmarks /
    ~10^4 edges, SURVEY §3.2 — NOT P*L edges).
    """
    import jax

    from ..optim import schur

    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    t_true = jnp.stack(
        [jnp.arange(P) * spacing, jnp.zeros(P), jnp.zeros(P)], axis=-1
    ) + jax.random.normal(k1, (P, 3)) * 0.1
    w_true = jax.random.normal(k2, (P, 3)) * 0.02
    R_true = jax.vmap(lambda w: se3.exp(jnp.concatenate([jnp.zeros(3), w])).R)(w_true)
    pose_t = -jnp.einsum("pij,pj->pi", R_true, t_true)
    poses_true = se3.SE3(R_true, pose_t)

    points_true = jax.random.normal(k3, (L, 3)) * jnp.array([6.0, 3.0, 4.0]) + jnp.array(
        [P * spacing / 2.0, 0.0, 18.0]
    )

    if obs_per_landmark > 0:
        # Sparse covisibility: landmark l lives near pose (l * P / L); it is
        # seen by `obs_per_landmark` consecutive poses starting there.
        home = (jnp.arange(L, dtype=jnp.int32) * P) // L
        offs = jnp.arange(obs_per_landmark, dtype=jnp.int32)
        obs_cam = jnp.clip(home[:, None] + offs[None, :], 0, P - 1).reshape(-1)
        obs_pt = jnp.repeat(jnp.arange(L, dtype=jnp.int32), obs_per_landmark)
    else:
        obs_cam = jnp.repeat(jnp.arange(P, dtype=jnp.int32), L)
        obs_pt = jnp.tile(jnp.arange(L, dtype=jnp.int32), P)
    E = obs_cam.shape[0]
    T_e = se3.SE3(R_true[obs_cam], pose_t[obs_cam])
    x_c = se3.act(T_e, points_true[obs_pt])
    uv = cam.project(x_c) + jax.random.normal(k4, (E, 2)) * noise
    ur = uv[..., 0] - cam.bf / x_c[..., 2] + jax.random.normal(k5, (E,)) * noise
    is_stereo = jax.random.uniform(k6, (E,)) < stereo_frac
    uvr = jnp.concatenate([uv, jnp.where(is_stereo, ur, -1.0)[..., None]], axis=-1)

    k7, k8 = jax.random.split(k6)
    dpose = jax.random.normal(k7, (P, 6)) * jnp.array([1, 1, 1, 0.3, 0.3, 0.3]) * pose_noise
    dpose = dpose.at[:n_fixed].set(0.0)
    poses_init = se3.retract(poses_true, dpose)
    points_init = points_true + jax.random.normal(k8, (L, 3)) * point_noise

    problem = schur.BAProblem(
        pose_R=poses_init.R,
        pose_t=poses_init.t,
        pose_fixed=jnp.arange(P) < n_fixed,
        pose_valid=jnp.ones(P, bool),
        points=points_init,
        point_valid=jnp.ones(L, bool),
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uvr=uvr,
        obs_inv_sigma2=jnp.ones(E),
        obs_valid=jnp.ones(E, bool),
    )
    return problem, poses_true
