"""sqrtlm_slam_tpu — a visual-LiDAR SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
lutao98/SqrtLM-SLAM (ORB-SLAM2-derived visual tracking, LOAM-style LiDAR
odometry, visual-LiDAR tight coupling, and square-root Levenberg-Marquardt
bundle adjustment), built for an accelerator: struct-of-arrays map state, masked
fixed-capacity tensors, jit-compiled pipeline stages, and sharded distributed
BA over a `jax.sharding.Mesh`.

Package layout
--------------
  geometry/   SO3 / SE3 / Sim3 Lie ops, Horn-Umeyama alignment
  optim/      robust losses, square-root LM engine, Schur-complement BA
  factors/    residual+Jacobian library (reprojection, LiDAR, pose-graph, Sim3)
  frontend/   ORB extraction, matching, vocabulary / BoW place recognition
  lidar/      ring virtualization, range image, feature extraction, odometry
  mapstore/   SoA keyframe / landmark stores, covisibility graph
  pipeline/   tracking state machine, local mapping, system driver
  loop/       loop detection, Sim3 RANSAC, essential graph, global BA
  io/         KITTI dataset loading, trajectory writers, calibration
  parallel/   mesh / sharding utilities, distributed BA collectives
  eval/       ATE / RPE metrics (evo-equivalent protocol)
"""

__version__ = "0.1.0"
