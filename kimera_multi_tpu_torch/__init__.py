"""kimera_multi_tpu_torch — the PyTorch/CUDA port of kimera_multi_tpu.

Same sub-packages and function names as the JAX package, so the
counterpart of a module is found at once; PyTorch idiom inside: plain
functions on tensors with the candidate (batch) axis written out, an
explicit `device`, explicit keys. Nothing here imports jax or the JAX
package.

Layer map (what is ported so far):
  core/      device selection, threefry RNG policy (uniform and normal
             draws), SO(3) / SE(3) Lie operations, Stiefel manifold,
             pose-graph containers and LCD status codes
  kernels/   Hamming 2-NN matcher and DB-wide top-2 search, BoW scoring,
             sample gathers, hypothesis scoring, SoA minimal solvers,
             five-point model generation, batched RANSAC, small dense
             linear algebra; CUDA C++ under csrc/
  frontend/  BoW vocabulary and database, islands and detection,
             FrontendConfig / VerifiedLC, the batched front-end
             (make_detector, make_verifier, BatchedFrontend), the pose
             graph from loops, submap coarsening
  solve/     Gauss-Newton PGO, rank-lifted RBCD rounds, GNC-TLS weights,
             PCM frame initialization, robust PGO, chordal initialization,
             deterministic sums onto poses (incidence tables)
  vio/       visual-inertial odometry: bilinear sampling, undistortion,
             GFTT and pyramidal KLT, BRIEF descriptors, IMU
             preintegration, the fixed-lag smoother (forward-mode
             Gauss-Newton), the host-driven VioPipeline with RANSAC
             outlier rejection
  io/        synthetic keyframe stores, candidate pairs, multi-robot pose
             graphs and the simulated multi-robot world (numpy);
             reference-schema logs; the rendered stereo + IMU sequence
             (render); reference parameter files (config); recorded
             sessions: EuRoC ASL trees (dataset), rosbag1 files (rosbag),
             PNG (png), the converter to observation streams (convert),
             the replay gate (replay), rendered sequences written as
             sessions (record)
  eval/      absolute pose error
  cli/       run.py: the `sim`, `vio-sim` and `euroc` runs end to end;
             replay.py: the replay acceptance gate
  convert    state handed over from the JAX package as numpy (VIO
             configs, states, windows and keyframes too)
  entry      the fused SLAM step: verification, then one RBCD round
"""

__version__ = "0.1.0"

# Precision policy: the geometry is written in f32 and must run in f32 (the
# JAX package runs every matmul at HIGHEST precision; the squared-Sampson
# inlier threshold is 1e-6, far below what TF32's 10-bit mantissa resolves).
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
assert _torch.backends.cuda.matmul.allow_tf32 is False
