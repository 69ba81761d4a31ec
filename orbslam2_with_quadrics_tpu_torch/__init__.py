"""orbslam2_with_quadrics_tpu_torch — the PyTorch/CUDA port of the SLAM engine.

A second package beside ``orbslam2_with_quadrics_tpu`` (the JAX reference,
which it never imports). It mirrors the reference's layout:

- ``ops``      — Lie groups (SE3, Sim3), camera model, ORB front end and
                 stereo matching, Hamming matching (with the hand-written
                 CUDA best-two kernel in ``ops/cuda_kernels.py`` +
                 ``csrc/``), two-view initialization, motion-only LM, bundle
                 adjustment (PCG and dense Schur, with an optional process
                 group for distributed BA), vocabulary, Sim3, pose-graph,
                 EPnP and dual-quadric solvers.
- ``models``   — frontend, map state, tracking, local mapping, loop closing
                 and relocalization, quadric landmarks, and the ``System``
                 facade for mono, stereo and RGB-D (``track_*``, ``warmup``,
                 trajectory export, async global BA).
- ``parallel`` — distributed BA and sharded retrieval over
                 ``torch.distributed`` (``dist_ba``), a spawn helper, and
                 two command-line checks (``dryrun``, ``multihost``).
- ``utils``    — numpy-only synthetic scenes, trajectory metrics, TUM /
                 KITTI trajectory files, and map / System checkpoints that
                 load in both packages (``serialization``).

Tensors carry their device. ``MapConfig.device`` defaults to ``"cuda"``: the
map and every op on it run on the card, and ``System`` raises where there is
none; ``MapConfig(device="cpu")`` asks for the CPU, where the one CUDA
kernel gives way to its plain version (it is launched for CUDA tensors only).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (Lie ops, Jacobians, Schur solves) needs true fp32 products: TF32
# keeps ~10 mantissa bits and BA / pose optimization diverge with it. This is
# the counterpart of the reference's jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
