"""orbslam2_with_quadrics_tpu_torch — the PyTorch/CUDA port of the SLAM engine.

A second package beside ``orbslam2_with_quadrics_tpu`` (the JAX reference,
which it never imports). It mirrors the reference's layout:

- ``ops``    — Lie groups, camera model, ORB front end, Hamming matching
               (with the hand-written CUDA best-two kernel in
               ``ops/cuda_kernels.py`` + ``csrc/``), two-view initialization,
               motion-only LM and bundle adjustment.
- ``models`` — frontend, map state, tracking, local mapping and the
               monocular ``System`` facade.
- ``utils``  — numpy-only synthetic scenes and trajectory metrics.

Tensors carry their device: a ``MapConfig(device="cuda")`` map runs every
op on the card, and the one CUDA kernel is launched for CUDA tensors only.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (Lie ops, Jacobians, Schur solves) needs true fp32 products: TF32
# keeps ~10 mantissa bits and BA / pose optimization diverge with it. This is
# the counterpart of the reference's jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
