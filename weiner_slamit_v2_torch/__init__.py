"""weiner_slamit_v2_torch: the PyTorch + CUDA port of weiner_slamit_v2_tpu.

Same algorithms, same map layout and the same numbers as the JAX package
(which stays in the repository as the reference); the two Pallas kernels
are hand-written CUDA kernels for Hopper under ``csrc/``.
"""

import torch as _torch

# Geometry/BA numerics need true f32 products (mirrors
# weiner_slamit_v2_tpu/__init__.py:12): no TF32 in matmuls or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import config, geometry, io  # noqa: F401, E402
