"""radarays_ros_tpu_torch — the PyTorch/CUDA port of radarays_ros_tpu.

A second package beside the JAX reference: the same rotating-FMCW radar
simulation (trace -> Snell/Fresnel bounces -> signal binning -> noise ->
u8 polar image), in plain torch tensor code plus hand-written CUDA C++
kernels for Hopper (csrc/) where the JAX package had Pallas TPU kernels.

Rules of the package:
  * it imports torch and numpy, never jax or radarays_ros_tpu — the host
    builders (scene ordering, planes, denoise taps, procedural scenes) are
    NumPy copies held bit-identical to the reference by the CPU tests;
  * every kernel has a plain torch version in the same module; a wrapper
    runs the plain version for CPU tensors and launches the kernel (or
    raises) for CUDA tensors;
  * float32 matmuls run in true f32: TF32 is the card's counterpart of the
    TPU bf16 input truncation that once corrupted the beam rotations and
    hit decisions of the reference, so it is switched off at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from radarays_ros_tpu_torch.sim.config import (  # noqa: E402,F401
    RadarModelConfig,
    RadarParams,
    Materials,
    AmbientNoiseParams,
)
from radarays_ros_tpu_torch.sim.radar import Radar  # noqa: E402,F401
from radarays_ros_tpu_torch.geom.scene import Scene  # noqa: E402,F401
