"""PyTorch/CUDA port of the TPU-native LiDAR SLAM framework.

The JAX package beside it (the package name without ``_torch``) is the
reference; this package keeps its layout (``utils/ ops/ ops/registration/
models/ frontends/``) and function names, runs on an NVIDIA Hopper card,
and replaces the two Pallas kernels with hand-written CUDA kernels
(``csrc/nn.cu``, ``csrc/moments.cu``).  It imports neither jax nor the
JAX package.

Geometry is kept in full float32: TF32 would keep about three decimal
digits in matmuls and convolutions (the JAX package forces "highest"
matmul precision for the same reason).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
