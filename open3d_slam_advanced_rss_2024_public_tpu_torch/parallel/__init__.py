"""parallel of the PyTorch/CUDA port: the multi-chip path on torch.distributed."""
from . import mesh  # noqa: F401
from .mesh import DATA_AXIS, make_mesh  # noqa: F401
