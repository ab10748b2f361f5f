"""Scan registration of the PyTorch/CUDA port."""
from . import chain, icp, inspectors, minimizers, outliers, sequence  # noqa: F401
from .icp import (ICPConfig, ICPResult, register, register_clouds,  # noqa: F401
                  register_with_covariance)
from .sequence import ICPSequence  # noqa: F401
