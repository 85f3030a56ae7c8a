from . import cuda_kernels

__all__ = ["cuda_kernels"]
