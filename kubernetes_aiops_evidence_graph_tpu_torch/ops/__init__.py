"""Sparse segment primitives in plain PyTorch: the plain versions that the
hand-written kernels in ``kernels/`` are held against."""
from .segment import gather_matmul_segment

__all__ = ["gather_matmul_segment"]
