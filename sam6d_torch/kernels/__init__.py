"""The hand-written CUDA kernels, their plain versions and their dispatch.
Importing the package registers the `torch.ops.sam6d` operators
(`ops.py`) that every dispatch function calls."""
from . import ops  # noqa: F401
