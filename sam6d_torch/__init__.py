"""SAM-6D in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `sam6d_tpu`, which stays the reference it is held
against. Plain tensor code is PyTorch; each Pallas kernel of the JAX package
on a ported path is a CUDA kernel written by hand for sm_90a
(`sam6d_torch/csrc/`, built and bound by `sam6d_torch.kernels._build`).
This package imports nothing of jax, flax or `sam6d_tpu`: it keeps its own
copies of the host code it needs.
"""
from __future__ import annotations

import torch


def use_strict_fp32() -> None:
    """Make float32 mean float32 on the card: no TF32 in matmuls or cuDNN
    convolutions (the JAX package's fp32 path is the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
