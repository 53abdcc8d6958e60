"""Ball query and grouping (port of `sam6d_tpu/ops/ball_query.py`).

`two_scale_ball_query` runs the CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor (`sam6d_torch.kernels.ball_query`).
"""
from __future__ import annotations

import torch

from ..kernels.ball_query import first_k_hits, two_scale_ball_query

__all__ = ["first_k_hits", "two_scale_ball_query", "group_points"]


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, M, S) -> (B, M, S, C)
    (reference grouping_operation)."""
    B, N, C = feats.shape
    _, M, S = idx.shape
    flat = idx.reshape(B, M * S, 1).long().expand(-1, -1, C)
    return torch.gather(feats, 1, flat).reshape(B, M, S, C)
