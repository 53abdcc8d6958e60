"""Ball query and grouping (port of `sam6d_tpu/ops/ball_query.py`).

`two_scale_ball_query` runs the CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor (`sam6d_torch.kernels.ball_query`).
"""
from __future__ import annotations

import torch

from ..kernels.ball_query import _fill_tail, first_k_hits, two_scale_ball_query
from .geometry import pairwise_sq_distance

__all__ = ["first_k_hits", "two_scale_ball_query", "group_points", "ball_query",
           "query_and_group"]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) candidates, new_xyz (B, M, 3) centres -> (B, M,
    nsample) int32: the first `nsample` points within `radius` of each
    centre, in index order; empty slots repeat the first hit (0 if none).
    Plain torch on any device: the JAX package computes it outside any
    kernel, and no path of either package runs it."""
    d2 = pairwise_sq_distance(new_xyz, xyz)
    return _fill_tail(first_k_hits(d2 < radius * radius, nsample), xyz.shape[1])


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, M, S) -> (B, M, S, C)
    (reference grouping_operation)."""
    B, N, C = feats.shape
    _, M, S = idx.shape
    flat = idx.reshape(B, M * S, 1).long().expand(-1, -1, C)
    return torch.gather(feats, 1, flat).reshape(B, M, S, C)


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: torch.Tensor | None = None,
                    use_xyz: bool = True) -> torch.Tensor:
    """Reference QueryAndGroup (pointnet2_utils.py:334-355), channels-last:
    (B, M, nsample, 3 [+ C]) of the neighbours' xyz relative to the centre,
    then their features (only the features without `use_xyz`)."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    grouped = group_points(features, idx)
    return torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped
