"""Depth back-projection on the device (port of the part of
`sam6d_tpu/ops/pointcloud.py` the ISM geometric score runs).

Parity targets: reference `Pose_Estimation_Model/utils/data_utils.py`
get_point_cloud_from_depth (:92-110) and `Instance_Segmentation_Model/utils/
trimesh_utils.py` depth_image_to_pointcloud_translate_torch (:78-106).
"""
from __future__ import annotations

import torch


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (H, W) in meters, K (3, 3) -> camera-space points (H, W, 3)."""
    H, W = depth.shape
    xmap = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :].expand(H, W)
    ymap = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None].expand(H, W)
    x = (xmap - K[0, 2]) * depth / K[0, 0]
    y = (ymap - K[1, 2]) * depth / K[1, 1]
    return torch.stack([x, y, depth], dim=-1)


def masked_depth_mean_translation(masks: torch.Tensor, depth: torch.Tensor,
                                  K: torch.Tensor,
                                  depth_scale: torch.Tensor | float
                                  ) -> torch.Tensor:
    """Mean back-projected point of each masked depth region -> (N, 3), in
    meters (depth * depth_scale / 1000), over the mask pixels with Z > 0.

    As in the reference, the (possibly fractional) mask multiplies the depth
    before back-projection, so fractional pixels add scaled-down points."""
    Z = masks.to(depth.dtype) * depth[None] * depth_scale / 1000.0  # (N, H, W)
    H, W = depth.shape
    u = torch.arange(W, dtype=Z.dtype, device=Z.device)[None, None, :]
    v = torch.arange(H, dtype=Z.dtype, device=Z.device)[None, :, None]
    X = (u - K[0, 2]) * Z / K[0, 0]
    Y = (v - K[1, 2]) * Z / K[1, 1]
    den = (Z > 0).to(Z.dtype).sum(dim=(1, 2))[:, None] + 1e-8
    num = torch.stack([X.sum(dim=(1, 2)), Y.sum(dim=(1, 2)), Z.sum(dim=(1, 2))],
                      dim=1)
    return num / den
