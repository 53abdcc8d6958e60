"""Depth back-projection and cloud helpers on the device (port of
`sam6d_tpu/ops/pointcloud.py`).

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


def radius_outlier_mask(cloud: torch.Tensor, valid: torch.Tensor,
                        radius_limit: torch.Tensor | float) -> torch.Tensor:
    """cloud (N, 3), valid (N,) bool -> (N,) bool: the valid points within
    `radius_limit` of the valid points' centroid (the outlier cut of the
    reference instance assembly, run_inference_custom.py:215-221)."""
    vf = valid.to(cloud.dtype)[:, None]
    center = (cloud * vf).sum(dim=0) / torch.clamp(vf.sum(), min=1.0)
    return valid & (torch.linalg.vector_norm(cloud - center, dim=1) < radius_limit)


def normalize_cloud_by_radius(clouds: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) clouds divided by their radius (...,), eps-guarded
    (reference feature_extraction.py:139-157)."""
    return clouds / (radius[..., None, None] + 1e-6)


def cloud_radius(cloud: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Largest point norm of the (valid) cloud: (..., N, 3) -> (...,)."""
    n = torch.linalg.vector_norm(cloud, dim=-1)
    if valid is not None:
        n = torch.where(valid, n, torch.zeros_like(n))
    return n.amax(dim=-1)
