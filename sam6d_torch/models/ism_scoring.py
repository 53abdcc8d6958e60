"""ISM matching scores as masked tensor functions over a fixed proposal
capacity (port of `sam6d_tpu/models/ism_scoring.py`).

Parity targets (reference `Instance_Segmentation_Model/model/detector.py` and
`model/loss.py`):
- semantic score: cosine(query cls, all object/template cls), aggregated
  avg-top5 per object, best object + confidence threshold (:260-296)
- appearance score: masked-patch similarity vs the best template
  (loss.py compute_straight :52-62)
- geometric score: box IoU of the re-projected posed CAD cloud vs the
  proposal box (:209-246, 310-322)
- final score: (s_sem + s_appe + s_geo * vis) / (2 + vis) (:384)
Filtered proposals are masked (`valid`, `selected`), never gathered away.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.masks import box_iou
from ..ops.pointcloud import masked_depth_mean_translation


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def semantic_scores(query_cls: torch.Tensor, ref_cls: torch.Tensor,
                    valid: torch.Tensor, aggregation: str = "avg_5",
                    confidence_thresh: float = 0.2):
    """query_cls (P, C); ref_cls (O, T, C); valid (P,) bool.

    Returns dict(selected (P,), object_idx (P,), score (P,),
    best_template (P,)); `selected` = valid & score > thresh."""
    sim = torch.einsum("pc,otc->pot", _l2_normalize(query_cls),
                       _l2_normalize(ref_cls))
    sim = torch.clamp(sim, 0.0, 1.0)  # reference clamps (loss.py:44)
    if aggregation == "avg_5":
        per_obj = torch.topk(sim, min(5, sim.shape[-1]), dim=-1).values.mean(dim=-1)
    elif aggregation == "mean":
        per_obj = sim.mean(dim=-1)
    elif aggregation == "max":
        per_obj = sim.amax(dim=-1)
    elif aggregation == "median":
        per_obj = torch.quantile(sim, 0.5, dim=-1)  # averages the middle pair
    else:
        raise NotImplementedError(aggregation)
    score, _ = per_obj.max(dim=-1)
    # argmax takes the first maximum, as in JAX
    object_idx = torch.argmax(per_obj, dim=-1)
    best_t_per_obj = torch.argmax(sim, dim=-1)  # (P, O)
    best_template = torch.gather(best_t_per_obj, 1, object_idx[:, None])[:, 0]
    selected = valid & (score > confidence_thresh)
    return dict(selected=selected, object_idx=object_idx, score=score,
                best_template=best_template)


def appearance_scores(query_patch: torch.Tensor,
                      ref_patch: torch.Tensor) -> torch.Tensor:
    """query_patch (P, Np, C) masked+normalized patch descriptors; ref_patch
    (P, Nr, C) best-template descriptors. Score = mean over the valid query
    patches of the best ref cosine."""
    sim = torch.einsum("pnc,pmc->pnm", query_patch, ref_patch)
    max_ref = sim.amax(dim=-1)  # (P, Np)
    nonzero = query_patch.abs().sum(dim=-1) > 0
    factor = nonzero.sum(dim=-1).to(sim.dtype) + 1e-6
    return torch.clamp(max_ref.sum(dim=-1) / factor, 0.0, 1.0)


def visible_ratio(query_patch: torch.Tensor, ref_patch: torch.Tensor,
                  thresh: float = 0.5) -> torch.Tensor:
    """Fraction of ref patches confidently matched by some query patch
    (loss.py compute_visible_ratio :64-76)."""
    sim = torch.einsum("pnc,pmc->pnm", query_patch, ref_patch)
    best = sim.amax(dim=1)  # (P, Nr)
    valid_patches = (best != 0.0).sum(dim=-1).to(sim.dtype) + 1e-6
    sim_patches = ((best * (best > thresh)) != 0.0).sum(dim=-1)
    return sim_patches / valid_patches


def project_points_to_boxes(points: torch.Tensor, poses_R: torch.Tensor,
                            translations: torch.Tensor, K: torch.Tensor,
                            image_hw: Tuple[int, int]) -> torch.Tensor:
    """Pose the CAD clouds, project to pixels, return xyxy bounds (P, 4).

    points (P, M, 3); poses_R (P, 3, 3); translations (P, 3); K (3, 3). As
    detector.project_template_to_image (:209-232): uv truncated to int
    (toward zero), clamped into the image, box from min/max."""
    H, W = image_hw
    posed = torch.einsum("pij,pmj->pmi", poses_R, points) + translations[:, None, :]
    homo = torch.einsum("ij,pmj->pmi", K, posed)
    uv = (homo / homo[..., 2:3])[..., :2].to(torch.int32)
    u = torch.clamp(uv[..., 0], 0, W - 1)
    v = torch.clamp(uv[..., 1], 0, H - 1)
    return torch.stack([u.amin(dim=1), v.amin(dim=1), u.amax(dim=1),
                        v.amax(dim=1)], dim=1).to(torch.float32)


def geometric_scores(proposal_boxes: torch.Tensor, proposal_masks: torch.Tensor,
                     depth: torch.Tensor, K: torch.Tensor, depth_scale,
                     template_poses_R: torch.Tensor,
                     pointclouds: torch.Tensor) -> torch.Tensor:
    """IoU of the projected posed CAD box vs the proposal box (detector
    :310-322). proposal_boxes (P, 4) xyxy; proposal_masks (P, H, W);
    template_poses_R (P, 3, 3) best-template rotations; pointclouds (P, M, 3)
    per-proposal object clouds (meters)."""
    translate = masked_depth_mean_translation(proposal_masks, depth, K, depth_scale)
    proj_boxes = project_points_to_boxes(pointclouds, template_poses_R,
                                         translate, K, tuple(depth.shape))
    return torch.diagonal(box_iou(proj_boxes, proposal_boxes))


def final_scores(semantic, appearance, geometric, vis):
    """(s_sem + s_appe + s_geo*vis) / (2 + vis) (detector.py:384)."""
    return (semantic + appearance + geometric * vis) / (1.0 + 1.0 + vis)
