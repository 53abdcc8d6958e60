"""PEM training losses (port of `sam6d_tpu/train/losses.py`, reference
utils/loss_utils.py).

Per-block bidirectional (N+1)-way correspondence cross-entropy with the
background as class 0 at distance threshold 0.15, plus the diagnostic
metrics the reference logs (accuracy, foreground count, foreground
distance). `torch.argmin` / `argmax`, like `jnp.argmin` / `argmax`, give a
tie to the first index.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..ops.geometry import inverse_transform_points, pairwise_sq_distance


def correspondence_labels(pts1, pts2, gt_R, gt_t, dis_thres: float):
    """GT labels for both directions (reference loss_utils.py:19-28).

    Returns (label1 (B, N1) in [0, N2], label2 (B, N2) in [0, N1], gt_pts);
    0 is the background."""
    gt_pts = inverse_transform_points(pts1, gt_R, gt_t)
    dmat = torch.sqrt(pairwise_sq_distance(gt_pts, pts2))
    dis1, lab1 = dmat.min(dim=2)
    label1 = torch.where(dis1 <= dis_thres, lab1 + 1, 0)
    dis2, lab2 = dmat.min(dim=1)
    label2 = torch.where(dis2 <= dis_thres, lab2 + 1, 0)
    return label1, label2, gt_pts


def _ce(logits, labels):
    """Cross entropy over the last axis; logits (B, N, K), labels (B, N)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def compute_correspondence_loss(attens: List[torch.Tensor], pts1, pts2, gt_R,
                                gt_t, dis_thres: float = 0.15,
                                prefix: str = "coarse") -> Dict[str, torch.Tensor]:
    """Reference compute_correspondence_loss (loss_utils.py:7-52).

    attens: per-block (B, N1+1, N2+1) similarities. Returns a per-sample
    dict: '{prefix}_loss{i}', '{prefix}_acc', '{prefix}_fg_num',
    '{prefix}_dis'."""
    with torch.no_grad():
        label1, label2, gt_pts = correspondence_labels(pts1, pts2, gt_R, gt_t,
                                                       dis_thres)
    out: Dict[str, torch.Tensor] = {}
    for i, atten in enumerate(attens):
        # direction 1: rows 1..N1 classify over the N2+1 columns; direction
        # 2: columns 1..N2 over the N1+1 rows
        l1 = _ce(atten[:, 1:, :], label1).mean(dim=1)
        l2 = _ce(atten.transpose(1, 2)[:, 1:, :], label2).mean(dim=1)
        out[f"{prefix}_loss{i}"] = 0.5 * (l1 + l2)

    with torch.no_grad():
        pred_label = attens[-1][:, 1:, :].argmax(dim=2)            # (B, N1)
        out[f"{prefix}_acc"] = (pred_label == label1).float().mean(dim=1)
        fg = (pred_label > 0).float()
        out[f"{prefix}_fg_num"] = fg.sum(dim=1)
        fg_idx = (fg * (pred_label - 1)).long()
        pred_pts = torch.gather(pts2, 1, fg_idx[..., None].expand(-1, -1, 3))
        pred_dis = torch.linalg.vector_norm(pred_pts - gt_pts, dim=2)
        out[f"{prefix}_dis"] = (pred_dis * fg).sum(dim=1) / (fg.sum(dim=1) + 1e-8)
    return out


def total_loss(end_points: Dict[str, torch.Tensor], clamp: float = 100.0):
    """Sum the '*_loss*' entries, clamp, mean over the batch
    (loss_utils.py:56-68). Returns (scalar loss, dict of scalar metrics)."""
    metrics = {k: v.mean() for k, v in end_points.items()}
    per_sample = None
    for k, v in end_points.items():
        if "loss" in k:
            per_sample = v if per_sample is None else per_sample + v
    loss = torch.clamp(per_sample, max=clamp).mean()
    metrics["loss"] = loss
    return loss, metrics
