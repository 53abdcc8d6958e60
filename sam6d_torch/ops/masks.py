"""Mask boxes, box IoU and fixed-capacity NMS on the device (port of the
device half of `sam6d_tpu/ops/masks.py`; the host RLE codecs are in
`data/rle.py`).

Parity targets: batched_mask_to_box (reference `segment_anything/utils/
amg.py`), compute_iou (reference `utils/bbox_utils.py:197-222`) and
per-object NMS (reference `model/utils.py:107-119`).
"""
from __future__ import annotations

import torch

from ..kernels.nms import nms_fixed_point, nms_fixed_point_plain


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) binary -> (N, 4) float32 xyxy boxes (exclusive max); an
    empty mask gives zeros (reference amg.batched_mask_to_box semantics)."""
    N, H, W = masks.shape
    m = masks > 0
    any_row = m.any(dim=2)                                  # (N, H)
    any_col = m.any(dim=1)                                  # (N, W)
    rows = torch.arange(H, device=masks.device)
    cols = torch.arange(W, device=masks.device)
    y1 = torch.where(any_row, rows, H).amin(dim=1)
    y2 = torch.where(any_row, rows, -1).amax(dim=1)
    x1 = torch.where(any_col, cols, W).amin(dim=1)
    x2 = torch.where(any_col, cols, -1).amax(dim=1)
    box = torch.stack([x1, y1, x2 + 1, y2 + 1], dim=1).to(torch.float32)
    return torch.where(any_row.any(dim=1)[:, None], box, torch.zeros_like(box))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = (torch.clamp(a[:, 2] - a[:, 0], min=0)
              * torch.clamp(a[:, 3] - a[:, 1], min=0))
    area_b = (torch.clamp(b[:, 2] - b[:, 0], min=0)
              * torch.clamp(b[:, 3] - b[:, 1], min=0))
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


def mask_iou_matrix(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) masks (nonzero = in) -> (N, N) mask IoU in float32."""
    m = (masks > 0).to(torch.float32).reshape(masks.shape[0], -1)
    inter = m @ m.T
    area = m.sum(dim=1)
    return inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-8)


def nms_overlap(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                same_group: torch.Tensor, thresh: float) -> torch.Tensor:
    """(N, N) bool O: O[i, j] where j ranks above i and the two overlap above
    `thresh` in one group. j ranks above i iff (score_j, -j) > (score_i, -i):
    the stable argsort(-score) order, with no gathers; invalid slots score
    -inf."""
    N = scores.shape[0]
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    idx = torch.arange(N, device=scores.device)
    beats = (s[None, :] > s[:, None]) | ((s[None, :] == s[:, None])
                                         & (idx[None, :] < idx[:, None]))
    return (iou > thresh) & same_group & beats


def nms_masked_rounds(iou: torch.Tensor, scores: torch.Tensor,
                      valid: torch.Tensor, same_group: torch.Tensor,
                      thresh: float):
    """Greedy NMS over a fixed-capacity set as a parallel fixed point, in
    plain torch ops. Returns (keep mask (N,), number of rounds).

    Each round decides every candidate whose higher-ranked overlapping
    candidates are decided: it is KEPT if none of them is kept-or-undecided,
    SUPPRESSED if one of them is kept. The highest-ranked undecided
    candidate always has all its predecessors decided, so the loop ends
    within the longest suppression chain and equals sequential greedy NMS.
    The test for undecided candidates is read on the host once per round
    (rounds + 1 device->host syncs in all); nms_masked_device runs the same
    rounds in one CUDA kernel on the card."""
    keep, rounds = nms_fixed_point_plain(
        nms_overlap(iou, scores, valid, same_group, thresh), valid)
    return keep, int(rounds)


def nms_masked_device(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                      same_group: torch.Tensor, thresh: float):
    """nms_masked_rounds through `torch.ops.sam6d.nms_fixed_point`: on the
    card one launch of the fixed-point kernel, with no host read; on the CPU
    the plain loop. Returns (keep mask (N,), rounds () int32), both on the
    device of `scores`."""
    return nms_fixed_point(nms_overlap(iou, scores, valid, same_group, thresh),
                           valid.to(torch.bool))


def nms_masked(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               same_group: torch.Tensor, thresh: float) -> torch.Tensor:
    """Keep mask of greedy NMS (see nms_masked_rounds)."""
    return nms_masked_rounds(iou, scores, valid, same_group, thresh)[0]
