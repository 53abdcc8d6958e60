"""Box IoU and fixed-capacity NMS on the device (port of the device half of
`sam6d_tpu/ops/masks.py`; the host RLE codecs are in `data/rle.py`).

Parity targets: compute_iou (reference `utils/bbox_utils.py:197-222`) and
per-object NMS (reference `model/utils.py:107-119`).
"""
from __future__ import annotations

import torch


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


def nms_masked_rounds(iou: torch.Tensor, scores: torch.Tensor,
                      valid: torch.Tensor, same_group: torch.Tensor,
                      thresh: float):
    """Greedy NMS over a fixed-capacity set as a parallel fixed point.
    Returns (keep mask (N,), number of rounds).

    Each round decides every candidate whose higher-ranked overlapping
    candidates are decided: it is KEPT if none of them is kept-or-undecided,
    SUPPRESSED if one of them is kept. The highest-ranked undecided
    candidate always has all its predecessors decided, so the loop ends
    within the longest suppression chain and equals sequential greedy NMS.
    The test for undecided candidates is read on the host once per round
    (rounds + 1 device->host syncs in all)."""
    N = scores.shape[0]
    # j precedes i iff (score_j, -j) > (score_i, -i): the stable
    # argsort(-score) order, with no gathers
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    idx = torch.arange(N, device=scores.device)
    beats = (s[None, :] > s[:, None]) | ((s[None, :] == s[:, None])
                                         & (idx[None, :] < idx[:, None]))
    O = ((iou > thresh) & same_group & beats).to(torch.float32)
    kept = torch.zeros(N, dtype=torch.bool, device=scores.device)
    # invalid slots start suppressed: never kept, never blocking
    supp = ~valid.to(torch.bool)
    rounds = 0
    while bool((~kept & ~supp).any()):
        und = ~kept & ~supp
        # both per-candidate reductions as one (N, N) @ (N, 2) product:
        # exact, 0/1 terms summed in fp32 and only the sign read
        R = O @ torch.stack([(~supp).to(torch.float32),
                             kept.to(torch.float32)], dim=1)
        kept, supp = kept | (und & ~(R[:, 0] > 0)), supp | (und & (R[:, 1] > 0))
        rounds += 1
    return kept, rounds


def nms_masked(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               same_group: torch.Tensor, thresh: float) -> torch.Tensor:
    """Keep mask of greedy NMS (see nms_masked_rounds)."""
    return nms_masked_rounds(iou, scores, valid, same_group, thresh)[0]
