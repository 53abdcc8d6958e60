"""Host-side small-region cleanup of AMG masks (numpy + scipy).

The port's copy of `remove_small_regions` and `postprocess_small_regions`
(`sam6d_tpu/ops/masks.py:221`, `:244`; reference
`segment_anything/utils/amg.py:267-291` and
`automatic_mask_generator.py:323-372`), with `scipy.ndimage.label`
(8-connectivity) in place of cv2. `SAMSegmentor.generate_masks` runs them
when `SAMConfig.min_mask_region_area > 0`; the device path never does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.masks import masks_to_boxes


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Fill the holes ('holes') or drop the islands ('islands') smaller than
    `area_thresh` pixels; if every island is small, keep the largest.
    Returns (mask bool, changed)."""
    from scipy import ndimage

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask.astype(bool)).astype(np.uint8)
    regions, n_labels = ndimage.label(working, structure=np.ones((3, 3), int))
    sizes = np.bincount(regions.ravel(), minlength=n_labels + 1)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask.astype(bool), False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels + 1) if i not in fill]
        if not fill:
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def postprocess_small_regions(masks: np.ndarray, valid: np.ndarray,
                              min_area: int, nms_thresh: float):
    """Clean every valid mask of the fixed-capacity (K, H, W) buffer (holes,
    then islands), recompute the boxes (K, 4) xyxy, then greedy box NMS
    over the valid slots preferring masks the cleanup left unchanged
    (score 1 vs 0). Returns (masks, boxes, valid)."""
    masks = masks.copy()
    K = masks.shape[0]
    unchanged = np.ones((K,), np.float32)
    for i in range(K):
        if not valid[i]:
            continue
        m = masks[i] > 0
        m, ch1 = remove_small_regions(m, min_area, "holes")
        m, ch2 = remove_small_regions(m, min_area, "islands")
        masks[i] = m.astype(masks.dtype)
        unchanged[i] = float(not (ch1 or ch2))

    boxes = masks_to_boxes(torch.from_numpy(masks > 0)).numpy()
    order = np.argsort(-(unchanged + np.where(valid, 0.0, -10.0)), kind="stable")
    keep = np.asarray(valid).copy()
    for oi, i in enumerate(order):
        if not keep[i]:
            continue
        for j in order[oi + 1:]:
            if not keep[j]:
                continue
            xx1 = max(boxes[i, 0], boxes[j, 0])
            yy1 = max(boxes[i, 1], boxes[j, 1])
            xx2 = min(boxes[i, 2], boxes[j, 2])
            yy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
            a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            b = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            if inter / max(a + b - inter, 1e-9) > nms_thresh:
                keep[j] = False
    return masks, boxes, keep
