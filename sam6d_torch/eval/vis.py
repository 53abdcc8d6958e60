"""Result visualization (reference Pose_Estimation_Model/utils/draw_utils.py
:5-97 and ISM run_inference_custom.visualize): 3D bounding-box projection
for PEM, colored instance masks for ISM. The port's own copy of
`sam6d_tpu/eval/vis.py` (numpy and PIL)."""
from __future__ import annotations

from typing import List

import numpy as np
from PIL import Image, ImageDraw


def bbox_3d_corners(model_points: np.ndarray) -> np.ndarray:
    """(8, 3) axis-aligned bbox corners of the model cloud."""
    mn = model_points.min(0)
    mx = model_points.max(0)
    return np.array([
        [mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
        [mx[0], mx[1], mn[2]], [mn[0], mx[1], mn[2]],
        [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
        [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]],
    ])

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_pose_bbox(img: np.ndarray, R: np.ndarray, t: np.ndarray,
                   model_points: np.ndarray, K: np.ndarray,
                   color=(255, 0, 0)) -> np.ndarray:
    """Project the posed 3D bbox and draw its edges. Units: t and
    model_points in the same unit (mm in the reference outputs)."""
    corners = bbox_3d_corners(model_points)
    cam = corners @ R.T + t[None]
    uv = cam @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
    im = Image.fromarray(img.astype(np.uint8))
    d = ImageDraw.Draw(im)
    for a, b in _EDGES:
        d.line([tuple(uv[a]), tuple(uv[b])], fill=color, width=2)
    for p in uv:
        d.ellipse([p[0] - 2, p[1] - 2, p[0] + 2, p[1] + 2], fill=color)
    return np.asarray(im)


def draw_detections_masks(img: np.ndarray, masks: np.ndarray,
                          valid: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """Overlay instance masks with distinct colors (vis_ism style)."""
    rng = np.random.RandomState(0)
    out = img.astype(np.float32).copy()
    for i in range(len(masks)):
        if not valid[i]:
            continue
        color = rng.randint(64, 255, 3).astype(np.float32)
        m = masks[i] > 0.5
        out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def side_by_side(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    h = max(left.shape[0], right.shape[0])
    w = left.shape[1] + right.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: left.shape[0], : left.shape[1]] = left
    canvas[: right.shape[0], left.shape[1]:] = right
    return canvas
