"""Host-side instance/template preprocessing for PEM (numpy).

The port's own copy of `sam6d_tpu/data/preprocess.py`, kept verbatim so the
random draws are bit-identical. Behaviour parity with reference
`Pose_Estimation_Model/utils/data_utils.py` (get_bbox :126-160,
get_resize_rgb_choose :113-123) and the per-instance assembly of
`run_inference_custom.py:117-253`. The bilinear resize replicates
cv2.INTER_LINEAR (half-pixel centers) since cv2 is not a dependency.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.INTER_LINEAR-equivalent resize. img: (H, W[, C]) -> (out_h, out_w[, C])."""
    H, W = img.shape[:2]
    sy, sx = H / out_h, W / out_w
    fy = (np.arange(out_h, dtype=np.float64) + 0.5) * sy - 0.5
    fx = (np.arange(out_w, dtype=np.float64) + 0.5) * sx - 0.5
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    wy = (fy - y0).astype(np.float32)
    wx = (fx - x0).astype(np.float32)
    y0c = np.clip(y0, 0, H - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    x0c = np.clip(x0, 0, W - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    im = img.astype(np.float32)
    Ia = im[y0c][:, x0c]
    Ib = im[y0c][:, x1c]
    Ic = im[y1c][:, x0c]
    Id = im[y1c][:, x1c]
    wy_ = wy[:, None] if img.ndim == 2 else wy[:, None, None]
    wx_ = wx[None, :] if img.ndim == 2 else wx[None, :, None]
    top = Ia * (1 - wx_) + Ib * wx_
    bot = Ic * (1 - wx_) + Id * wx_
    out = top * (1 - wy_) + bot * wy_
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.round(out), np.iinfo(img.dtype).min,
                       np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def get_bbox_square(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Square crop box [rmin, rmax, cmin, cmax] around a binary mask
    (reference get_bbox, data_utils.py:126-160)."""
    H, W = mask.shape
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rmax += 1
    cmax += 1
    b = min(max(rmax - rmin, cmax - cmin), min(H, W))
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin = center[0] - int(b / 2)
    rmax = center[0] + int(b / 2)
    cmin = center[1] - int(b / 2)
    cmax = center[1] + int(b / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > H:
        rmin -= rmax - H
        rmax = H
    if cmax > W:
        cmin -= cmax - W
        cmax = W
    return int(rmin), int(rmax), int(cmin), int(cmax)


def get_resize_rgb_choose(choose: np.ndarray, bbox, img_size: int) -> np.ndarray:
    """Remap flat crop-pixel indices to flat resized-image indices
    (reference data_utils.py:113-123)."""
    rmin, rmax, cmin, cmax = bbox
    crop_h = rmax - rmin
    crop_w = cmax - cmin
    ratio_h = img_size / crop_h
    ratio_w = img_size / crop_w
    row_idx = choose // crop_w
    col_idx = choose % crop_w
    return (np.floor(row_idx * ratio_h) * img_size
            + np.floor(col_idx * ratio_w)).astype(np.int64)


def normalize_rgb(rgb: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC, /255, ImageNet-normalized (torchvision
    ToTensor + Normalize of the reference rgb_transform)."""
    x = rgb.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def choose_sample(n_valid: int, n_sample: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """Index subset of size n_sample from [0, n_valid): without replacement
    when possible (reference run_inference_custom.py:223-227)."""
    if n_valid <= n_sample:
        return rng.choice(np.arange(n_valid), n_sample)
    return rng.choice(np.arange(n_valid), n_sample, replace=False)


def prepare_instance(
    whole_image: np.ndarray,
    whole_pts: np.ndarray,
    mask: np.ndarray,
    radius: float,
    img_size: int,
    n_sample: int,
    rng: np.random.RandomState,
    rgb_mask_flag: bool = True,
    bgr: bool = True,
):
    """Assemble one PEM instance from a frame + instance mask.

    whole_image: (H, W, 3) uint8 RGB; whole_pts: (H, W, 3) camera cloud (m);
    mask: (H, W) bool (already ANDed with depth > 0).
    Returns dict(rgb (S,S,3) float32 normalized, pts (n_sample,3),
    rgb_choose (n_sample,)) or None if degenerate — the exact filtering
    cascade of run_inference_custom.py:193-236. NOTE the reference flips the
    crop to BGR (`[:, :, ::-1]`, :231) for both queries and templates, so the
    released PEM weights expect BGR channel order; `bgr=True` replicates it.
    """
    if mask.sum() <= 32:
        return None
    bbox = get_bbox_square(mask)
    y1, y2, x1, x2 = bbox
    crop_mask = mask[y1:y2, x1:x2]
    choose = crop_mask.astype(np.float32).flatten().nonzero()[0]

    cloud = whole_pts[y1:y2, x1:x2, :].reshape(-1, 3)[choose, :]
    center = cloud.mean(axis=0)
    flag = np.linalg.norm(cloud - center[None, :], axis=1) < radius * 1.2
    if flag.sum() < 4:
        return None
    choose = choose[flag]
    cloud = cloud[flag]

    idx = choose_sample(len(choose), n_sample, rng)
    choose = choose[idx]
    cloud = cloud[idx]

    rgb = whole_image[y1:y2, x1:x2, :]
    if bgr:
        rgb = rgb[:, :, ::-1]
    if rgb_mask_flag:
        rgb = rgb * (crop_mask[:, :, None] > 0).astype(np.uint8)
    rgb = bilinear_resize(rgb, img_size, img_size)
    rgb = normalize_rgb(rgb)
    rgb_choose = get_resize_rgb_choose(choose, bbox, img_size)
    return dict(rgb=rgb, pts=cloud.astype(np.float32), rgb_choose=rgb_choose)


def prepare_template(
    rgb: np.ndarray,
    mask: np.ndarray,
    xyz: np.ndarray,
    img_size: int,
    n_sample: int,
    rng: np.random.RandomState,
    rgb_mask_flag: bool = True,
    bgr: bool = True,
):
    """Assemble one rendered template view (reference _get_template :117-146).

    rgb: (H, W, 3) uint8; mask: (H, W) bool; xyz: (H, W, 3) NOCS/model
    coords in meters. Returns dict(rgb, choose, pts). `bgr` matches the
    reference's channel flip (:130).
    """
    bbox = get_bbox_square(mask)
    y1, y2, x1, x2 = bbox
    m = mask[y1:y2, x1:x2]
    r = rgb[y1:y2, x1:x2, :]
    if bgr:
        r = r[:, :, ::-1]
    if rgb_mask_flag:
        r = r * (m[:, :, None] > 0).astype(np.uint8)
    r = normalize_rgb(bilinear_resize(r, img_size, img_size))

    choose = (m > 0).astype(np.float32).flatten().nonzero()[0]
    idx = choose_sample(len(choose), n_sample, rng)
    choose = choose[idx]
    pts = xyz[y1:y2, x1:x2, :].reshape(-1, 3)[choose, :]
    rgb_choose = get_resize_rgb_choose(choose, bbox, img_size)
    return dict(rgb=r, choose=rgb_choose, pts=pts.astype(np.float32))
