"""Batched image ops of the ISM proposal path (port of
`sam6d_tpu/ops/images.py`).

The reference's CropResizePad loops over proposals with two cascaded
`F.interpolate(..., scale_factor=...)` calls in nearest mode
(`Instance_Segmentation_Model/utils/bbox_utils.py:98-126`). Here the two
nearest mappings and the centre padding compose into one source index per
output pixel, and all boxes resolve in one gather.

Bit-exactness with the JAX package: the scale is the correctly rounded
float32 quotient target / longest side, and `floor(size * scale)` /
`floor(dst / scale)` are the exact floors against it, computed in float32
with Veltkamp split products and candidate testing. Each step below is its
own float32 tensor op on purpose: fusing them (one expression compiled into
a kernel, an FMA, or float64) would change the rounding the proof rests on.
(The reference writes the scale as `target / tensor`, which torch evaluates
as target * (1 / side); for 120 of the sides 1..480 that differs from the
quotient in the last place.)
"""
from __future__ import annotations

import torch


def _split_mul(m: torch.Tensor, p: torch.Tensor):
    """Exact product m*p = a + b for integer-valued f32 m (|m| < 2^12) and
    f32 p: Veltkamp split of p into 12-bit halves."""
    c = p * 4097.0
    p_hi = c - (c - p)
    p_lo = p - p_hi
    return m * p_hi, m * p_lo


def _floor_mul_f32(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """floor(m * p) computed exactly (m integer-valued f32, p f32 > 0)."""
    a, b = _split_mul(m, p)
    est = torch.floor(a + b)

    def le(c):  # c <= m*p  <=>  (c - a) <= b   (c - a exact by Sterbenz)
        return (c - a) <= b

    return torch.where(le(est + 1.0), est + 1.0,
                       torch.where(le(est), est, est - 1.0))


def _floor_div_f32(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """floor(d / p) exactly: largest integer m with m*p <= d (d, p f32 >= 0)."""
    est = torch.floor(d / p)

    def le(m):  # m*p <= d  <=>  (a - d) <= -b
        a, b = _split_mul(m, p)
        return (a - d) <= -b

    return torch.where(le(est + 1.0), est + 1.0,
                       torch.where(le(est), est, est - 1.0))


def _source_indices(boxes: torch.Tensor, H: int, W: int, target: int):
    """Per box, the source row and column of every output pixel and whether
    it lies inside the resized crop (not padding).

    boxes (N, 4) xyxy -> (ys (N, T), xs (N, T) long, inside (N, T, T) bool)."""
    boxes = boxes.to(torch.int32)
    x1, y1 = boxes[:, 0], boxes[:, 1]
    hi = boxes[:, 3] - y1
    wi = boxes[:, 2] - x1
    h = hi.to(torch.float32)
    w = wi.to(torch.float32)
    # correctly rounded f32 division, as the JAX package computes it (a
    # Python scalar over a tensor would be 224 * (1 / side) in torch)
    scale = torch.full_like(h, float(target)) / torch.maximum(h, w)
    h1 = _floor_mul_f32(h, scale).to(torch.int32)  # stage-1 output size
    w1 = _floor_mul_f32(w, scale).to(torch.int32)
    square = hi == wi
    zero = torch.zeros_like(h1)
    pad_top = torch.where(square, zero, torch.clamp((target - h1) // 2, min=0))
    pad_left = torch.where(square, zero, torch.clamp((target - w1) // 2, min=0))
    # stage-2 input size: h1 in the square branch (resize h1 -> target),
    # target in the padded branch (identity resize)
    size2_h = torch.where(square, h1, torch.full_like(h1, target))
    size2_w = torch.where(square, w1, torch.full_like(w1, target))

    out_idx = torch.arange(target, dtype=torch.int32, device=boxes.device)[None]

    def axis(start, extent, size1, size2, pad, limit):
        # stage 2 (nearest, exact by margin): idx = floor(dst * size2 / target)
        unpad = (out_idx * size2[:, None]) // target - pad[:, None]
        inside = (unpad >= 0) & (unpad < size1[:, None])
        # stage 1 (nearest vs the f32 scale): src = floor(dst / scale)
        src = _floor_div_f32(unpad.to(torch.float32), scale[:, None]).to(torch.int32)
        src = torch.minimum(torch.clamp(src, min=0),
                            torch.clamp(extent - 1, min=0)[:, None]) + start[:, None]
        return torch.clamp(src, 0, limit - 1).long(), inside

    ys, y_in = axis(y1, hi, h1, size2_h, pad_top, H)
    xs, x_in = axis(x1, wi, w1, size2_w, pad_left, W)
    return ys, xs, y_in[:, :, None] & x_in[:, None, :]


def crop_resize_pad_nearest(image: torch.Tensor, boxes: torch.Tensor,
                            target: int = 224) -> torch.Tensor:
    """Crop each box, nearest-resize so the longest side = target, centre-pad
    to (target, target): the reference's CropResizePad with the scale
    rounded as in the JAX package.

    image (H, W, C) float; boxes (N, 4) int/float xyxy -> (N, T, T, C)."""
    H, W, _ = image.shape
    ys, xs, inside = _source_indices(boxes, H, W, target)
    patch = image[ys[:, :, None], xs[:, None, :]]
    return patch * inside.to(image.dtype)[..., None]


def crop_resize_pad_nearest_stack(images: torch.Tensor, boxes: torch.Tensor,
                                  target: int = 224) -> torch.Tensor:
    """crop_resize_pad_nearest of each image of a stack with its own box:
    images (T, H, W, C), boxes (T, 4) -> (T, target, target, C)."""
    T, H, W, _ = images.shape
    ys, xs, inside = _source_indices(boxes, H, W, target)
    t = torch.arange(T, device=images.device)[:, None, None]
    patch = images[t, ys[:, :, None], xs[:, None, :]]
    return patch * inside.to(images.dtype)[..., None]


def masked_crop_resize_pad_nearest(image: torch.Tensor, masks: torch.Tensor,
                                   boxes: torch.Tensor, target: int = 224):
    """crop_resize_pad_nearest(image * mask_p, box_p) and
    crop_resize_pad_nearest(mask_p, box_p) for every proposal p, gathered
    from the one (H, W, C) frame and the (N, H, W) masks: the (N, H, W, C)
    masked-image stack is never made.

    Returns (crops (N, T, T, C), mask_crops (N, T, T))."""
    H, W, _ = image.shape
    ys, xs, inside = _source_indices(boxes, H, W, target)
    n = torch.arange(masks.shape[0], device=masks.device)[:, None, None]
    mask_patch = (masks[n, ys[:, :, None], xs[:, None, :]].to(image.dtype)
                  * inside.to(image.dtype))
    rgb_patch = image[ys[:, :, None], xs[:, None, :]] * mask_patch[..., None]
    return rgb_patch, mask_patch


def normalize_imagenet(rgb: torch.Tensor) -> torch.Tensor:
    """float [0,1] (..., 3) -> ImageNet-normalized."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=rgb.dtype, device=rgb.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=rgb.dtype, device=rgb.device)
    return (rgb - mean) / std
