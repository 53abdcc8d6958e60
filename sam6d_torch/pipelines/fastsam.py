"""FastSAM segmentor: letterbox -> YOLOv8-seg -> top-k -> box NMS -> masks.

Port of `sam6d_tpu/pipelines/fastsam.py` (reference FastSAM wrapper,
model/fast_sam.py:74-128): fixed-capacity proposals with validity flags,
in the SAM segmentor's contracts:

- `generate_masks` (host): masks (max_det, H0, W0) float 0/1, boxes xyxy
  in original coordinates, `valid`, `iou_preds` = the class scores;
- `generate_masks_device` (device tensors): masks (max_det, H0, W0) bool,
  the same boxes, `valid`, `iou_preds`, `orig_size == seg_size == (H0,
  W0)`, so that `ISMPipeline.match_frame(detections=None)` takes FastSAM
  as it takes SAM and the masks stay on the device up to the describe.

The host letterboxes the frame (long side to `imgsz`, Python's half-even
`round`, the cv2-equivalent bilinear resize) and uploads uint8; scaling to
[0, 1] and the 114/255 padding run on the device. Top-k takes a stable sort
(ties to the lower index, as `jax.lax.top_k`); box NMS is the masked fixed
point over an all-true group, one launch of the NMS kernel on the card
(`ops/masks.nms_masked_device`; rounds in `last_nms_rounds`, a device
int32), and `generate_masks_device` reads nothing back. Mask assembly
keeps the JAX contract: sigmoid(coefs . protos) cropped to the box at
proto resolution (`>=`, `<` on pixel indices), bilinearly resized to
(H0, W0) and thresholded after the resize; slots NMS did not keep keep
their masks (only `valid` marks them).

`dtype=torch.bfloat16` runs the network in bf16 (weights cast by
`core/params.cast_float_params`; the convolutions stay cuDNN's, as JAX
leaves them to XLA); its outputs are cast to float32 before the decode's
selection, NMS and mask assembly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import use_strict_fp32
from ..core.config import FastSAMConfig
from ..core.params import cast_float_params
from ..core.uploads import device_constant, upload
from ..data.preprocess import bilinear_resize
from ..models.fastsam import FastSAMNet
from ..ops.masks import box_iou, nms_masked_device
from ..weights.fastsam import fastsam_arch, random_fastsam_state_dict
from .sam_amg import bilinear_matrix, resize_logits, stable_top_k

__all__ = ["FastSAMConfig", "FastSAMSegmentor"]

FASTSAM_X = ((80, 160, 320, 640, 640), (3, 6, 6, 3))


class FastSAMSegmentor:
    """FastSAM over a fixed proposal capacity, on one device.

    `state_dict`: port-named weights (`weights/fastsam.py`); its widths and
    depths set the network's, unless given. None = seeded random FastSAM-x
    (or `widths`/`depths`), drawn on the device. `dtype`: the compute dtype
    (float32, or bfloat16: the weights are cast to it)."""

    def __init__(self, cfg: FastSAMConfig = FastSAMConfig(), state_dict=None,
                 seed: int = 0, device="cuda", widths=None, depths=None,
                 dtype: torch.dtype = torch.float32):
        use_strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        if state_dict is not None and (widths is None or depths is None):
            widths, depths = fastsam_arch(state_dict)
        widths = tuple(widths or FASTSAM_X[0])
        depths = tuple(depths or FASTSAM_X[1])
        with torch.device("meta"):
            net = FastSAMNet(widths=widths, depths=depths)
        if state_dict is None:
            state_dict = random_fastsam_state_dict(net, seed, self.device)
        net = net.to_empty(device=self.device)
        net.load_state_dict(state_dict, strict=True)
        self.net = cast_float_params(net, dtype).eval()
        self.last_nms_rounds = 0

    # -------------------------------------------------------------- stages

    def letterbox_u8(self, image: np.ndarray):
        """(H0, W0, 3) uint8 -> (the frame resized so that its long side is
        imgsz, uint8 (h_in, w_in, 3); scale; (h_in, w_in))."""
        H0, W0 = image.shape[:2]
        scale = self.cfg.imgsz / max(H0, W0)
        h_in, w_in = int(round(H0 * scale)), int(round(W0 * scale))
        return bilinear_resize(image, h_in, w_in), scale, (h_in, w_in)

    def canvas(self, resized_u8: torch.Tensor) -> torch.Tensor:
        """(h_in, w_in, 3) uint8 on the device -> (1, 3, imgsz, imgsz) in
        [0, 1], padded bottom and right with 114/255."""
        S = self.cfg.imgsz
        h_in, w_in = resized_u8.shape[:2]
        x = torch.full((S, S, 3), 114 / 255.0, dtype=torch.float32, device=self.device)
        x[:h_in, :w_in] = resized_u8.to(torch.float32) / 255.0
        return x.permute(2, 0, 1)[None]

    def select(self, preds: torch.Tensor):
        """Decoded predictions (A, 4 + 1 + nm) of one image -> the top
        max_det by class score: (boxes (D, 4) in letterbox pixels, scores
        (D,), NMS keep (D,), mask coefficients (D, nm))."""
        cfg = self.cfg
        scores = preds[:, 4]
        top = stable_top_k(scores, cfg.max_det)
        boxes, top_scores, coefs = preds[top, :4], scores[top], preds[top, 5:]
        valid = top_scores > cfg.conf_thresh
        same = torch.ones((len(top), len(top)), dtype=torch.bool, device=preds.device)
        keep, self.last_nms_rounds = nms_masked_device(
            box_iou(boxes, boxes), top_scores, valid, same, cfg.iou_thresh)
        return boxes, top_scores, keep, coefs

    def assemble(self, boxes, coefs, protos, h_in: int, w_in: int, H0: int, W0: int):
        """Mask probabilities at (H0, W0) before the threshold:
        sigmoid(coefs . protos) (D, Hp, Wp), zeroed outside each box at
        proto resolution, cropped to the letterboxed frame's (hp, wp) and
        bilinearly resized."""
        nm, Hp, Wp = protos.shape
        m = torch.sigmoid((coefs @ protos.reshape(nm, Hp * Wp)).reshape(-1, Hp, Wp))
        bx = boxes * (Hp / self.cfg.imgsz)
        ys = torch.arange(Hp, dtype=torch.float32, device=m.device)[None, :, None]
        xs = torch.arange(Wp, dtype=torch.float32, device=m.device)[None, None, :]
        inside = ((xs >= bx[:, 0, None, None]) & (xs < bx[:, 2, None, None])
                  & (ys >= bx[:, 1, None, None]) & (ys < bx[:, 3, None, None]))
        m = m * inside
        hp, wp = max(int(round(h_in / 4)), 1), max(int(round(w_in / 4)), 1)
        dev = m.device
        return resize_logits(
            m[:, :hp, :wp],
            device_constant(("bilinear", H0, hp), lambda: bilinear_matrix(H0, hp), dev),
            device_constant(("bilinear", W0, wp), lambda: bilinear_matrix(W0, wp), dev))

    def original_boxes(self, boxes, scale: float, H0: int, W0: int):
        """Letterbox-pixel boxes -> original coordinates, clipped to
        [0, W0 - 1] x [0, H0 - 1]."""
        out = boxes / torch.full((), scale, dtype=torch.float32, device=boxes.device)
        lim = device_constant(("box_limits", H0, W0),
                              lambda: np.array([W0 - 1, H0 - 1, W0 - 1, H0 - 1]), boxes.device,
                              torch.float32)
        return torch.minimum(out.clamp(min=0), lim)

    # ------------------------------------------------------------------ API

    @torch.inference_mode()
    def generate_masks_device(self, image: np.ndarray) -> Dict:
        """Device-resident FastSAM of one (H0, W0, 3) uint8 RGB frame: masks
        (D, H0, W0) bool, boxes (D, 4) xyxy in original coordinates, valid
        (D,), iou_preds (D,) (class scores), and the frame geometry
        (orig_size == seg_size == (H0, W0))."""
        H0, W0 = image.shape[:2]
        resized, scale, (h_in, w_in) = self.letterbox_u8(image)
        canvas = self.canvas(upload(resized, self.device)).to(self.dtype)
        preds, protos = (t.to(torch.float32) for t in self.net(canvas))
        boxes, scores, keep, coefs = self.select(preds[0])
        probs = self.assemble(boxes, coefs, protos[0], h_in, w_in, H0, W0)
        return dict(masks=probs > self.cfg.mask_thresh,
                    boxes=self.original_boxes(boxes, scale, H0, W0), valid=keep,
                    iou_preds=scores, orig_size=(H0, W0), seg_size=(H0, W0))

    def generate_masks(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """image (H0, W0, 3) uint8 RGB -> host dict(masks (D, H0, W0) float
        0/1, boxes (D, 4) xyxy in original coordinates, valid (D,),
        iou_preds (D,)), D = max_det."""
        dev = self.generate_masks_device(image)
        return dict(masks=dev["masks"].to(torch.float32).cpu().numpy(),
                    boxes=dev["boxes"].cpu().numpy(), valid=dev["valid"].cpu().numpy(),
                    iou_preds=dev["iou_preds"].cpu().numpy())
