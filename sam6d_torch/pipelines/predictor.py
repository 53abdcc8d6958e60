"""Prompted SAM predictor: embed one image once, decode many prompts.

Port of `sam6d_tpu/pipelines/predictor.py`, the API of the reference
`segment_anything/predictor.py` SamPredictor (:17-269): `set_image` runs the
image encoder once (on the card, its 32 attentions through the rel-pos
kernel) and keeps the embedding; `predict` decodes point and/or box prompts,
optionally with the low-res logits of an earlier call as the mask input.
The automatic mask generator (`sam_amg.py`) is the batch path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image

from .sam_amg import SAMSegmentor, bilinear_matrix, get_preprocess_shape, resize_logits


@torch.inference_mode()
def decode_prompts(sam, embedding: torch.Tensor, pts=None, labels=None, boxes=None,
                   mask_input=None, Ry=None, Rx=None):
    """One prompt set against an image embedding (g, g, C) on `sam`'s device:
    pts (1, N, 2) and labels (1, N), and/or boxes (1, 4), in the encoder
    frame; mask_input (1, 4g, 4g, 1) low-res logits. Returns (masks (1, 4,
    H0, W0) logits through the composed bilinear matrices Ry (H0, 4g), Rx
    (W0, 4g); iou (1, 4); low-res logits (1, 4, 4g, 4g)), channel 0 the
    single-mask output."""
    sparse, dense = sam.prompt_encoder(pts, labels, boxes, mask_input)
    if mask_input is not None:
        dense = dense[0]            # one prompt set: a shared (h, w, C) dense
    low, iou = sam.mask_decoder(embedding, sam.prompt_encoder.dense_pe(), sparse, dense)
    return resize_logits(low, Ry, Rx), iou, low


class SAMPredictor:
    """Prompted segmentation on a SAMSegmentor's network and device."""

    def __init__(self, segmentor: SAMSegmentor):
        self.seg = segmentor
        self.embedding: Optional[torch.Tensor] = None
        self.geometry = None        # (H0, W0, h_in, w_in)

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """Embed an (H0, W0, 3) uint8 RGB image (reference set_image): PIL
        bilinear resize of the longest side to the encoder size; the SAM
        normalization and the zero padding run on the device."""
        cfg = self.seg.cfg
        H0, W0 = image.shape[:2]
        h_in, w_in = get_preprocess_shape(H0, W0, cfg.img_size)
        resized = np.array(Image.fromarray(image).resize((w_in, h_in), Image.BILINEAR),
                           np.uint8)
        self.embedding = self.seg._encode_u8(torch.as_tensor(resized, device=self.seg.device))
        self.geometry = (H0, W0, h_in, w_in)

    def prompt_tensors(self, point_coords=None, point_labels=None, box=None,
                       mask_input=None):
        """The prompts in the encoder frame and the postprocess matrices, on
        the device: dict(pts, labels, boxes, mask_input, Ry, Rx)."""
        H0, W0, h_in, w_in = self.geometry
        cfg = self.seg.cfg
        dev = self.seg.device
        scale = np.array([w_in / W0, h_in / H0], np.float32)
        out = dict(pts=None, labels=None, boxes=None, mask_input=None)
        if point_coords is not None:
            out["pts"] = torch.as_tensor(
                np.asarray(point_coords, np.float32)[None] * scale, device=dev)
            out["labels"] = torch.as_tensor(
                np.asarray(point_labels, np.int64)[None], device=dev)
        if box is not None:
            b = np.asarray(box, np.float32).reshape(4)
            out["boxes"] = torch.as_tensor((b * np.concatenate([scale, scale]))[None],
                                           device=dev)
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            out["mask_input"] = torch.as_tensor(
                m.reshape(m.shape[-2], m.shape[-1])[None, :, :, None], device=dev)
        R1 = bilinear_matrix(cfg.img_size, cfg.img_size // 4)
        out["Ry"] = torch.as_tensor(bilinear_matrix(H0, h_in) @ R1[:h_in], device=dev)
        out["Rx"] = torch.as_tensor(bilinear_matrix(W0, w_in) @ R1[:w_in], device=dev)
        return out

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False):
        """Reference SamPredictor.predict (predictor.py:92-167).

        point_coords (N, 2) xy and box (4,) xyxy in the original image's
        pixels, point_labels (N,) in {0, 1}; mask_input (1, 256, 256)
        low-res logits of an earlier call. Returns (masks (3|1, H0, W0) bool,
        or logits with `return_logits`; iou predictions (3|1,); low-res
        logits (3|1, 256, 256), row-major, for the next call's
        mask_input)."""
        if self.embedding is None:
            raise RuntimeError("call set_image first")
        if point_coords is None and box is None:
            raise ValueError("at least one of point_coords / box is required")
        hi, iou, low = decode_prompts(self.seg.sam, self.embedding,
                                      **self.prompt_tensors(point_coords, point_labels,
                                                            box, mask_input))
        sl = slice(1, None) if multimask_output else slice(0, 1)
        m = hi[0, sl]
        m = m.float() if return_logits else m > 0.0
        # float32 on the host whatever the segmentor's dtype
        return m.cpu().numpy(), iou[0, sl].float().cpu().numpy(), low[0, sl].float().cpu().numpy()
