"""SAM automatic mask generation on the card: a frame's RGB -> a fixed
capacity of proposals (masks, xyxy boxes, valid, predicted IoU).

Port of `sam6d_tpu/pipelines/sam_amg.py` (reference
`CustomSamAutomaticMaskGenerator`, model/sam.py:52-148, and
`SamAutomaticMaskGenerator._process_batch`,
segment_anything/automatic_mask_generator.py:266-321):

- the host resizes the frame to the segmentor width and to the encoder
  frame (PIL bilinear, as the reference) and uploads uint8; normalization
  and padding to the 1024^2 canvas run on the card;
- the exact iou-prefix pass scores every grid prompt's predicted IoU with
  the factored two-way transformer (the three factored kernels), then the
  full decode, stability and boxes run only for the top points;
- mask postprocessing (256^2 logits -> 1024^2 -> crop -> segmentor size)
  is one composed pair of bilinear matrices per axis;
- box NMS is the port's masked fixed point, one launch of the NMS kernel
  on the card (`ops/masks.nms_masked_device`; rounds in `last_nms_rounds`,
  a device int32); the frame and the constants are uploaded without
  waiting (`core/uploads.py`), so `generate_masks_device` reads nothing
  back; on the card the encoder and the AMG tail of a frame geometry run
  as one captured CUDA graph (`_frame_graph`).

Top-k selections take a stable descending sort, so ties go to the lower
index as `jax.lax.top_k` breaks them (`torch.topk` promises no order among
ties). The host AMG (`generate_masks`) also runs the crop cascade
(`crop_n_layers > 0`: `generate_masks_cropped`) and the small-region
cleanup (`min_mask_region_area > 0`, `data/regions.py`), both off at the
reference operating point; as in the JAX package, the device AMG
(`generate_masks_device`) runs neither. `_masks_for` is the
channel-selected re-decode, and `truncation_divergence` counts how far the
iou prefix and the NMS top-k move the kept set on a frame. Left out: the
pre-rank pass.

`dtype=torch.bfloat16` runs SAM in bf16 (weights cast by
`core/params.cast_float_params`, as the JAX segmentor does): the uint8
frame is normalised in fp32 on the device and cast where it enters the
patch embedding; the postprocess matrices are cast to the logits' dtype
(JAX's choice: the fp32 product would materialise the logits at twice the
bytes); the predicted IoUs leave the segmentor as float32.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from PIL import Image

from .. import use_strict_fp32
from ..core.config import SAMConfig
from ..core.params import cast_float_params
from ..core.uploads import device_constant, upload
from ..data.preprocess import bilinear_resize
from ..data.regions import postprocess_small_regions
from ..kernels.graphs import StaticGraph
from ..models.sam import SAM
from ..ops.masks import box_iou, masks_to_boxes, nms_masked_device
from ..weights.sam import random_sam_state_dict

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) grid in [0,1]^2, xy order (reference amg.py:179-187)."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    x = np.tile(pts[None, :], (n_per_side, 1))
    y = np.tile(pts[:, None], (1, n_per_side))
    return np.stack([x, y], axis=-1).reshape(-1, 2)


def bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) separable bilinear weights, half-pixel convention
    (= F.interpolate mode='bilinear', align_corners=False)."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i0c = np.clip(i0, 0, in_size - 1)
    i1c = np.clip(i0 + 1, 0, in_size - 1)
    M = np.zeros((out_size, in_size), np.float32)
    M[np.arange(out_size), i0c] += (1 - frac).astype(np.float32)
    M[np.arange(out_size), i1c] += frac.astype(np.float32)
    return M


def get_preprocess_shape(oldh: int, oldw: int, long_side: int):
    """ResizeLongestSide target (reference transforms.py)."""
    scale = long_side / max(oldh, oldw)
    return int(oldh * scale + 0.5), int(oldw * scale + 0.5)


def stable_top_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the 1-D `key`, ties to the lower
    index (jax.lax.top_k's order)."""
    return torch.sort(key, descending=True, stable=True).indices[:k]


def resize_logits(masks: torch.Tensor, Ry: torch.Tensor, Rx: torch.Tensor) -> torch.Tensor:
    """(..., h, w) -> (..., Hs, Ws) through the composed bilinear matrices
    Ry (Hs, h), Rx (Ws, w), taken in the masks' dtype."""
    return Ry.to(masks.dtype) @ masks @ Rx.to(masks.dtype).T


class SAMSegmentor:
    """SAM AMG over a fixed proposal capacity, on one device.

    `state_dict`: SAM weights under the reference names; None = seeded
    random, drawn on the device. `dtype`: the compute dtype (float32, or
    bfloat16: the weights are cast to it)."""

    def __init__(self, cfg: SAMConfig, state_dict=None, seed: int = 0,
                 device="cuda", dtype: torch.dtype = torch.float32):
        use_strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        with torch.device("meta"):
            net = SAM(cfg)
        if state_dict is None:
            state_dict = random_sam_state_dict(net, seed, self.device)
        net = net.to_empty(device=self.device)
        net.load_state_dict(state_dict, strict=True)
        self.sam = cast_float_params(net, dtype).eval()
        self.points = build_point_grid(cfg.points_per_side)
        self.last_nms_rounds = 0
        self.last_prefix = 0
        self._frame_constants = {}
        self._frame_graphs = {}

    # -------------------------------------------------------------- internals

    def _encode_u8(self, u8: torch.Tensor) -> torch.Tensor:
        """(h_in, w_in, 3) uint8 on the device -> (g, g, C) embedding:
        SAM normalization and zero padding to the square canvas here."""
        dev = self.device
        mean = device_constant("sam_pixel_mean", lambda: SAM_PIXEL_MEAN, dev)
        std = device_constant("sam_pixel_std", lambda: SAM_PIXEL_STD, dev)
        x = (u8.to(torch.float32) - mean) / std
        S = self.cfg.img_size
        x = torch.nn.functional.pad(x, (0, 0, 0, S - u8.shape[1], 0, S - u8.shape[0]))
        return self.sam.image_encoder(x[None])[0]

    def _decode_chunk(self, embedding, dense_pe, pts, iou_only: bool = False,
                      sel_channel=None):
        """pts (chunk, 2) in the encoder frame -> (masks (chunk, 3, 4g, 4g)
        logits of the three multimask channels, or None with `iou_only`;
        iou (chunk, 3)). With `sel_channel` (chunk,) in {0, 1, 2}, only that
        multimask channel is decoded: masks (chunk, 1, 4g, 4g)."""
        labels = torch.ones((pts.shape[0], 1), dtype=torch.int64, device=pts.device)
        sparse, dense = self.sam.prompt_encoder(pts[:, None, :], labels)
        masks, iou = self.sam.mask_decoder(
            embedding, dense_pe, sparse, dense, iou_only=iou_only,
            sel_channel=None if sel_channel is None else sel_channel + 1)
        if masks is not None and sel_channel is None:
            masks = masks[:, 1:]
        return masks, iou[:, 1:]

    def _score_all_impl(self, embedding, dense_pe, points, Ry, Rx):
        """Every prompt decoded in chunks: (iou (3P,), stability (3P,), boxes
        (3P, 4) at segmentor resolution, low-res logits (3P, 4g, 4g)) in
        candidate order (prompt-major, channel-minor)."""
        cfg = self.cfg
        chunk = cfg.points_per_batch
        off = cfg.stability_score_offset
        out = ([], [], [], [])
        for c in range(0, points.shape[0], chunk):
            masks, iou = self._decode_chunk(embedding, dense_pe, points[c:c + chunk])
            hi = resize_logits(masks, Ry, Rx)               # (chunk, 3, Hs, Ws)
            inter = (hi > off).sum(dim=(-1, -2))
            union = (hi > -off).sum(dim=(-1, -2))
            stab = inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
            boxes = masks_to_boxes((hi > 0.0).flatten(0, 1))
            for lst, v in zip(out, (iou.reshape(-1), stab.reshape(-1), boxes,
                                    masks.flatten(0, 1))):
                lst.append(v)
        return tuple(torch.cat(v) for v in out)

    def _iou_all_impl(self, embedding, dense_pe, points):
        """Exact predicted IoU of every grid prompt from the factored
        token-side pass (no mask tail). Returns (P, 3)."""
        chunk = self.cfg.points_per_batch
        return torch.cat([self._decode_chunk(embedding, dense_pe, points[c:c + chunk],
                                             iou_only=True)[1]
                          for c in range(0, points.shape[0], chunk)])

    def prefix_length(self, n_points: int) -> int:
        """How many of `n_points` grid points the exact iou-prefix pass keeps:
        ceil(max_proposals * factor / chunk) chunks, or all of them (factor
        0, a ragged grid, or a prefix as long as the grid)."""
        cfg = self.cfg
        chunk = cfg.points_per_batch
        if cfg.amg_iou_prefix_factor > 0 and n_points % chunk == 0:
            pref = -(-int(cfg.max_proposals * cfg.amg_iou_prefix_factor) // chunk) * chunk
            return min(pref, n_points)
        return n_points

    def _prefix_points(self, embedding, dense_pe, points):
        """The top prefix_length points by max-channel predicted IoU from the
        factored token-side pass (greedy NMS keep decisions depend only on
        higher-IoU candidates)."""
        pref = self.prefix_length(points.shape[0])
        if pref == points.shape[0]:
            return points
        iou_a = self._iou_all_impl(embedding, dense_pe, points)
        return points[stable_top_k(iou_a.max(dim=1).values, pref)]

    def _select_impl(self, embedding, dense_pe, points, Ry, Rx):
        """Decode `points`, filter (pred-IoU, stability), box-NMS, select the
        top max_proposals. Returns (masks (K, Hs, Ws) bool, boxes (K, 4),
        valid (K,), iou (K,), the selected candidates' indices (K,))."""
        cfg = self.cfg
        chunk = cfg.points_per_batch
        P = self.last_prefix = points.shape[0]
        pad = (-P) % chunk      # a ragged last chunk repeats point 0
        if pad:
            points = torch.cat([points, points[:1].expand(pad, 2)])
        iou, stab, boxes, lows = (v[:3 * P] for v in self._score_all_impl(
            embedding, dense_pe, points, Ry, Rx))
        valid = (iou > cfg.pred_iou_thresh) & (stab >= cfg.stability_score_thresh)
        n_cand = iou.shape[0]
        T = min(cfg.amg_nms_topk or n_cand, n_cand)
        if T < n_cand:
            # greedy NMS keep decisions depend only on higher-scored
            # candidates: NMS over the top-T prefix equals the full run there
            top = stable_top_k(torch.where(valid, iou, torch.full_like(iou, -torch.inf)), T)
        else:
            top = torch.arange(n_cand, device=iou.device)
        iou_t, valid_t, boxes_t = iou[top], valid[top], boxes[top]
        same = torch.ones((T, T), dtype=torch.bool, device=iou.device)
        keep, self.last_nms_rounds = nms_masked_device(
            box_iou(boxes_t, boxes_t), iou_t, valid_t, same, cfg.box_nms_thresh)
        K = cfg.max_proposals
        order_t = stable_top_k(torch.where(keep, iou_t, torch.full_like(iou_t, -torch.inf)),
                               min(K, T))
        sel_valid = keep[order_t]
        if order_t.shape[0] < K:
            # fewer candidates than capacity: candidate 0, marked invalid
            padn = K - order_t.shape[0]
            order_t = torch.cat([order_t, order_t.new_zeros(padn)])
            sel_valid = torch.cat([sel_valid, sel_valid.new_zeros(padn)])
        order = top[order_t]
        # the kept low-res logits are gathered, not re-decoded
        masks = resize_logits(lows[order], Ry, Rx) > 0.0
        return masks, boxes[order], sel_valid, iou[order].to(torch.float32), order

    def _masks_for(self, embedding, sel_points, sel_channel, Ry, Rx):
        """Re-decode the masks of selected (point, channel) pairs: sel_points
        (K, 2) in the encoder frame, sel_channel (K,) multimask channels ->
        (K, hs, ws) bool, in chunks of points_per_batch (K a multiple of
        the chunk), each prompt decoding only its channel (JAX's
        _masks_for). The device AMG gathers the kept logits instead."""
        dense_pe = self.sam.prompt_encoder.dense_pe()
        K = sel_points.shape[0]
        chunk = min(self.cfg.points_per_batch, K)
        if K % chunk:
            raise ValueError(f"{K} selected prompts: not a multiple of the chunk {chunk}")
        return torch.cat([
            resize_logits(self._decode_chunk(embedding, dense_pe, sel_points[c:c + chunk],
                                             sel_channel=sel_channel[c:c + chunk])[0],
                          Ry, Rx)[:, 0] > 0.0
            for c in range(0, K, chunk)])

    def _propose_impl(self, embedding, points, Ry, Rx):
        """The AMG tail of one frame: iou prefix, then _select_impl. Returns
        (masks (K, Hs, Ws) bool, boxes (K, 4), valid (K,), iou (K,))."""
        dense_pe = self.sam.prompt_encoder.dense_pe()
        points = self._prefix_points(embedding, dense_pe, points)
        return self._select_impl(embedding, dense_pe, points, Ry, Rx)[:4]

    # ------------------------------------------------------------------ API

    def preprocess_frame_u8(self, image: np.ndarray):
        """Host preprocessing up to the resized uint8 image: pre-resize to the
        segmentor width (reference model/sam.py:77-83), then ResizeLongestSide
        with PIL bilinear (reference transforms.apply_image). Returns
        (resized, (H0, W0), (hs, ws), (h_in, w_in))."""
        cfg = self.cfg
        H0, W0 = image.shape[:2]
        hs = int(cfg.segmentor_width_size * H0 / W0)
        ws = cfg.segmentor_width_size
        img_s = bilinear_resize(image, hs, ws)
        h_in, w_in = get_preprocess_shape(hs, ws, cfg.img_size)
        resized = np.array(Image.fromarray(img_s).resize((w_in, h_in), Image.BILINEAR),
                           np.uint8)
        return resized, (H0, W0), (hs, ws), (h_in, w_in)

    def frame_constants(self, hs: int, ws: int, h_in: int, w_in: int, grid01=None):
        """(Ry (hs, 4g), Rx (ws, 4g), prompt coordinates (P, 2) in the encoder
        frame) on the device: the composed postprocess matrices (low-res ->
        canvas -> crop -> segmentor size) and the scaled point grid.
        `grid01` overrides the [0, 1]^2 prompt grid (the crop cascade's
        layers take coarser grids). Uploaded without waiting for the card;
        with the config's grid they are made once a frame geometry."""
        key = (hs, ws, h_in, w_in)
        if grid01 is None and key in self._frame_constants:
            return self._frame_constants[key]
        cfg = self.cfg
        low = cfg.img_size // 4
        R1 = bilinear_matrix(cfg.img_size, low)
        Ry = bilinear_matrix(hs, h_in) @ R1[:h_in]
        Rx = bilinear_matrix(ws, w_in) @ R1[:w_in]
        grid = self.points if grid01 is None else grid01
        pts = grid * np.array([ws, hs], np.float32) * np.array(
            [w_in / ws, h_in / hs], np.float32)
        dev = self.device
        consts = (upload(Ry, dev), upload(Rx, dev), upload(pts, dev, torch.float32))
        if grid01 is None:
            self._frame_constants[key] = consts
        return consts

    @torch.inference_mode()
    def generate_masks_device(self, image: np.ndarray, grid01=None) -> Dict:
        """Device-resident AMG of one (H0, W0, 3) uint8 RGB frame (prompt
        grid `grid01`, default the config's). Returns device tensors (masks
        (K, hs, ws) bool, boxes (K, 4) xyxy at the segmentor size, valid
        (K,), iou_preds (K,)) and the frame geometry (orig_size,
        seg_size)."""
        resized, (H0, W0), (hs, ws), (h_in, w_in) = self.preprocess_frame_u8(image)
        Ry, Rx, pts = self.frame_constants(hs, ws, h_in, w_in, grid01)
        u8 = upload(resized, self.device)
        if self.device.type == "cuda" and grid01 is None:
            masks, boxes, valid, iou = self._frame_graph(u8, Ry, Rx, pts).run(u8)
        else:
            masks, boxes, valid, iou = self._propose_impl(self._encode_u8(u8), pts, Ry, Rx)
        return dict(masks=masks, boxes=boxes, valid=valid, iou_preds=iou,
                    orig_size=(H0, W0), seg_size=(hs, ws))

    def _frame_graph(self, u8, Ry, Rx, pts) -> StaticGraph:
        """The encoder and the AMG tail of a frame geometry as one CUDA graph
        (kernels/graphs.StaticGraph): the work depends on the shapes alone,
        and as kernel launches a frame would queue thousands of them.
        Built at the geometry's first frame, for this config and dtype."""
        key = (tuple(u8.shape), tuple(Ry.shape), tuple(Rx.shape), self.cfg, self.dtype)
        g = self._frame_graphs.get(key)
        if g is None:
            g = self._frame_graphs[key] = StaticGraph(
                lambda x: self._propose_impl(self._encode_u8(x), pts, Ry, Rx), (u8,))
        return g

    def truncation_divergence(self, image: np.ndarray, grid01=None) -> Dict:
        """How far the AMG truncations move the result on one frame: this
        segmentor's configured pass (iou prefix, NMS top-k) against its
        exact twin (amg_iou_prefix_factor=0, amg_nms_topk=0; same weights)
        on `image`. Returns dict(n_kept_trunc, n_kept_full, n_differing,
        exact), n_differing counting the full run's kept (mask, box) pairs
        with no bit-identical pair in the truncated run (JAX's
        SAMSegmentor.truncation_divergence)."""
        dev_t = self.generate_masks_device(image, grid01)
        full = getattr(self, "_exact_twin", None)
        if full is None:
            # a shallow copy shares the network; only the config differs
            full = self._exact_twin = copy.copy(self)
            full.cfg = dataclasses.replace(self.cfg, amg_iou_prefix_factor=0.0,
                                           amg_nms_topk=0)
        dev_f = full.generate_masks_device(image, grid01)
        vt, vf = dev_t["valid"].cpu().numpy(), dev_f["valid"].cpu().numpy()
        mt, mf = dev_t["masks"].cpu().numpy()[vt], dev_f["masks"].cpu().numpy()[vf]
        bt, bf = dev_t["boxes"].cpu().numpy()[vt], dev_f["boxes"].cpu().numpy()[vf]
        n_diff = sum(not any(np.array_equal(bf[i], bt[j]) and np.array_equal(mf[i], mt[j])
                             for j in range(len(mt)))
                     for i in range(len(mf)))
        return dict(n_kept_trunc=int(vt.sum()), n_kept_full=int(vf.sum()),
                    n_differing=n_diff, exact=(n_diff == 0 and vt.sum() == vf.sum()))

    def generate_masks_cropped(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """Crop-cascade AMG (reference automatic_mask_generator.py:196-264):
        the full image and the (2^i)^2 overlapping crops of each layer i
        each run `generate_masks` with a grid of points_per_side /
        crop_n_points_downscale_factor^i points a side; the kept
        proposals, moved back into the frame, are merged by greedy box NMS
        preferring smaller crops (score 1 / crop area), and the top
        max_proposals survivors by predicted IoU fill the slots."""
        cfg = self.cfg
        H0, W0 = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            (H0, W0), cfg.crop_n_layers, cfg.crop_overlap_ratio)
        masks_l, boxes_l, iou_l, areas_l = [], [], [], []
        for (x0, y0, x1, y1), layer in zip(crop_boxes, layer_idxs):
            n = max(1, int(cfg.points_per_side // (cfg.crop_n_points_downscale_factor ** layer)))
            # always an explicit grid: grid01=None would re-enter the cascade
            out = self.generate_masks(image[y0:y1, x0:x1], grid01=build_point_grid(n))
            for i in np.where(out["valid"])[0]:
                canvas = np.zeros((H0, W0), np.float32)
                canvas[y0:y1, x0:x1] = out["masks"][i]
                masks_l.append(canvas)
                boxes_l.append(out["boxes"][i] + np.array([x0, y0, x0, y0], np.float32))
                iou_l.append(out["iou_preds"][i])
                areas_l.append(float((x1 - x0) * (y1 - y0)))
        K = cfg.max_proposals
        res = dict(masks=np.zeros((K, H0, W0), np.float32), boxes=np.zeros((K, 4), np.float32),
                   valid=np.zeros((K,), bool), iou_preds=np.zeros((K,), np.float32))
        if masks_l:
            boxes_a = np.stack(boxes_l)
            keep = _host_greedy_nms(boxes_a, 1.0 / np.asarray(areas_l, np.float32),
                                    cfg.crop_nms_thresh)
            keep = sorted(keep, key=lambda i: -iou_l[i])[:K]
            for slot, i in enumerate(keep):
                res["masks"][slot] = masks_l[i]
                res["boxes"][slot] = boxes_a[i]
                res["valid"][slot] = True
                res["iou_preds"][slot] = iou_l[i]
        return res

    def generate_masks(self, image: np.ndarray, grid01=None) -> Dict[str, np.ndarray]:
        """image (H0, W0, 3) uint8 RGB -> host dict(masks (K, H0, W0) float
        (bilinear coverage at the original size, reference
        postprocess_resize model/sam.py:85-100), boxes (K, 4) xyxy in
        original coordinates, valid (K,), iou_preds (K,)). With
        crop_n_layers > 0 and no `grid01`, the crop cascade; with
        min_mask_region_area > 0, the small-region cleanup and its re-NMS
        at the segmentor size (`valid` is then no longer a prefix)."""
        if self.cfg.crop_n_layers > 0 and grid01 is None:
            return self.generate_masks_cropped(image)
        dev = self.generate_masks_device(image, grid01)
        H0, W0 = dev["orig_size"]
        hs, ws = dev["seg_size"]
        masks = dev["masks"]
        if self.cfg.min_mask_region_area > 0:
            m_np, boxes_np, keep = postprocess_small_regions(
                masks.to(torch.float32).cpu().numpy(), dev["valid"].cpu().numpy(),
                self.cfg.min_mask_region_area, self.cfg.box_nms_thresh)
            masks = torch.as_tensor(m_np, device=self.device)
            dev = dict(dev, boxes=torch.as_tensor(boxes_np), valid=torch.as_tensor(keep))
        with torch.inference_mode():
            if (H0, W0) != (hs, ws):
                masks = resize_logits(masks.to(torch.float32),
                                      torch.as_tensor(bilinear_matrix(H0, hs), device=self.device),
                                      torch.as_tensor(bilinear_matrix(W0, ws), device=self.device))
            masks_out = masks.to(torch.float32).cpu().numpy()
        boxes_out = dev["boxes"].cpu().numpy() * (W0 / ws)
        boxes_out[:, [0, 2]] = boxes_out[:, [0, 2]].clip(0, W0 - 1)
        boxes_out[:, [1, 3]] = boxes_out[:, [1, 3]].clip(0, H0 - 1)
        return dict(masks=masks_out, boxes=boxes_out.astype(np.float32),
                    valid=dev["valid"].cpu().numpy(),
                    iou_preds=dev["iou_preds"].cpu().numpy())


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float):
    """Crop boxes of the cascade: the full image, then (2^i)^2 overlapping
    crops for layer i = 1..n_layers (reference
    segment_anything/utils/amg.py:200-234). Returns (crop boxes xyxy,
    layer indices)."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def _host_greedy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float):
    """Greedy box NMS on the host over the cascade's few candidates, in
    `np.argsort(-scores)` order (the JAX package's call, so that its
    order among equal scores is kept). Returns the kept indices."""
    order = np.argsort(-scores)
    keep = []
    for i in order:
        ok = True
        for j in keep:
            b1, b2 = boxes[i], boxes[j]
            xx0 = max(b1[0], b2[0])
            yy0 = max(b1[1], b2[1])
            xx1 = min(b1[2], b2[2])
            yy1 = min(b1[3], b2[3])
            inter = max(0.0, xx1 - xx0) * max(0.0, yy1 - yy0)
            a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
            a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
            if inter / max(a1 + a2 - inter, 1e-9) > thresh:
                ok = False
                break
        if ok:
            keep.append(i)
    return keep
