"""ISM matching: proposals + DINOv2 template matching -> scored detections.

Port of the matching half of `sam6d_tpu/pipelines/ism.py` (reference
`Instance_Segmentation_Model/model/detector.py` test_step :324-423 and the
custom-image path `run_inference_custom.py:95-215`). Proposals arrive as a
fixed-capacity buffer (masks, boxes, valid); filtering is a validity mask,
not index shuffling, so slots compare one-to-one with the JAX package.
Everything on the card runs in float32 under `torch.inference_mode`; every
DINOv2 attention goes through the fused-attention dispatch (the CUDA kernel
of `csrc/attention_qkv.cu` on the card).

Not ported yet: the segmentor branch (`detections=None`), BOP onboarding
and its npz cache, bf16.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from .. import use_strict_fp32
from ..core.config import ISMConfig
from ..data.rle import rle_encode_coco
from ..models import ism_scoring
from ..models.dinov2 import DINOv2, fold_ln_affine, masked_patch_descriptors
from ..ops.images import (crop_resize_pad_nearest_stack,
                          masked_crop_resize_pad_nearest, normalize_imagenet)
from ..ops.masks import box_iou, nms_masked_rounds
from ..render.poses import template_obj_poses
from ..weights.dinov2 import random_dinov2_state_dict


def host_size_filter(masks: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
                     min_box_size: float, min_mask_size: float) -> np.ndarray:
    """The reference's size filters (detector remove_very_small_detections,
    utils.py:96-105) on the host, where the proposals arrive: drop boxes of
    relative area <= min_box_size^2 and masks of relative area <=
    min_mask_size."""
    H, W = masks.shape[1:]
    area = np.float32(H * W)
    box_areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])) / area
    mask_areas = masks.reshape(len(masks), -1).sum(axis=1, dtype=np.float32) / area
    return (valid & (box_areas > np.float32(min_box_size ** 2))
            & (mask_areas > np.float32(min_mask_size)))


def needed_prefix(valid: np.ndarray) -> int:
    """Index of the last valid slot + 1 (0 when none): the proposals come as
    a score-sorted prefix of the capacity buffer, so only this many leading
    slots need descriptors."""
    idx = np.flatnonzero(np.asarray(valid))
    return int(idx[-1]) + 1 if idx.size else 0


class ISMPipeline:
    """A DINOv2 on one device plus the matching logic.

    `state_dict`: unfolded DINOv2 weights (reference names); None = seeded
    random. The block LayerNorm affines are folded into the qkv / fc1
    weights (exact re-association), as the JAX pipeline does on its
    fused-attention path."""

    def __init__(self, cfg: ISMConfig, state_dict=None, seed: int = 0,
                 device="cuda"):
        use_strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        d = cfg.dinov2
        dims = dict(img_size=d.img_size, patch_size=d.patch_size,
                    embed_dim=d.embed_dim, depth=d.depth, num_heads=d.num_heads)
        if state_dict is None:
            state_dict = random_dinov2_state_dict(DINOv2(**dims), seed)
        net = DINOv2(**dims, use_flash=True, ln_folded=True)
        net.load_state_dict(fold_ln_affine(state_dict), strict=True)
        self.dinov2 = net.to(self.device).eval()
        self.ref_data: Dict[str, torch.Tensor] = {}
        self.last_nms_rounds = 0

    # ------------------------------------------------------------- internals

    def _dino_forward_chunked(self, images: torch.Tensor,
                              n_needed: Optional[int] = None):
        """(N, S, S, 3) -> (cls (N, C), patch (N, P, C)) in chunks of
        `chunk_size` crops, the last chunk padded by repeating crop 0.

        `n_needed` (a host int): only the first ceil(n_needed / chunk)
        chunks are described; the rest stay zero, which the scores mask
        through `valid`."""
        chunk = self.cfg.dinov2.chunk_size
        N = images.shape[0]
        if N <= chunk:
            return self.dinov2(images)
        pad = (-N) % chunk
        if pad:
            images = torch.cat([images, images[:1].expand(pad, *images.shape[1:])])
        xs = images.reshape(-1, chunk, *images.shape[1:])
        n_chunks = xs.shape[0]
        trips = n_chunks if n_needed is None else min(-(-n_needed // chunk), n_chunks)
        C = self.dinov2.cls_token.shape[-1]
        P = self.dinov2.pos_embed.shape[1] - 1
        cls = images.new_zeros((n_chunks, chunk, C))
        patch = images.new_zeros((n_chunks, chunk, P, C))
        for i in range(trips):
            cls[i], patch[i] = self.dinov2(xs[i])
        return cls.reshape(-1, C)[:N], patch.reshape(-1, P, C)[:N]

    def _describe_impl(self, rgb01, masks, boxes, n_needed=None):
        """Query proposals -> (cls descriptors, masked patch descriptors), as
        CustomDINOv2.forward (model/dinov2.py:227-258): ImageNet normalize,
        mask, crop-resize-pad, patch validity from the mask coverage.

        rgb01 (H, W, 3) float in [0, 1]; masks (K, H, W); boxes (K, 4)."""
        d = self.cfg.dinov2
        crops, mask_crops = masked_crop_resize_pad_nearest(
            normalize_imagenet(rgb01), masks, boxes, d.img_size)
        cls, patch = self._dino_forward_chunked(crops, n_needed)
        return cls, masked_patch_descriptors(patch, mask_crops, d.patch_size,
                                             d.validity_thresh)

    def _describe_templates_impl(self, images, masks):
        """Cropped template stacks (T, S, S, 3) + their mask crops ->
        (cls (T, C), patch (T, P, C))."""
        d = self.cfg.dinov2
        cls, patch = self._dino_forward_chunked(images)
        return cls, masked_patch_descriptors(patch, masks, d.patch_size,
                                             d.validity_thresh)

    # ------------------------------------------------------------ onboarding

    @torch.inference_mode()
    def onboard_templates_from_dir(self, template_dir: str,
                                   num_templates: int = 42,
                                   poses: Optional[np.ndarray] = None):
        """Demo-style onboarding (run_inference_custom.py:126-160): per view
        rgb * mask / 255 (the reference demo path skips ImageNet
        normalization for templates; replicated), crop-resize-pad.
        `poses`: (T, 4, 4) object poses of the views; default the level-0
        icosphere poses."""
        rgbs, masks, boxes = [], [], []
        for i in range(num_templates):
            rgb = np.array(Image.open(
                os.path.join(template_dir, f"rgb_{i}.png")).convert("RGB"),
                np.float32) / 255.0
            m = np.array(Image.open(
                os.path.join(template_dir, f"mask_{i}.png")).convert("L"),
                np.float32) / 255.0
            ys, xs = np.where(m > 0)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            rgbs.append(rgb * m[:, :, None])
            masks.append(m)
        dev = self.device
        rgbs = torch.as_tensor(np.stack(rgbs), device=dev)
        masks = torch.as_tensor(np.stack(masks), device=dev)
        boxes = torch.as_tensor(np.array(boxes, np.float32), device=dev)
        S = self.cfg.dinov2.img_size
        crops = crop_resize_pad_nearest_stack(rgbs, boxes, S)
        mask_crops = crop_resize_pad_nearest_stack(masks[..., None], boxes, S)[..., 0]
        cls, patch = self._describe_templates_impl(crops, mask_crops)
        if poses is None:
            poses = template_obj_poses(0)
        self.ref_data = {
            "descriptors": cls[None],         # (1 object, T, C)
            "appe_descriptors": patch[None],  # (1, T, P, C)
            "poses_R": torch.as_tensor(poses[:, :3, :3].astype(np.float32), device=dev),
        }
        return self.ref_data

    def set_reference_data(self, descriptors, appe_descriptors, poses_R,
                           pointclouds=None):
        """Onboarding from precomputed descriptors
        (detector.set_reference_objects)."""
        dev = self.device
        self.ref_data = dict(descriptors=torch.as_tensor(descriptors, device=dev),
                             appe_descriptors=torch.as_tensor(appe_descriptors, device=dev),
                             poses_R=torch.as_tensor(poses_R, device=dev))
        if pointclouds is not None:
            self.ref_data["pointcloud"] = torch.as_tensor(pointclouds, device=dev)

    # -------------------------------------------------------------- matching

    def _score_frame_impl(self, rgb01, masks, boxes, valid, depth, K,
                          depth_scale, ref_desc, ref_appe_all, poses_R_all,
                          pointclouds, n_needed: int, apply_nms: bool):
        """Descriptors of the first `n_needed` slots, the three scores, their
        fusion and the optional per-object NMS, on the device."""
        cfg = self.cfg
        cls_desc, patch_desc = self._describe_impl(
            rgb01, masks, boxes.to(torch.int32), n_needed)
        sem = ism_scoring.semantic_scores(
            cls_desc, ref_desc, valid, cfg.matching.aggregation_function,
            cfg.matching.confidence_thresh)
        selected = sem["selected"]
        obj_idx = sem["object_idx"]
        best_template = sem["best_template"]

        ref_appe = ref_appe_all[obj_idx, best_template]
        appe = ism_scoring.appearance_scores(patch_desc, ref_appe)
        vis = ism_scoring.visible_ratio(patch_desc, ref_appe,
                                        cfg.matching.visible_thred)
        # poses_R_all: (T, 3, 3) shared by the objects, or (O, T, 3, 3)
        poses_R = (poses_R_all[obj_idx, best_template] if poses_R_all.dim() == 4
                   else poses_R_all[best_template])
        geo = ism_scoring.geometric_scores(boxes, masks, depth, K, depth_scale,
                                           poses_R, pointclouds[obj_idx])
        final = ism_scoring.final_scores(sem["score"], appe, geo, vis)
        self.last_nms_rounds = 0
        if apply_nms:
            same = obj_idx[:, None] == obj_idx[None, :]
            keep, self.last_nms_rounds = nms_masked_rounds(
                box_iou(boxes, boxes), final, selected, same, cfg.post.nms_thresh)
            selected = selected & keep
        return dict(scores=final, object_ids=obj_idx, valid=selected,
                    semantic_score=sem["score"], appe_score=appe,
                    geometric_score=geo, visible_ratio=vis,
                    best_template=best_template)

    @torch.inference_mode()
    def match_frame_device(self, rgb: np.ndarray, depth: np.ndarray,
                           K: np.ndarray, depth_scale: float, pointclouds,
                           detections: Optional[Dict] = None,
                           apply_nms_per_object: bool = False,
                           apply_size_filters: bool = True
                           ) -> Dict[str, torch.Tensor]:
        """Per-frame matching of given proposals `detections` = {masks (K, H,
        W), boxes (K, 4) xyxy, valid (K,)}, all numpy. Returns device
        tensors at the proposal capacity."""
        if detections is None:
            raise NotImplementedError(
                "the segmentor branch is not ported yet: pass detections")
        dev = self.device
        masks_np = np.asarray(detections["masks"])
        boxes_np = np.asarray(detections["boxes"], np.float32)
        valid_np = np.asarray(detections["valid"], bool)
        if apply_size_filters:
            valid_np = host_size_filter(masks_np, boxes_np, valid_np,
                                        self.cfg.post.min_box_size,
                                        self.cfg.post.min_mask_size)
        # uploaded in the caller's dtype (a bool mask stack is a quarter of
        # its float32 size) and converted on the card
        masks = torch.as_tensor(masks_np, device=dev).to(torch.float32)
        boxes = torch.as_tensor(boxes_np, device=dev)
        rgb_t = torch.as_tensor(np.ascontiguousarray(rgb), device=dev)
        rgb01 = rgb_t.to(torch.float32) / 255.0
        out = self._score_frame_impl(
            rgb01, masks, boxes, torch.as_tensor(valid_np, device=dev),
            torch.as_tensor(depth.astype(np.float32), device=dev),
            torch.as_tensor(np.asarray(K, np.float32), device=dev),
            torch.tensor(np.float32(depth_scale), device=dev),
            self.ref_data["descriptors"], self.ref_data["appe_descriptors"],
            self.ref_data["poses_R"],
            torch.as_tensor(pointclouds, dtype=torch.float32, device=dev),
            needed_prefix(valid_np), apply_nms_per_object)
        out["masks"] = masks
        out["boxes"] = boxes
        return out

    def match_frame(self, *args, **kwargs) -> Dict[str, np.ndarray]:
        """match_frame_device with the results on the host: dict(masks,
        boxes, scores, object_ids, valid, per-score diagnostics) at the
        proposal capacity."""
        out = self.match_frame_device(*args, **kwargs)
        return {k: v.cpu().numpy() for k, v in out.items()}


def detections_to_bop_json(result: Dict[str, np.ndarray], scene_id: int = 0,
                           image_id: int = 0, runtime: float = 0.0,
                           category_offset: int = 1):
    """BOP-23 COCO-style json records of the valid slots (reference
    convert_npz_to_json, model/utils.py:199-216 + save_json_bop23)."""
    out = []
    for i in range(len(result["scores"])):
        if not result["valid"][i]:
            continue
        x1, y1, x2, y2 = result["boxes"][i]
        out.append({
            "scene_id": int(scene_id),
            "image_id": int(image_id),
            "category_id": int(result["object_ids"][i]) + category_offset,
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "score": float(result["scores"][i]),
            "time": float(runtime),
            # force_binary_mask(threshold=0)
            "segmentation": rle_encode_coco(result["masks"][i] > 0),
        })
    return out
