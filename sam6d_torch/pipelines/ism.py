"""ISM matching: proposals + DINOv2 template matching -> scored detections.

Port of the matching half of `sam6d_tpu/pipelines/ism.py` (reference
`Instance_Segmentation_Model/model/detector.py` test_step :324-423 and the
custom-image path `run_inference_custom.py:95-215`). Proposals arrive as a
fixed-capacity buffer (masks, boxes, valid); filtering is a validity mask,
not index shuffling, so slots compare one-to-one with the JAX package.
DINOv2 runs in the pipeline's `dtype` (float32 by default; bfloat16 casts
the folded weights, as the JAX pipeline does), under
`torch.inference_mode`; every DINOv2 attention goes through the
fused-attention dispatch (the CUDA kernel of `csrc/attention_qkv.cu` on the
card, its bf16 entry in bf16). The descriptors are cast to float32 where
they leave the describe: the reference descriptors, the onboarding cache
and the three scores are float32 in either dtype. With a `segmentor`
(`pipelines/sam_amg.SAMSegmentor`), `match_frame(detections=None)` takes
its proposals from SAM on the same device; the masks never leave it.
BOP onboarding (rendered templates or mined train_pbr crops) describes every
object's views once and keeps them in an npz cache whose keys are the JAX
package's.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from .. import use_strict_fp32
from ..core.checkpoint import load_template_cache, save_template_cache
from ..core.config import ISMConfig
from ..core.params import cast_float_params
from ..core.uploads import device_constant, upload
from ..data.rle import rle_encode_coco
from ..models import ism_scoring
from ..models.dinov2 import DINOv2, fold_ln_affine, masked_patch_descriptors
from ..kernels.graphs import ChunkGraphs
from ..ops.images import (crop_resize_pad_nearest_stack,
                          masked_crop_resize_pad_nearest, normalize_imagenet)
from ..ops.masks import box_iou, nms_masked_device
from ..render.poses import template_obj_poses
from ..weights.dinov2 import random_dinov2_state_dict
from .sam_amg import SAMSegmentor, bilinear_matrix, resize_logits


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


def device_size_filter(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                       min_box_size: float, min_mask_size: float) -> torch.Tensor:
    """host_size_filter on the device, in the same float32 arithmetic, for
    proposals that were made there (the area a device tensor: torch divides
    by a host scalar as a product with its reciprocal)."""
    H, W = masks.shape[1:]
    area = torch.full((), float(np.float32(H * W)), dtype=torch.float32, device=masks.device)
    box_areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])) / area
    mask_areas = masks.to(torch.float32).sum(dim=(1, 2)) / area
    return (valid & (box_areas > float(np.float32(min_box_size ** 2)))
            & (mask_areas > float(np.float32(min_mask_size))))


def needed_prefix(valid: np.ndarray) -> int:
    """Index of the last valid slot + 1 (0 when none): the proposals come as
    a score-sorted prefix of the capacity buffer, so only this many leading
    slots need descriptors."""
    idx = np.flatnonzero(np.asarray(valid))
    return int(idx[-1]) + 1 if idx.size else 0


def needed_prefix_device(valid: torch.Tensor) -> torch.Tensor:
    """needed_prefix on the device: () int32, no host read."""
    idx = torch.arange(1, valid.shape[0] + 1, dtype=torch.int32, device=valid.device)
    return torch.where(valid.to(torch.bool), idx, torch.zeros_like(idx)).amax()


class ISMPipeline:
    """A DINOv2 on one device plus the matching logic.

    `state_dict`: unfolded DINOv2 weights (reference names); None = seeded
    random. The block LayerNorm affines are folded into the qkv / fc1
    weights (exact re-association, in float32), as the JAX pipeline does on
    its fused-attention path, then cast to `dtype`."""

    def __init__(self, cfg: ISMConfig, state_dict=None, seed: int = 0,
                 device="cuda", segmentor: Optional[SAMSegmentor] = None,
                 dtype: torch.dtype = torch.float32):
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
        self.dtype = dtype
        self.dinov2 = cast_float_params(net.to(self.device), dtype).eval()
        self.segmentor = segmentor
        self.ref_data: Dict[str, torch.Tensor] = {}
        self.last_nms_rounds = 0
        self._describe_graphs: Dict[tuple, ChunkGraphs] = {}

    # ------------------------------------------------------------- internals

    def _dino_forward_chunked(self, images: torch.Tensor, n_needed=None):
        """(N, S, S, 3) -> (cls (N, C), patch (N, P, C)) in chunks of
        `chunk_size` crops, the last chunk padded by repeating crop 0.

        `n_needed` (a host int, or a () device tensor): only the first
        ceil(n_needed / chunk) chunks are described; the rest stay zero,
        which the scores mask through `valid`. A device tensor on the card
        takes the describe graph (`describe_graph`), so the host reads
        nothing; on the CPU it is read."""
        chunk = self.cfg.dinov2.chunk_size
        N = images.shape[0]
        if N <= chunk:
            return self.dinov2(images)
        pad = (-N) % chunk
        if pad:
            images = torch.cat([images, images[:1].expand(pad, *images.shape[1:])])
        xs = images.reshape(-1, chunk, *images.shape[1:])
        n_chunks = xs.shape[0]
        C = self.dinov2.cls_token.shape[-1]
        P = self.dinov2.pos_embed.shape[1] - 1
        if isinstance(n_needed, torch.Tensor):
            if images.is_cuda:
                cls, patch = self.describe_graph(n_chunks).run(images, n_needed)
                return cls.reshape(-1, C)[:N], patch.reshape(-1, P, C)[:N]
            n_needed = int(n_needed)
        trips = n_chunks if n_needed is None else min(-(-n_needed // chunk), n_chunks)
        cls = images.new_zeros((n_chunks, chunk, C), dtype=self.dtype)
        patch = images.new_zeros((n_chunks, chunk, P, C), dtype=self.dtype)
        for i in range(trips):
            cls[i], patch[i] = self.dinov2(xs[i])
        return cls.reshape(-1, C)[:N], patch.reshape(-1, P, C)[:N]

    def describe_graph(self, n_chunks: int) -> ChunkGraphs:
        """The describe graph of `n_chunks` chunks (an IF node a chunk,
        kernels/graphs.py), built at its first use and kept: one a
        (chunks, chunk, image size, dtype)."""
        d = self.cfg.dinov2
        key = (n_chunks, d.chunk_size, d.img_size, self.dtype)
        g = self._describe_graphs.get(key)
        if g is None:
            example = torch.zeros((n_chunks * d.chunk_size, d.img_size, d.img_size, 3),
                                  dtype=torch.float32, device=self.device)
            g = self._describe_graphs[key] = ChunkGraphs(self.dinov2, example, n_chunks,
                                                         d.chunk_size)
        return g

    @torch.inference_mode()
    def prepare_frames(self, pointclouds, frame_hw=(480, 640)) -> None:
        """Run the segmentor branch of match_frame_device once on a blank
        frame of `frame_hw` and wait for it: what its first call does once
        (build the describe graph at the segmentor's capacity; load each
        kernel the chain launches, which CUDA does at a kernel's first
        launch and which waits for the card; upload the frame geometry's
        constants) then happens here, so that a frame's call waits on
        nothing. Nothing on the CPU or without a segmentor."""
        if self.segmentor is None or self.device.type != "cuda":
            return
        H, W = frame_hw
        self.match_frame_device(np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.float32),
                                np.eye(3, dtype=np.float32), 1.0, pointclouds,
                                apply_nms_per_object=True)
        torch.cuda.synchronize(self.device)

    def _describe_impl(self, rgb01, masks, boxes, n_needed=None):
        """Query proposals -> (cls descriptors, masked patch descriptors), as
        CustomDINOv2.forward (model/dinov2.py:227-258): ImageNet normalize,
        mask, crop-resize-pad, patch validity from the mask coverage.

        rgb01 (H, W, 3) float in [0, 1]; masks (K, H, W); boxes (K, 4)."""
        d = self.cfg.dinov2
        crops, mask_crops = masked_crop_resize_pad_nearest(
            normalize_imagenet(rgb01), masks, boxes, d.img_size)
        cls, patch = self._dino_forward_chunked(crops, n_needed)
        patch = masked_patch_descriptors(patch, mask_crops, d.patch_size, d.validity_thresh)
        return cls.to(torch.float32), patch.to(torch.float32)

    def _describe_templates_impl(self, images, masks):
        """Cropped template stacks (T, S, S, 3) + their mask crops ->
        (cls (T, C), patch (T, P, C))."""
        d = self.cfg.dinov2
        cls, patch = self._dino_forward_chunked(images)
        patch = masked_patch_descriptors(patch, masks, d.patch_size, d.validity_thresh)
        return cls.to(torch.float32), patch.to(torch.float32)

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
        views = []
        for i in range(num_templates):
            rgb = np.array(Image.open(
                os.path.join(template_dir, f"rgb_{i}.png")).convert("RGB"),
                np.float32) / 255.0
            m = np.array(Image.open(
                os.path.join(template_dir, f"mask_{i}.png")).convert("L"),
                np.float32) / 255.0
            views.append((rgb * m[:, :, None], m))
        cls, patch = self._describe_template_stack(*self._masked_views(views),
                                                   normalize=False)
        if poses is None:
            poses = template_obj_poses(0)
        # one object: descriptors (1, T, C), appe_descriptors (1, T, P, C)
        self.set_reference_data(cls[None], patch[None], poses[:, :3, :3].astype(np.float32))
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

    @torch.inference_mode()
    def _describe_template_stack(self, rgbs: np.ndarray, masks: np.ndarray,
                                 boxes: np.ndarray, normalize: bool):
        """Masked template views (T, H, W, 3) in [0, 1], masks (T, H, W),
        boxes (T, 4) xyxy -> (cls (T, C), patch (T, P, C)) on the device.
        `normalize` applies the ImageNet transform to the crops: the
        reference BOP providers normalize after CropResizePad (bop.py:43-46,
        80), so the zero background becomes -mean/std; the custom path
        (onboard_templates_from_dir) skips it."""
        dev = self.device
        S = self.cfg.dinov2.img_size
        boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
        crops = crop_resize_pad_nearest_stack(torch.as_tensor(rgbs, device=dev), boxes, S)
        mask_crops = crop_resize_pad_nearest_stack(
            torch.as_tensor(masks, device=dev)[..., None], boxes, S)[..., 0]
        if normalize:
            crops = normalize_imagenet(crops)
        return self._describe_templates_impl(crops, mask_crops)

    def _finish_onboarding(self, all_cls, all_patch, cache_path):
        """Stack the objects' descriptors into ref_data (O, T, ...), with the
        level-0 template poses, and write the cache, if a path is given."""
        self.set_reference_data(torch.stack(all_cls), torch.stack(all_patch),
                                template_obj_poses(0)[:, :3, :3].astype(np.float32))
        if cache_path:
            save_template_cache(cache_path, **self.ref_data)
        return self.ref_data

    def _load_onboarding_cache(self, cache_path, reset_descriptors):
        """ref_data from the cache, or None (no path, no file, or
        `reset_descriptors`)."""
        cached = (load_template_cache(cache_path)
                  if cache_path and not reset_descriptors else None)
        if cached is None:
            return None
        self.set_reference_data(cached["descriptors"], cached["appe_descriptors"],
                                cached["poses_R"])
        return self.ref_data

    @staticmethod
    def _masked_views(views):
        """[(rgb01 (H, W, 3) with the mask applied, mask bool)] -> stacked
        (rgbs, masks float32, tight xyxy boxes)."""
        rgbs, masks, boxes = [], [], []
        for rgb01, mask in views:
            ys, xs = np.where(mask)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            rgbs.append(rgb01)
            masks.append(mask.astype(np.float32))
        return np.stack(rgbs), np.stack(masks), np.array(boxes, np.float32)

    @torch.inference_mode()
    def onboard_bop_objects(self, objects, cache_path: Optional[str] = None,
                            n_template_view: int = 42, reset_descriptors: bool = False):
        """Onboard every object of a BOP dataset from its rendered template
        directory (data/bop.BOPObject), with an npz cache (reference
        detector.set_reference_objects :65-134; `reset_descriptors`
        recomputes). Returns ref_data: descriptors (O, T, C),
        appe_descriptors (O, T, P, C), poses_R (T, 3, 3)."""
        cached = self._load_onboarding_cache(cache_path, reset_descriptors)
        if cached is not None:
            return cached
        all_cls, all_patch = [], []
        for obj in objects:
            views = []
            for v in range(n_template_view):
                rgb, mask, _ = obj.load_template(v)
                views.append((rgb.astype(np.float32) / 255.0 * mask[..., None], mask))
            cls, patch = self._describe_template_stack(*self._masked_views(views),
                                                       normalize=True)
            all_cls.append(cls)
            all_patch.append(patch)
        return self._finish_onboarding(all_cls, all_patch, cache_path)

    @torch.inference_mode()
    def onboard_bop_objects_pbr(self, dataset_dir: str, obj_ids,
                                cache_path: Optional[str] = None,
                                reset_descriptors: bool = False):
        """PBR onboarding, the reference's default BOP operating point
        (configs/model/ISM_sam.yaml:28 `rendering_type: pbr`,
        provider/bop_pbr.py:28-248): per object, the train_pbr crops nearest
        to the 42 level-0 viewpoints (data/bop_pbr.PBRTemplateMiner), the
        masked RGB, the tight mask box, CropResizePad, ImageNet
        normalization. Cache as onboard_bop_objects."""
        from ..data.bop_pbr import PBRTemplateMiner

        cached = self._load_onboarding_cache(cache_path, reset_descriptors)
        if cached is not None:
            return cached
        miner = PBRTemplateMiner(dataset_dir)
        mined = miner.mine(list(obj_ids))
        all_cls, all_patch = [], []
        for obj_id in obj_ids:
            views = []
            for rec in mined[obj_id]:
                masked, mask = miner.load_template_crop(rec)
                views.append((masked.astype(np.float32) / 255.0, mask))
            cls, patch = self._describe_template_stack(*self._masked_views(views),
                                                       normalize=True)
            all_cls.append(cls)
            all_patch.append(patch)
        return self._finish_onboarding(all_cls, all_patch, cache_path)

    # -------------------------------------------------------------- matching

    def _score_frame_impl(self, rgb01, masks, boxes, valid, depth, K,
                          depth_scale, ref_desc, ref_appe_all, poses_R_all,
                          pointclouds, n_needed, apply_nms: bool):
        """Descriptors of the first `n_needed` slots (a host int or a ()
        device tensor), the three scores, their fusion and the optional
        per-object NMS (`last_nms_rounds` a () device tensor), on the
        device."""
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
            keep, self.last_nms_rounds = nms_masked_device(
                box_iou(boxes, boxes), final, selected, same, cfg.post.nms_thresh)
            selected = selected & keep
        return dict(scores=final, object_ids=obj_idx, valid=selected,
                    semantic_score=sem["score"], appe_score=appe,
                    geometric_score=geo, visible_ratio=vis,
                    best_template=best_template)

    def _segment(self, rgb: np.ndarray):
        """The segmentor's proposals at the frame's size, on the device:
        (masks (K, H0, W0) bool, or float coverage when the segmentor ran
        at another size; boxes (K, 4) xyxy; valid (K,))."""
        seg = self.segmentor.generate_masks_device(rgb)
        (H0, W0), (hs, ws) = seg["orig_size"], seg["seg_size"]
        masks, boxes = seg["masks"], seg["boxes"]
        if (H0, W0) != (hs, ws):
            dev = self.device
            masks = resize_logits(
                masks.to(torch.float32),
                device_constant(("bilinear", H0, hs), lambda: bilinear_matrix(H0, hs), dev),
                device_constant(("bilinear", W0, ws), lambda: bilinear_matrix(W0, ws), dev))
            boxes = boxes * (W0 / ws)
            lim = device_constant(("box_limits", H0, W0),
                                  lambda: np.array([W0 - 1, H0 - 1, W0 - 1, H0 - 1]), dev,
                                  boxes.dtype)
            boxes = torch.minimum(boxes.clamp(min=0), lim)
        return masks, boxes, seg["valid"]

    @torch.inference_mode()
    def match_frame_device(self, rgb: np.ndarray, depth: np.ndarray,
                           K: np.ndarray, depth_scale: float, pointclouds,
                           detections: Optional[Dict] = None,
                           apply_nms_per_object: bool = False,
                           apply_size_filters: bool = True
                           ) -> Dict[str, torch.Tensor]:
        """Per-frame matching of the proposals `detections` = {masks (K, H,
        W), boxes (K, 4) xyxy, valid (K,)}, all numpy, or, with
        `detections=None`, of the segmentor's proposals for `rgb`. Returns
        device tensors at the proposal capacity, `packed` (K, 12) among
        them: score, object id, valid, semantic, appearance and geometric
        scores, visible ratio, best template, box x1 y1 x2 y2."""
        dev = self.device
        post = self.cfg.post
        if detections is None:
            masks, boxes, valid = self._segment(rgb)
            if apply_size_filters:
                valid = device_size_filter(masks, boxes, valid, post.min_box_size,
                                           post.min_mask_size)
            # the describe is sized on the device from the valid flags
            n_needed = needed_prefix_device(valid)
            masks = masks.to(torch.float32)
        else:
            masks_np = np.asarray(detections["masks"])
            boxes_np = np.asarray(detections["boxes"], np.float32)
            valid_np = np.asarray(detections["valid"], bool)
            if apply_size_filters:
                valid_np = host_size_filter(masks_np, boxes_np, valid_np,
                                            post.min_box_size, post.min_mask_size)
            # uploaded in the caller's dtype (a bool mask stack is a quarter
            # of its float32 size) and converted on the card
            masks = upload(masks_np, dev).to(torch.float32)
            boxes = upload(boxes_np, dev)
            valid = upload(valid_np, dev)
            n_needed = needed_prefix(valid_np)
        rgb01 = upload(rgb, dev).to(torch.float32) / 255.0
        out = self._score_frame_impl(
            rgb01, masks, boxes, valid,
            upload(np.asarray(depth, np.float32), dev),
            upload(np.asarray(K, np.float32), dev),
            upload(np.float32(depth_scale), dev),
            self.ref_data["descriptors"], self.ref_data["appe_descriptors"],
            self.ref_data["poses_R"], upload(pointclouds, dev, torch.float32),
            n_needed, apply_nms_per_object)
        out["masks"] = masks
        out["boxes"] = boxes
        # one (K, 12) row per proposal, so that a serving loop reads the
        # frame's results back in one copy; the JAX package's column order
        out["packed"] = torch.cat(
            [out[k].to(torch.float32)[:, None]
             for k in ("scores", "object_ids", "valid", "semantic_score", "appe_score",
                       "geometric_score", "visible_ratio", "best_template")]
            + [boxes.to(torch.float32)], dim=1)
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
