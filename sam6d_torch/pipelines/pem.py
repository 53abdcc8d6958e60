"""PEM inference pipeline: CAD + templates + ISM detections -> 6D poses.

Port of `sam6d_tpu/pipelines/pem.py` (reference
`Pose_Estimation_Model/run_inference_custom.py:117-315`): template onboarding
cached per object (dense features plus the pose-independent fine positional
encoding and coarse trunk), instances padded to power-of-two batch buckets,
host-side mask decoding and instance preparation, json output in the same
schema. Everything on the card runs in float32 under `torch.inference_mode`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from .. import use_strict_fp32
from ..core.config import PEMConfig
from ..data.mesh import load_ply
from ..data.preprocess import prepare_instance, prepare_template
from ..data.rle import rle_decode_coco
from ..models.pem import TEMPLATE_CACHE_KEYS, PEMNet
from ..weights.pem import random_pem_state_dict

__all__ = ["PEMConfig", "PEMPipeline", "load_ply", "run_demo_pem"]


def _bucket(n: int, cap: int = 64) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _host_backproject(depth, depth_scale, K):
    """Depth (H, W) -> camera-frame cloud (H, W, 3) in meters."""
    z = depth.astype(np.float32) * np.float32(depth_scale) / 1000.0
    H, W = z.shape
    K = np.asarray(K, np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xmap = np.arange(W, dtype=np.float32)[None, :]
    ymap = np.arange(H, dtype=np.float32)[:, None]
    return np.stack([(xmap - cx) * z / fx, (ymap - cy) * z / fy, z], axis=-1)


class PEMPipeline:
    """A PEMNet on one device plus the host-side data path.

    `state_dict`: port weights (reference names); None = seeded random."""

    def __init__(self, cfg: PEMConfig, state_dict=None, seed: int = 0,
                 device="cuda"):
        use_strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        net = PEMNet(cfg)
        net.load_state_dict(state_dict if state_dict is not None
                            else random_pem_state_dict(net, seed), strict=True)
        self.net = net.to(self.device).eval()

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def infer_batch(self, inputs: Dict[str, torch.Tensor], seed: int = 0):
        """Batched forward on prepared inputs (the PEMNet.infer contract);
        returns its output dict of tensors."""
        inputs = {k: torch.as_tensor(v, device=self.device) for k, v in inputs.items()}
        return self.net.infer(inputs, self._generator(seed))

    # ------------------------------------------------------------- templates

    def load_template_views(self, template_dir: str, rng=None):
        """Read rendered views (rgb_i.png / mask_i.png / xyz_i.npy in mm,
        reference _get_template :117-146) -> stacked numpy arrays."""
        rng = rng or np.random.RandomState(2)
        c = self.cfg
        views = []
        for v in range(c.n_template_view):
            i = int(42 / c.n_template_view * v)
            rgb = np.array(Image.open(os.path.join(template_dir, f"rgb_{i}.png")))[..., :3]
            mask = np.array(Image.open(os.path.join(template_dir, f"mask_{i}.png"))) == 255
            if mask.ndim == 3:
                mask = mask[..., 0]
            xyz = np.load(os.path.join(template_dir, f"xyz_{i}.npy")).astype(np.float32) / 1000.0
            views.append(prepare_template(rgb, mask, xyz, c.img_size,
                                          c.n_sample_template_point, rng))
        return {k: np.stack([v[k] for v in views]) for k in ("rgb", "choose", "pts")}

    @torch.inference_mode()
    def onboard_templates(self, tem: Dict[str, np.ndarray]):
        """Template views -> dense_po (N, 3) model-frame points (meters),
        dense_fo (N, C), and the batch-1 caches of every pose-independent
        template-side array (fine PE, coarse FPS + geometric embedding)."""
        dev = self.device
        pts = torch.as_tensor(tem["pts"], device=dev)
        po, fo = self.net.extract_template_feats(
            torch.as_tensor(tem["rgb"], device=dev),
            torch.as_tensor(tem["choose"], device=dev), pts,
            torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
        radius = torch.linalg.vector_norm(po, dim=-1).amax()
        po_n = (po / (radius + 1e-6))[None]
        tc = self.net.template_trunk(po_n, fo[None])
        return dict(dense_po=po, dense_fo=fo, pe_o=self.net.template_pe(po_n)[0],
                    **{k: v[0] for k, v in tc.items()})

    # -------------------------------------------------------------- instances

    def prepare_frame(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                      depth_scale: float, detections: List[Dict],
                      model_points: np.ndarray, templates: Dict[str, torch.Tensor],
                      det_score_thresh: float = 0.2, seed: int = 1):
        """Host half of a frame: decode masks, prepare every detection above
        `det_score_thresh` and pad to a power-of-two bucket. Returns (PEMNet
        inputs, kept detections); inputs is None if no detection survives."""
        c = self.cfg
        rng = np.random.RandomState(seed)
        whole_pts = _host_backproject(depth, depth_scale, K)
        radius = float(np.linalg.norm(model_points, axis=1).max())
        insts, kept = [], []
        for det in detections:
            if det["score"] <= det_score_thresh:
                continue
            mask = det.get("mask")
            if mask is None:
                mask = rle_decode_coco(det["segmentation"])
            mask = np.logical_and(mask > 0, depth > 0)
            inst = prepare_instance(rgb, whole_pts, mask, radius, c.img_size,
                                    c.n_sample_observed_point, rng,
                                    rgb_mask_flag=c.rgb_mask_flag)
            if inst is None:
                continue
            insts.append(inst)
            kept.append(det)
        if not insts:
            return None, []
        pad = _bucket(len(insts)) - len(insts)

        def stack(key, dtype=np.float32):
            arr = np.stack([i[key] for i in insts]).astype(dtype)
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)])
            return arr

        inputs = dict(rgb=stack("rgb"), rgb_choose=stack("rgb_choose", np.int64),
                      pts=stack("pts"),
                      model=np.asarray(model_points, np.float32)[None],
                      dense_po=templates["dense_po"][None],
                      dense_fo=templates["dense_fo"][None])
        for k in TEMPLATE_CACHE_KEYS:
            if k in templates:
                inputs[k] = templates[k][None]
        return inputs, kept

    def run_frame(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                  depth_scale: float, detections: List[Dict],
                  model_points: np.ndarray, templates: Dict[str, torch.Tensor],
                  det_score_thresh: float = 0.2, seed: int = 1):
        """Pose every detection of one frame above `det_score_thresh`.
        Returns (results in the detection_pem.json schema, kept detections)."""
        inputs, kept = self.prepare_frame(rgb, depth, K, depth_scale, detections,
                                          model_points, templates,
                                          det_score_thresh, seed)
        if inputs is None:
            return [], []
        out = self.infer_batch(inputs, seed)
        n = len(kept)
        pred_R = out["pred_R"][:n].cpu().numpy()
        pred_t = out["pred_t"][:n].cpu().numpy()
        score = out["pred_pose_score"][:n].cpu().numpy()
        results = [dict(scene_id=det.get("scene_id", 0),
                        image_id=det.get("image_id", 0),
                        category_id=det.get("category_id", 1),
                        bbox=det.get("bbox"),
                        segmentation=det.get("segmentation"),
                        score=float(score[i] * det["score"]),
                        R=pred_R[i].tolist(),
                        t=(pred_t[i] * 1000.0).tolist())
                   for i, det in enumerate(kept)]
        return results, kept


def run_demo_pem(cfg: PEMConfig, output_dir: str, cad_path: str,
                 rgb_path: str, depth_path: str, cam_path: str, seg_path: str,
                 state_dict=None, det_score_thresh: float = 0.2,
                 device="cuda", seed: int = 0):
    """demo.sh stage 3: writes <output_dir>/sam6d_results/detection_pem.json."""
    pipe = PEMPipeline(cfg, state_dict=state_dict, seed=seed, device=device)
    with open(cam_path) as f:
        cam = json.load(f)
    K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
    depth_scale = float(cam.get("depth_scale", 1.0))
    rgb = np.array(Image.open(rgb_path))[..., :3]
    depth = np.array(Image.open(depth_path)).astype(np.float32)
    model_points = load_ply(cad_path).sample(
        cfg.n_sample_model_point, np.random.RandomState(0)) / 1000.0

    templates = pipe.onboard_templates(
        pipe.load_template_views(os.path.join(output_dir, "templates")))
    with open(seg_path) as f:
        dets = json.load(f)
    results, _ = pipe.run_frame(rgb, depth, K, depth_scale, dets,
                                model_points.astype(np.float32), templates,
                                det_score_thresh)
    os.makedirs(os.path.join(output_dir, "sam6d_results"), exist_ok=True)
    with open(os.path.join(output_dir, "sam6d_results", "detection_pem.json"), "w") as f:
        json.dump(results, f)
    return results
