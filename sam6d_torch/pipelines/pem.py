"""PEM inference pipeline: CAD + templates + ISM detections -> 6D poses.

Port of `sam6d_tpu/pipelines/pem.py` (reference
`Pose_Estimation_Model/run_inference_custom.py:117-315`): template onboarding
cached per object (dense features plus the pose-independent fine positional
encoding and coarse trunk), instances padded to power-of-two batch buckets,
host-side mask decoding and instance preparation, json output in the same
schema. The network runs in the pipeline's `dtype` under
`torch.inference_mode` (float32 by default; bfloat16 casts the weights, as
the JAX pipeline does): the features are bf16, the point clouds, the
sampling (K6, K7) and the pose solvers stay float32, so the poses and scores
come out float32 in either dtype. Training (`train/trainer.py`) stays
float32.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from .. import use_strict_fp32
from ..core.config import PEMConfig
from ..core.params import cast_float_params
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

    `state_dict`: port weights (reference names); None = seeded random.
    `dtype`: the compute dtype (float32, or bfloat16: the weights are cast
    to it)."""

    def __init__(self, cfg: PEMConfig, state_dict=None, seed: int = 0,
                 device="cuda", dtype: torch.dtype = torch.float32):
        use_strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        net = PEMNet(cfg)
        net.load_state_dict(state_dict if state_dict is not None
                            else random_pem_state_dict(net, seed), strict=True)
        self.net = cast_float_params(net.to(self.device), dtype).eval()

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

    def _prepare_instances(self, rgb, depth, K, depth_scale, detections, radius_of,
                           det_score_thresh, seed):
        """Decode the masks and prepare every detection above
        `det_score_thresh` (radius_of(det): the radius of its object's model
        cloud). Returns (instances, kept detections)."""
        c = self.cfg
        rng = np.random.RandomState(seed)
        whole_pts = _host_backproject(depth, depth_scale, K)
        insts, kept = [], []
        for det in detections:
            if det["score"] <= det_score_thresh:
                continue
            mask = det.get("mask")
            if mask is None:      # streaming passes the raw mask, skipping a decode
                mask = rle_decode_coco(det["segmentation"])
            mask = np.logical_and(mask > 0, depth > 0)
            inst = prepare_instance(rgb, whole_pts, mask, radius_of(det), c.img_size,
                                    c.n_sample_observed_point, rng,
                                    rgb_mask_flag=c.rgb_mask_flag)
            if inst is None:
                continue
            insts.append(inst)
            kept.append(det)
        return insts, kept

    @staticmethod
    def _stack(insts, key, dtype=np.float32):
        """Instances stacked and padded to a power-of-two bucket by repeating
        the last one."""
        arr = np.stack([i[key] for i in insts]).astype(dtype)
        pad = _bucket(len(insts)) - len(insts)
        return np.concatenate([arr, np.repeat(arr[-1:], pad, 0)]) if pad else arr

    def prepare_frame(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                      depth_scale: float, detections: List[Dict],
                      model_points: np.ndarray, templates: Dict[str, torch.Tensor],
                      det_score_thresh: float = 0.2, seed: int = 1):
        """Host half of a frame: decode masks, prepare every detection above
        `det_score_thresh` and pad to a power-of-two bucket. Returns (PEMNet
        inputs, kept detections); inputs is None if no detection survives."""
        radius = float(np.linalg.norm(model_points, axis=1).max())
        insts, kept = self._prepare_instances(rgb, depth, K, depth_scale, detections,
                                              lambda det: radius, det_score_thresh, seed)
        if not insts:
            return None, []
        inputs = dict(rgb=self._stack(insts, "rgb"),
                      rgb_choose=self._stack(insts, "rgb_choose", np.int64),
                      pts=self._stack(insts, "pts"),
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

    # ---------------------------------------------------------- multi-object

    @staticmethod
    def model_radii(model_points_all: torch.Tensor) -> np.ndarray:
        """(O, M, 3) model clouds -> (O,) largest point norm of each, on the
        host (a device read)."""
        return torch.linalg.vector_norm(model_points_all, dim=2).amax(dim=1).cpu().numpy()

    def run_frame_multi(self, *args, **kwargs):
        """Multi-object frame, synchronous: dispatch + finalize."""
        return self.finalize_frame_multi(self.dispatch_frame_multi(*args, **kwargs))

    @torch.inference_mode()
    def dispatch_frame_multi(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                             depth_scale: float, detections: List[Dict],
                             model_points_all: torch.Tensor,
                             templates_all: Dict[str, torch.Tensor],
                             det_score_thresh: float = 0.2, seed: int = 1,
                             model_radii: Optional[np.ndarray] = None):
        """Host half of a multi-object frame and the launch of its batch.
        Each detection carries an `object_id` index into the stacked
        per-object arrays (model_points_all (O, M, 3) on the device;
        `templates_all` maps each onboard_templates key to its (O, ...)
        stack); every instance's templates are gathered on the device by
        that index, so one batched PEMNet run poses a mixed-object frame.
        Returns a handle for finalize_frame_multi. `model_radii` (O,): the
        objects' radii on the host (model_radii(model_points_all)); without
        them they are read back here. The poses are not, so a serving loop
        can queue the next frame's device work first (the JAX package's
        order)."""
        tm = {}
        tt = time.perf_counter()
        radii = model_radii if model_radii is not None else self.model_radii(model_points_all)
        insts, kept = self._prepare_instances(
            rgb, depth, K, depth_scale, detections,
            lambda det: float(radii[int(det["object_id"])]), det_score_thresh, seed)
        tm["pem_prepare_ms"] = (time.perf_counter() - tt) * 1e3
        self.last_timing = tm
        if not insts:
            return dict(packed=None, kept=[], n=0)
        tt = time.perf_counter()
        dev = self.device
        oidx = self._stack([dict(o=int(d["object_id"])) for d in kept], "o", np.int64)
        oidx = torch.as_tensor(oidx, device=dev)
        inputs = dict(rgb=self._stack(insts, "rgb"),
                      rgb_choose=self._stack(insts, "rgb_choose", np.int64),
                      pts=self._stack(insts, "pts"))
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        inputs["model"] = model_points_all[oidx]
        for k in ("dense_po", "dense_fo") + TEMPLATE_CACHE_KEYS:
            if k in templates_all:
                inputs[k] = templates_all[k][oidx]
        out = self.net.infer(inputs, self._generator(seed))
        # one (B, 13) result (R row-major, t, score): one copy back per frame
        packed = torch.cat([out["pred_R"].reshape(-1, 9), out["pred_t"],
                            out["pred_pose_score"][:, None]], dim=1)
        tm["pem_upload_dispatch_ms"] = (time.perf_counter() - tt) * 1e3
        return dict(packed=packed, kept=kept, n=len(kept))

    def finalize_frame_multi(self, state):
        """Read back a dispatch_frame_multi handle and assemble the results
        (the detection_pem.json schema plus `object_id`)."""
        kept, n = state["kept"], state["n"]
        if not n:
            return [], []
        tt = time.perf_counter()
        packed = state["packed"][:n].cpu().numpy()
        self.last_timing["pem_device_wait_ms"] = (time.perf_counter() - tt) * 1e3
        pred_R = packed[:, :9].reshape(-1, 3, 3)
        results = [dict(scene_id=det.get("scene_id", 0),
                        image_id=det.get("image_id", 0),
                        object_id=int(det["object_id"]),
                        category_id=det.get("category_id", 1),
                        bbox=det.get("bbox"),
                        segmentation=det.get("segmentation"),
                        score=float(packed[i, 12] * det["score"]),
                        R=pred_R[i].tolist(),
                        t=(packed[i, 9:12] * 1000.0).tolist())
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
