"""PBR onboarding: real train_pbr crops mined as ISM templates (numpy).

The port's own copy of `sam6d_tpu/data/bop_pbr.py`. Parity target:
reference `Instance_Segmentation_Model/provider/bop_pbr.py` (BOPTemplatePBR
:28-248): for each object, scan the train_pbr ground truth, keep the
instances with visib_fract > 0.8, and for each of the 42 level-0 template
viewpoints pick the crop whose viewing direction is nearest; its masked RGB
is that view's template.

Nearest template (reference `utils/poses/pose_utils.py:285-296`
search_nearest_query): the Euclidean distance between the third rotation
rows, the viewing axis in object coordinates. The reference negates that row
on both sides (opencv2opengl), which leaves the distances as they are;
in-plane rotation is ignored.

One divergence, the JAX package's: the reference draws 5000 candidates with
replacement and unseeded (provider/bop_pbr.py:180); here they are drawn
without replacement, only above `max_candidates`, under a fixed seed.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from ..render.poses import template_obj_poses


def rotation_geodesic(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Geodesic distance between (N, 3, 3) and (M, 3, 3) rotations -> (N, M)."""
    tr = np.einsum("nij,mij->nm", Ra, Rb)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def viewing_direction_distance(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Euclidean distance between the viewing directions (third rotation
    rows) of (N, 3, 3) and (M, 3, 3) rotations -> (N, M)."""
    va = Ra[:, 2, :]
    vb = Rb[:, 2, :]
    d2 = (np.sum(va * va, -1)[:, None] + np.sum(vb * vb, -1)[None, :]
          - 2.0 * va @ vb.T)
    return np.sqrt(np.maximum(d2, 0.0))


@dataclass
class PBRTemplateMiner:
    """Scans a train_pbr split and picks each object's template crops."""
    dataset_dir: str
    level: int = 0
    min_visib_fract: float = 0.8
    max_candidates: int = 5000
    seed: int = 2021

    def _scan_scene(self, scene_dir: str, per_obj: Dict[int, List]):
        with open(os.path.join(scene_dir, "scene_gt.json")) as f:
            gt = json.load(f)
        info_path = os.path.join(scene_dir, "scene_gt_info.json")
        gt_info = {}
        if os.path.exists(info_path):
            with open(info_path) as f:
                gt_info = json.load(f)
        for im_id, instances in gt.items():
            infos = gt_info.get(im_id, [{}] * len(instances))
            for inst_idx, (inst, info) in enumerate(zip(instances, infos)):
                if info.get("visib_fract", 1.0) <= self.min_visib_fract:
                    continue
                per_obj.setdefault(int(inst["obj_id"]), []).append(dict(
                    scene_dir=scene_dir, im_id=int(im_id), inst_idx=inst_idx,
                    R=np.array(inst["cam_R_m2c"], np.float32).reshape(3, 3)))

    def mine(self, obj_ids: Optional[List[int]] = None) -> Dict[int, List[Dict]]:
        """Object id -> one candidate record per template viewpoint (the
        nearest viewing direction)."""
        rng = np.random.RandomState(self.seed)
        per_obj: Dict[int, List] = {}
        for scene_dir in sorted(glob.glob(os.path.join(self.dataset_dir, "train_pbr", "*"))):
            if os.path.isdir(scene_dir):
                self._scan_scene(scene_dir, per_obj)
        template_R = template_obj_poses(self.level)[:, :3, :3].astype(np.float32)
        out: Dict[int, List[Dict]] = {}
        for obj_id, cands in per_obj.items():
            if obj_ids is not None and obj_id not in obj_ids:
                continue
            if len(cands) > self.max_candidates:
                idx = rng.choice(len(cands), self.max_candidates, replace=False)
                cands = [cands[i] for i in idx]
            d = viewing_direction_distance(template_R, np.stack([c["R"] for c in cands]))
            out[obj_id] = [cands[i] for i in d.argmin(axis=1)]
        return out

    def load_template_crop(self, record: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb uint8 with the visible mask applied, mask bool) of one mined
        record."""
        sd, im_id = record["scene_dir"], record["im_id"]
        rgb = None
        for ext in ("jpg", "png"):
            p = os.path.join(sd, "rgb", f"{im_id:06d}.{ext}")
            if os.path.exists(p):
                rgb = np.array(Image.open(p).convert("RGB"))
                break
        mask = np.array(Image.open(os.path.join(
            sd, "mask_visib", f"{im_id:06d}_{record['inst_idx']:06d}.png"))) > 0
        return rgb * mask[..., None].astype(np.uint8), mask
