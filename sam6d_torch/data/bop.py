"""BOP dataset readers (test time), numpy on the host.

The port's own copy of `sam6d_tpu/data/bop.py`. Parity targets: reference
`Instance_Segmentation_Model/provider/base_bop.py` (:31-178 scene discovery
and metadata), `provider/bop.py` (BaseBOPTest query frames),
`Pose_Estimation_Model/provider/bop_test_dataset.py` (:24-208 per-instance
assembly from ISM detections) and `utils/bop_object_utils.py` (:16-117 CAD
and template bundles).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .mesh import Mesh, load_ply
from .preprocess import prepare_instance, prepare_template
from .rle import rle_decode_coco

# the BOP-19/23 core datasets (reference exp.sh; sam6d_tpu/data/bop.py)
BOP_DATASETS = ["lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv"]

def load_scene_camera(path: str) -> Dict[int, Dict]:
    with open(path) as f:
        data = json.load(f)
    return {int(k): v for k, v in data.items()}


def frame_paths(scene_dir: str, im_id: int) -> Dict[str, str]:
    """rgb/depth file paths with the reference's fallbacks (png/jpg rgb,
    itodd's gray tif, png/tif depth)."""
    out = {}
    for sub, exts in [("rgb", ["png", "jpg"]), ("gray", ["tif"]),
                      ("depth", ["png", "tif"])]:
        for e in exts:
            p = os.path.join(scene_dir, sub, f"{im_id:06d}.{e}")
            if os.path.exists(p):
                out.setdefault("rgb" if sub in ("rgb", "gray") else "depth", p)
    return out


@dataclass
class BOPTestScene:
    """One scene directory: scene_camera.json and its frames."""
    scene_dir: str

    def __post_init__(self):
        self.scene_id = int(os.path.basename(self.scene_dir))
        self.cameras = load_scene_camera(os.path.join(self.scene_dir, "scene_camera.json"))

    def frame_ids(self) -> List[int]:
        return sorted(self.cameras.keys())

    def load_frame(self, im_id: int) -> Dict:
        """dict(rgb (H, W, 3) uint8, depth (H, W) float32 in depth units,
        K (3, 3) float32, depth_scale, scene_id, im_id)."""
        cam = self.cameras[im_id]
        paths = frame_paths(self.scene_dir, im_id)
        rgb = np.array(Image.open(paths["rgb"]).convert("RGB"))
        depth = np.array(Image.open(paths["depth"])).astype(np.float32)
        K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
        return dict(rgb=rgb, depth=depth, K=K,
                    depth_scale=float(cam.get("depth_scale", 1.0)),
                    scene_id=self.scene_id, im_id=im_id)


def discover_test_scenes(dataset_dir: str, split: str = "test") -> List[BOPTestScene]:
    """Every scene directory of `{dataset_dir}/{split}*` (reference
    base_bop.py load_list_scene)."""
    dirs = sorted(glob.glob(os.path.join(dataset_dir, f"{split}*", "*")))
    return [BOPTestScene(d) for d in dirs if os.path.isdir(d)]


# ------------------------------------------------------------------ objects

@dataclass
class BOPObject:
    """CAD, sampled points, diameter and templates of one object (reference
    bop_object_utils.Obj)."""
    obj_id: int
    mesh: Mesh
    diameter: float
    symmetric: bool
    template_dir: Optional[str] = None
    model_points: Optional[np.ndarray] = None

    def sample_points(self, n: int, seed: int = 0) -> np.ndarray:
        """`n` surface samples in metres (the CAD is in mm), cached until
        another `n` is asked for."""
        pts = self.model_points
        if pts is None or len(pts) != n:
            # a local, so that a prefetch thread asking for another n at the
            # same time cannot hand this caller its array
            pts = self.mesh.sample(n, np.random.RandomState(seed)).astype(np.float32) / 1000.0
            self.model_points = pts
        return pts

    def load_template(self, view: int):
        """(rgb uint8, mask bool, xyz float32 in metres) of one view
        (reference Obj._get_template: xyz / 1000)."""
        d = self.template_dir
        rgb = np.array(Image.open(os.path.join(d, f"rgb_{view}.png")).convert("RGB"))
        mask = np.array(Image.open(os.path.join(d, f"mask_{view}.png")))
        if mask.ndim == 3:
            mask = mask[..., 0]
        xyz = np.load(os.path.join(d, f"xyz_{view}.npy")).astype(np.float32) / 1000.0
        return rgb, mask == 255, xyz


def load_bop_objects(models_dir: str, template_root: Optional[str] = None,
                     dataset_name: str = "") -> List[BOPObject]:
    """Every object of a BOP models directory, with its models_info.json
    metadata; templates under `{template_root}/{dataset_name}/obj_{id:06d}`."""
    with open(os.path.join(models_dir, "models_info.json")) as f:
        info = json.load(f)
    objs = []
    for key in sorted(info.keys(), key=int):
        meta = info[key]
        obj_id = int(key)
        mesh = load_ply(os.path.join(models_dir, f"obj_{obj_id:06d}.ply"))
        sym = ("symmetries_continuous" in meta) or ("symmetries_discrete" in meta)
        tdir = (None if template_root is None
                else os.path.join(template_root, dataset_name, f"obj_{obj_id:06d}"))
        objs.append(BOPObject(obj_id, mesh, float(meta["diameter"]), sym, tdir))
    return objs


# --------------------------------------------------------- PEM test assembly

@dataclass
class PEMTestFrameLoader:
    """Groups ISM detections by frame and assembles PEM instances
    (reference bop_test_dataset.BOPTestset :24-162)."""
    objects: List[BOPObject]
    img_size: int = 224
    n_sample_observed: int = 2048
    n_sample_template: int = 5000
    n_template_view: int = 42
    seg_filter_score: float = 0.25
    minimum_n_point: int = 8
    rgb_mask_flag: bool = True
    obj_id_to_idx: Dict[int, int] = field(init=False)

    def __post_init__(self):
        self.obj_id_to_idx = {o.obj_id: i for i, o in enumerate(self.objects)}

    def group_detections(self, detections: List[Dict]) -> Dict[Tuple[int, int], List[Dict]]:
        """(scene id, image id) -> its detections scoring at least
        seg_filter_score."""
        out: Dict[Tuple[int, int], List[Dict]] = {}
        for det in detections:
            if det["score"] < self.seg_filter_score:
                continue
            out.setdefault((int(det["scene_id"]), int(det["image_id"])), []).append(det)
        return out

    def assemble_instances(self, frame: Dict, dets: List[Dict], whole_pts: np.ndarray,
                           rng=None):
        """Per-instance crops and clouds of one frame. Returns (instances,
        kept detections); each instance carries `obj_idx`, its object's
        index for the template lookup."""
        rng = rng or np.random.RandomState(0)
        insts, kept = [], []
        for det in dets:
            obj_idx = self.obj_id_to_idx.get(int(det["category_id"]))
            if obj_idx is None:
                continue
            obj = self.objects[obj_idx]
            mask = np.logical_and(rle_decode_coco(det["segmentation"]) > 0,
                                  frame["depth"] > 0)
            if mask.sum() <= self.minimum_n_point:
                continue
            radius = float(np.linalg.norm(obj.sample_points(1024), axis=1).max())
            inst = prepare_instance(frame["rgb"], whole_pts, mask, radius, self.img_size,
                                    self.n_sample_observed, rng,
                                    rgb_mask_flag=self.rgb_mask_flag)
            if inst is None:
                continue
            inst["obj_idx"] = obj_idx
            insts.append(inst)
            kept.append(det)
        return insts, kept

    def template_views(self, obj: BOPObject, rng=None) -> Dict[str, np.ndarray]:
        """Every template view of one object, prepared and stacked
        (reference _get_template :164-187)."""
        rng = rng or np.random.RandomState(2)
        total = len(glob.glob(os.path.join(obj.template_dir, "rgb_*.png")))
        views = []
        for v in range(self.n_template_view):
            rgb, mask, xyz = obj.load_template(int(total / self.n_template_view * v))
            views.append(prepare_template(rgb, mask, xyz, self.img_size,
                                          self.n_sample_template, rng,
                                          rgb_mask_flag=self.rgb_mask_flag))
        return {k: np.stack([v[k] for v in views]) for k in ("rgb", "choose", "pts")}
