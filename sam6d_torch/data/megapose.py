"""MegaPose web-shard training dataset reader for PEM: the port's own copy
of `sam6d_tpu/data/megapose.py`, kept line for line so the random draws, and
so the batches, are the JAX package's for the same RandomState.

Parity target: reference `Pose_Estimation_Model/provider/training_dataset.py`
(:32-312): GSO + ShapeNet shard lookup via key_to_shard.json, per-sample
random visible instance, mask-dilation augmentation, depth->cloud with
model-frame outlier cut, 2048-point sampling, colour augmentation, random
SO(3) rotation + small translation augmentation, two fixed template views
(xyz * 0.1 scale, :294).

The gdrnpp imgaug colour pipeline (training_dataset.py:81-99) is implemented
in full: all 13 ops (CoarseDropout, GaussianBlur, the four PIL ImageEnhance
ops, Add, Invert, Multiply x2, AdditiveGaussianNoise, LinearContrast,
Grayscale), each behind its Sometimes probability, executed in random order
per image and clipped back to uint8 between ops, the per-op contract imgaug
applies.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .preprocess import (
    get_bbox_square, get_resize_rgb_choose, normalize_rgb, bilinear_resize,
    choose_sample)
from .rle import rle_counts_to_mask


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Random Euler composition (reference data_utils.get_random_rotation)."""
    a = rng.rand(3) * 2 * np.pi
    Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0],
                   [-np.sin(a[1]), 0, np.cos(a[1])]])
    Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                   [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).astype(np.float32)


# --------------------------------------------------------------------------
# gdrnpp color augmentation (reference training_dataset.py:81-99): the full
# 13-op imgaug Sequential, random_order=True. Each op is uint8 -> uint8
# (imgaug clips back to the input dtype after every augmenter); the pillike
# ops delegate to PIL.ImageEnhance — the same backend imgaug wraps.

def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _enhance(img: np.ndarray, which: str, factor: float) -> np.ndarray:
    from PIL import ImageEnhance
    pil = Image.fromarray(img)
    enh = getattr(ImageEnhance, which)(pil)
    return np.asarray(enh.enhance(factor))


def _aug_coarse_dropout(img, rng):  # CoarseDropout(p=0.2, size_percent=0.05)
    h, w = img.shape[:2]
    lh, lw = max(1, int(round(h * 0.05))), max(1, int(round(w * 0.05)))
    drop = rng.rand(lh, lw) < 0.2
    ys = (np.arange(h) * lh // h).clip(max=lh - 1)
    xs = (np.arange(w) * lw // w).clip(max=lw - 1)
    full = drop[ys[:, None], xs[None, :]]
    out = img.copy()
    out[full] = 0
    return out


def _aug_gaussian_blur(img, rng):  # GaussianBlur((0., 3.))
    from scipy.ndimage import gaussian_filter
    sigma = rng.uniform(0.0, 3.0)
    if sigma < 1e-3:
        return img
    return _u8(gaussian_filter(img.astype(np.float32),
                               sigma=(sigma, sigma, 0)))


def _aug_sharpness(img, rng):   # pillike.EnhanceSharpness(factor=(0., 50.))
    return _enhance(img, "Sharpness", rng.uniform(0.0, 50.0))


def _aug_contrast(img, rng):    # pillike.EnhanceContrast(factor=(0.2, 50.))
    return _enhance(img, "Contrast", rng.uniform(0.2, 50.0))


def _aug_brightness(img, rng):  # pillike.EnhanceBrightness(factor=(0.1, 6.))
    return _enhance(img, "Brightness", rng.uniform(0.1, 6.0))


def _aug_color(img, rng):       # pillike.EnhanceColor(factor=(0., 20.))
    return _enhance(img, "Color", rng.uniform(0.0, 20.0))


def _aug_add(img, rng):         # Add((-25, 25), per_channel=0.3)
    n = 3 if rng.rand() < 0.3 else 1
    v = rng.uniform(-25, 25, size=(n,))
    if n == 1:
        v = np.repeat(v, 3)
    return _u8(img.astype(np.float32) + v[None, None, :])


def _aug_invert(img, rng):      # Invert(0.2, per_channel=True)
    inv = rng.rand(3) < 0.2
    out = img.copy()
    out[..., inv] = 255 - out[..., inv]
    return out


def _aug_multiply_pc(img, rng):  # Multiply((0.6, 1.4), per_channel=0.5)
    n = 3 if rng.rand() < 0.5 else 1
    v = rng.uniform(0.6, 1.4, size=(n,))
    if n == 1:
        v = np.repeat(v, 3)
    return _u8(img.astype(np.float32) * v[None, None, :])


def _aug_multiply(img, rng):    # Multiply((0.6, 1.4))
    return _u8(img.astype(np.float32) * rng.uniform(0.6, 1.4))


def _aug_gauss_noise(img, rng):  # AdditiveGaussianNoise(scale=10, per_channel=True)
    return _u8(img.astype(np.float32) + rng.randn(*img.shape) * 10.0)


def _aug_linear_contrast(img, rng):  # LinearContrast((0.5, 2.2), per_channel=0.3)
    n = 3 if rng.rand() < 0.3 else 1
    a = rng.uniform(0.5, 2.2, size=(n,))
    if n == 1:
        a = np.repeat(a, 3)
    return _u8(127.0 + a[None, None, :] * (img.astype(np.float32) - 127.0))


def _aug_grayscale(img, rng):   # Grayscale(alpha=(0.0, 1.0))
    alpha = rng.uniform(0.0, 1.0)
    f = img.astype(np.float32)
    # imgaug grayscale = RGB2GRAY luminosity weights
    g = (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2])[..., None]
    return _u8(f * (1 - alpha) + g * alpha)


# (Sometimes probability, op) in the reference's Sequential order; the order
# is shuffled per image (random_order=True)
GDRNPP_AUG_CHAIN = (
    (0.5, _aug_coarse_dropout),
    (0.4, _aug_gaussian_blur),
    (0.3, _aug_sharpness),
    (0.3, _aug_contrast),
    (0.5, _aug_brightness),
    (0.3, _aug_color),
    (0.5, _aug_add),
    (0.3, _aug_invert),
    (0.5, _aug_multiply_pc),
    (0.5, _aug_multiply),
    (0.1, _aug_gauss_noise),
    (0.5, _aug_linear_contrast),
    (0.5, _aug_grayscale),
)


def color_augment(rgb: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The full gdrnpp photometric chain (training_dataset.py:81-99):
    13 ops, each applied with its Sometimes probability, in random order."""
    img = np.ascontiguousarray(rgb, np.uint8)
    order = rng.permutation(len(GDRNPP_AUG_CHAIN))
    for i in order:
        p, op = GDRNPP_AUG_CHAIN[i]
        if rng.rand() < p:
            img = op(img, rng)
    return img


def dilate_mask(mask: np.ndarray, iterations: int = 4) -> np.ndarray:
    """Cross-kernel binary dilation (reference cv2.dilate MORPH_CROSS x4)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        up = np.zeros_like(m); up[:-1] = m[1:]
        dn = np.zeros_like(m); dn[1:] = m[:-1]
        lf = np.zeros_like(m); lf[:, :-1] = m[:, 1:]
        rt = np.zeros_like(m); rt[:, 1:] = m[:, :-1]
        m = m | up | dn | lf | rt
    return m


@dataclass
class MegaPoseDataset:
    """Training sample assembly over extracted MegaPose shards.

    data_dir layout (reference): {data_dir}/MegaPose-GSO/..., with
    key_to_shard.json mapping sample keys to shard subpaths, and per-key
    files `{key}.{rgb.jpg,depth.png,camera.json,gt.json,gt_info.json,
    mask_visib.json}`; templates under templates/ per object.
    """
    data_dir: str
    img_size: int = 224
    n_sample_observed: int = 2048
    n_sample_template: int = 5000
    min_visib_fract: float = 0.1
    min_px_count_visib: int = 512
    shift_range: float = 0.01
    rgb_mask_flag: bool = True
    dilate_mask_aug: bool = True
    template_scale: float = 0.1  # xyz * 0.1, training_dataset.py:294

    def __post_init__(self):
        """Shard key discovery (reference training_dataset.py:49-72):
        {base}/train_pbr_web/key_to_shard.json ->
        {base}/train_pbr_web/shard-{s:06d}/{key}."""
        self.keys: List[str] = []
        self.model_info: Dict[str, List] = {}
        for sub, models_json in [("MegaPose-GSO", "gso_models.json"),
                                 ("MegaPose-ShapeNetCore", "shapenet_models.json")]:
            web = os.path.join(self.data_dir, sub, "train_pbr_web")
            p = os.path.join(web, "key_to_shard.json")
            if os.path.exists(p):
                mapping = json.load(open(p))
                for key, shard in mapping.items():
                    self.keys.append(os.path.join(
                        sub, "train_pbr_web", f"shard-{int(shard):06d}", str(key)))
                mj = os.path.join(web, models_json)
                if os.path.exists(mj):
                    self.model_info[sub] = json.load(open(mj))

    def __len__(self):
        return len(self.keys)

    def _template(self, dataset_type: str, obj_id: int, idx: int,
                  rng: np.random.RandomState):
        """Template path resolution (reference _get_template :246-270):
        GSO -> templates/{gso_id}; ShapeNetCore ->
        templates/{synset_id}/{source_id}."""
        if dataset_type == "gso":
            info = self.model_info.get("MegaPose-GSO", [])
            if obj_id >= len(info):
                return None
            base = os.path.join(self.data_dir, "MegaPose-GSO", "templates",
                                info[obj_id]["gso_id"])
        else:
            info = self.model_info.get("MegaPose-ShapeNetCore", [])
            if obj_id >= len(info):
                return None
            base = os.path.join(self.data_dir, "MegaPose-ShapeNetCore",
                                "templates",
                                info[obj_id]["shapenet_synset_id"],
                                info[obj_id]["shapenet_source_id"])
        rgb_p = os.path.join(base, f"rgb_{idx}.png")
        if not os.path.exists(rgb_p):
            return None
        rgb = np.array(Image.open(rgb_p).convert("RGB"))
        mask = np.array(Image.open(os.path.join(base, f"mask_{idx}.png"))) == 255
        xyz = np.load(os.path.join(base, f"xyz_{idx}.npy")).astype(np.float32)

        bbox = get_bbox_square(mask)
        y1, y2, x1, x2 = bbox
        m = mask[y1:y2, x1:x2]
        r = rgb[:, :, ::-1][y1:y2, x1:x2]
        if self.rgb_mask_flag:
            r = r * (m[:, :, None] > 0).astype(np.uint8)
        r = normalize_rgb(bilinear_resize(r, self.img_size, self.img_size))
        choose = (m > 0).astype(np.float32).flatten().nonzero()[0]
        idxs = choose_sample(len(choose), self.n_sample_template, rng)
        choose = choose[idxs]
        pts = xyz[y1:y2, x1:x2].reshape(-1, 3)[choose] * self.template_scale
        rgb_choose = get_resize_rgb_choose(choose, bbox, self.img_size)
        return r, rgb_choose, pts

    def read_sample(self, key_path: str, rng: Optional[np.random.RandomState] = None):
        """One training sample dict or None if invalid (reference
        read_data :132-245)."""
        rng = rng or np.random.RandomState()
        head = os.path.join(self.data_dir, key_path)
        try:
            gt_info = json.load(open(head + ".gt_info.json"))
            gts = json.load(open(head + ".gt.json"))
            camera = json.load(open(head + ".camera.json"))
        except (OSError, json.JSONDecodeError):
            return None
        valid = [k for k, it in enumerate(gt_info)
                 if it["px_count_valid"] >= self.min_px_count_visib
                 and it["visib_fract"] >= self.min_visib_fract]
        if not valid:
            return None
        k = valid[rng.randint(len(valid))]
        gt = gts[k]
        obj_id = gt["obj_id"]
        target_R = np.array(gt["cam_R_m2c"], np.float32).reshape(3, 3)
        target_t = np.array(gt["cam_t_m2c"], np.float32).reshape(3) / 1000.0
        K = np.array(camera["cam_K"], np.float32).reshape(3, 3)

        dataset_type = "gso" if "GSO" in key_path else "shapenet"  # from path (reference :134)
        tem1 = self._template(dataset_type, int(obj_id), 0, rng)
        tem2 = self._template(dataset_type, int(obj_id), 1, rng)
        if tem1 is None or tem2 is None:
            return None

        masks_rle = json.load(open(head + ".mask_visib.json"))
        mask = rle_counts_to_mask(
            {"counts": masks_rle[str(k)]["counts"],
             "size": masks_rle[str(k)]["size"]}
            if isinstance(masks_rle, dict) else masks_rle[k])
        if mask.sum() == 0:
            return None
        if self.dilate_mask_aug and rng.rand() < 0.5:
            mask = dilate_mask(mask)

        bbox = get_bbox_square(mask > 0)
        y1, y2, x1, x2 = bbox
        m = mask[y1:y2, x1:x2]
        choose = m.astype(np.float32).flatten().nonzero()[0]

        depth = np.array(Image.open(head + ".depth.png")).astype(np.float32)
        depth = depth * camera["depth_scale"] / 1000.0
        H, W = depth.shape
        ys, xs = np.mgrid[y1:y2, x1:x2]
        z = depth[y1:y2, x1:x2]
        pts = np.stack([(xs - K[0, 2]) * z / K[0, 0],
                        (ys - K[1, 2]) * z / K[1, 1], z], -1).reshape(-1, 3)[choose]

        target_pts = (pts - target_t) @ target_R
        tem_pts = np.concatenate([tem1[2], tem2[2]], axis=0)
        radius = np.linalg.norm(tem_pts, axis=1).max()
        flag = np.linalg.norm(target_pts, axis=1) < radius * 1.2
        pts = pts[flag]
        choose = choose[flag]
        if len(choose) < 32:
            return None
        idxs = choose_sample(len(choose), self.n_sample_observed, rng)
        choose = choose[idxs]
        pts = pts[idxs]

        rgb = np.array(Image.open(head + ".rgb.jpg").convert("RGB"))
        rgb = rgb[:, :, ::-1][y1:y2, x1:x2]
        if rng.rand() < 0.8:
            rgb = color_augment(rgb, rng)
        if self.rgb_mask_flag:
            rgb = rgb * (m[:, :, None] > 0).astype(np.uint8)
        rgb = normalize_rgb(bilinear_resize(rgb, self.img_size, self.img_size))
        rgb_choose = get_resize_rgb_choose(choose, bbox, self.img_size)

        rand_R = random_rotation(rng)
        tem1_pts = tem1[2] @ rand_R
        tem2_pts = tem2[2] @ rand_R
        target_R = target_R @ rand_R
        add_t = rng.uniform(-self.shift_range, self.shift_range, (1, 3)).astype(np.float32)
        target_t = target_t + add_t[0]
        pts = pts + add_t + 0.001 * rng.randn(len(pts), 3).astype(np.float32)

        return dict(
            pts=pts.astype(np.float32), rgb=rgb,
            rgb_choose=rgb_choose.astype(np.int64),
            rotation_label=target_R, translation_label=target_t.astype(np.float32),
            tem1_rgb=tem1[0], tem1_choose=tem1[1].astype(np.int64),
            tem1_pts=tem1_pts.astype(np.float32),
            tem2_rgb=tem2[0], tem2_choose=tem2[1].astype(np.int64),
            tem2_pts=tem2_pts.astype(np.float32), K=K,
        )

    def sample_batch(self, batch_size: int, rng=None):
        """Rejection-sampled batch (reference _rand_another resampling)."""
        rng = rng or np.random.RandomState()
        out = []
        guard = 0
        while len(out) < batch_size and guard < batch_size * 50:
            guard += 1
            key = self.keys[rng.randint(len(self.keys))]
            s = self.read_sample(key, rng)
            if s is not None:
                out.append(s)
        if len(out) < batch_size:
            raise RuntimeError("could not assemble a full batch")
        return {k: np.stack([s[k] for s in out]) for k in out[0]}
