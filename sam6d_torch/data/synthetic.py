"""A synthetic PEM job on disk, made from a seed with numpy.

Writes what the `pem` stage reads: a box mesh (PLY, mm), 42 template views
(rgb_i.png, mask_i.png, xyz_i.npy: a z-buffered point splat of the mesh
surface under random rotations), one 480x640 RGB-D frame with the box at
0.6 m, camera.json and detection_ism.json (COCO-RLE masks over valid depth).
`write_ism_job` adds the fixed-capacity proposal buffer the ISM matching
stage reads. Used by `chip_smoke.py` and the port's tests; no released data
is needed.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from .mesh import load_ply
from .rle import rle_decode_coco, rle_encode_coco

K_CAM = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float32)
T_CAM_MM = np.array([10.0, -5.0, 600.0], np.float32)


def _box_ply(path, half=(40.0, 30.0, 20.0)):
    """A closed box mesh in millimetres."""
    hx, hy, hz = half
    v = np.array([[sx * hx, sy * hy, sz * hz] for sx in (-1, 1)
                  for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 8\nproperty float x\n"
                "property float y\nproperty float z\nelement face 12\n"
                "property list uchar int vertex_indices\nend_header\n")
        f.writelines(f"{x} {y} {z}\n" for x, y, z in v)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)


def random_rotation(rng) -> np.ndarray:
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
        np.float32)


def _splat(pts_cam, K, hw, payload):
    """Nearest point per pixel -> (depth (H, W), payload (H, W, C), hit)."""
    H, W = hw
    u = np.round(pts_cam[:, 0] / pts_cam[:, 2] * K[0, 0] + K[0, 2]).astype(int)
    v = np.round(pts_cam[:, 1] / pts_cam[:, 2] * K[1, 1] + K[1, 2]).astype(int)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pix, z, pay = (v * W + u)[ok], pts_cam[ok, 2], payload[ok]
    order = np.lexsort((z, pix))
    first = order[np.concatenate([[True], pix[order][1:] != pix[order][:-1]])]
    depth = np.zeros(H * W, np.float32)
    out = np.zeros((H * W, payload.shape[1]), np.float32)
    depth[pix[first]] = z[first]
    out[pix[first]] = pay[first]
    return depth.reshape(H, W), out.reshape(H, W, -1), depth.reshape(H, W) > 0


def write_pem_job(job_dir: str, rng: np.random.RandomState, n_det: int = 16,
                  n_views: int = 42):
    """Write the job into `job_dir`; returns paths, the frame arrays, the
    detections and the true pose (R, t in mm)."""
    cad = os.path.join(job_dir, "obj.ply")
    _box_ply(cad)
    surf = load_ply(cad).sample(200000, rng)                 # mm, model frame
    colour = (surf / 80.0 + 0.5).clip(0, 1) * 255.0

    tdir = os.path.join(job_dir, "templates")
    os.makedirs(tdir, exist_ok=True)
    K_t = np.array([[500.0, 0, 128.0], [0, 500.0, 128.0], [0, 0, 1]], np.float32)
    for i in range(n_views):
        cam = surf @ random_rotation(rng).T + np.array([0, 0, 500.0], np.float32)
        _, pay, hit = _splat(cam, K_t, (256, 256), np.concatenate([surf, colour], 1))
        Image.fromarray(pay[..., 3:].astype(np.uint8)).save(f"{tdir}/rgb_{i}.png")
        Image.fromarray((hit * 255).astype(np.uint8)).save(f"{tdir}/mask_{i}.png")
        np.save(f"{tdir}/xyz_{i}.npy", pay[..., :3].astype(np.float32))

    R = random_rotation(rng)
    depth, pay, hit = _splat(surf @ R.T + T_CAM_MM, K_CAM, (480, 640), colour)
    rgb = pay.astype(np.uint8)
    depth = np.round(depth)
    paths = {k: os.path.join(job_dir, f) for k, f in (
        ("cad", "obj.ply"), ("rgb", "rgb.png"), ("depth", "depth.png"),
        ("cam", "camera.json"), ("seg", "detection_ism.json"))}
    Image.fromarray(rgb).save(paths["rgb"])
    Image.fromarray(depth.astype(np.uint16)).save(paths["depth"])
    with open(paths["cam"], "w") as f:
        json.dump({"cam_K": K_CAM.reshape(-1).tolist(), "depth_scale": 1.0}, f)

    rows, cols = np.nonzero(hit)
    r0, r1, c0, c1 = rows.min(), rows.max(), cols.min(), cols.max()
    dets = []
    for k in range(n_det):
        m = np.zeros_like(hit)
        dr, dc = rng.randint(0, max(2, (r1 - r0) // 6), 2)
        m[r0 + dr:r1 - dr // 2 + 1, c0 + dc:c1 - dc // 2 + 1] = True
        m &= hit
        ys, xs = np.nonzero(m)
        dets.append(dict(scene_id=0, image_id=0, category_id=1,
                         bbox=[int(xs.min()), int(ys.min()),
                               int(xs.max() - xs.min() + 1),
                               int(ys.max() - ys.min() + 1)],
                         score=float(0.5 + 0.03 * k),
                         segmentation=rle_encode_coco(m.astype(np.uint8))))
    with open(paths["seg"], "w") as f:
        json.dump(dets, f)
    return dict(paths, rgb_arr=rgb, depth_arr=depth.astype(np.float32),
                dets=dets, pose=(R, T_CAM_MM))


def _blob(rng, hit: np.ndarray, min_pixels: int = 200) -> np.ndarray:
    """A random ellipse inside the object's visible pixels `hit`."""
    H, W = hit.shape
    rows, cols = np.nonzero(hit)
    yy, xx = np.mgrid[:H, :W]
    while True:
        k = rng.randint(len(rows))
        ry, rx = rng.randint(6, 40, 2)
        m = (((yy - rows[k]) / ry) ** 2 + ((xx - cols[k]) / rx) ** 2 <= 1.0) & hit
        if m.sum() >= min_pixels:
            return m


def write_ism_job(job_dir: str, rng: np.random.RandomState, n_slots: int = 128,
                  n_valid: int = 48, n_det: int = 16, n_views: int = 42):
    """write_pem_job plus a proposal buffer of `n_slots` masks, of which the
    first `n_valid` are valid (the segmentor emits valid proposals as a
    prefix): slots 0..n_det-1 are the job's detection masks, the others
    random blobs on the object. Written to proposals.npz (masks (K, H, W)
    bool, boxes (K, 4) float32 xyxy, valid (K,) bool); returns the job dict
    with `proposals` added."""
    job = write_pem_job(job_dir, rng, n_det=n_det, n_views=n_views)
    hit = job["depth_arr"] > 0
    masks = [rle_decode_coco(d["segmentation"]) for d in job["dets"]]
    masks += [_blob(rng, hit) for _ in range(n_slots - n_det)]
    masks = np.stack(masks)
    boxes = np.zeros((n_slots, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    proposals = dict(masks=masks, boxes=boxes, valid=np.arange(n_slots) < n_valid)
    np.savez_compressed(os.path.join(job_dir, "proposals.npz"), **proposals)
    return dict(job, proposals=proposals)
