"""A synthetic PEM job on disk, made from a seed with numpy.

Writes what the `pem` stage reads: a box mesh (PLY, mm), 42 template views
(rgb_i.png, mask_i.png, xyz_i.npy: a z-buffered point splat of the mesh
surface under random rotations), one 480x640 RGB-D frame with the box at
0.6 m, camera.json and detection_ism.json (COCO-RLE masks over valid depth).
`write_ism_job` adds the fixed-capacity proposal buffer the ISM matching
stage reads; `write_stream_frames` a second box of other extents and frames
in which both boxes have moved, for the `stream` entry point;
`write_bop_job` a BOP dataset tree of two boxes (models, a test scene, a
train_pbr scene and a BOP-23 detections json) for `render-bop` and
`bop-eval`. Used by `chip_smoke.py` and the port's tests; no released data
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


def box_ply(path, half=(40.0, 30.0, 20.0)):
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
    box_ply(cad)
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


SECOND_BOX_HALF = (25.0, 35.0, 15.0)
SECOND_BOX_OFFSET_MM = np.array([130.0, 20.0, 40.0], np.float32)


def write_stream_frames(job_dir: str, rng: np.random.RandomState, n_moved: int = 3):
    """The frames of a two-object stream for the job in `job_dir` (made by
    write_pem_job): writes obj2.ply (a box of SECOND_BOX_HALF extents) and
    frames/rgb_{k:03d}.png, depth_{k:03d}.png, where frame 0 is the job's
    frame and frames 1..n_moved show the job's box moved by up to 40 mm and
    the second box beside it (SECOND_BOX_OFFSET_MM), both under random
    rotations. Returns (path of obj2.ply, frames dir, [(rgb, depth)] arrays,
    depth float32 in mm)."""
    cad2 = os.path.join(job_dir, "obj2.ply")
    box_ply(cad2, SECOND_BOX_HALF)
    fdir = os.path.join(job_dir, "frames")
    os.makedirs(fdir, exist_ok=True)
    rgb0 = np.array(Image.open(os.path.join(job_dir, "rgb.png")))
    depth0 = np.array(Image.open(os.path.join(job_dir, "depth.png")))
    frames = [(rgb0, depth0)]
    surfs = [load_ply(p).sample(200000, rng)
             for p in (os.path.join(job_dir, "obj.ply"), cad2)]
    for _ in range(n_moved):
        t1 = T_CAM_MM + rng.uniform(-40, 40, 3).astype(np.float32)
        cams = [surfs[0] @ random_rotation(rng).T + t1,
                surfs[1] @ random_rotation(rng).T + t1 + SECOND_BOX_OFFSET_MM]
        cols = [(s / 80.0 + 0.5).clip(0, 1) * 255.0 for s in surfs]
        depth, pay, _ = _splat(np.concatenate(cams), K_CAM, (480, 640), np.concatenate(cols))
        frames.append((pay.astype(np.uint8), np.round(depth).astype(np.uint16)))
    for k, (rgb, depth) in enumerate(frames):
        Image.fromarray(rgb).save(os.path.join(fdir, f"rgb_{k:03d}.png"))
        Image.fromarray(depth).save(os.path.join(fdir, f"depth_{k:03d}.png"))
    return cad2, fdir, [(rgb, depth.astype(np.float32)) for rgb, depth in frames]


LMO_K = K_CAM      # the LineMOD camera (BOP lmo scene_camera.json)


def _write_ply_box(path: str, half) -> float:
    """A box PLY of half extents `half` (mm); returns its diameter (the
    box's diagonal, as BOP's models_info.json gives it)."""
    box_ply(path, half)
    return float(2.0 * np.linalg.norm(half))


def _splat_scene(surfs, poses, K, hw, colours):
    """Several objects (mm surface samples, (R, t) each) splatted into one
    frame. Returns (depth (H, W) mm, rgb uint8, visible masks (n, H, W),
    visible fractions (n,)): a pixel belongs to the nearest object."""
    depths, pays, hits = [], [], []
    for surf, (R, t), col in zip(surfs, poses, colours):
        d, pay, hit = _splat(surf @ R.T + t, K, hw, col)
        depths.append(np.where(hit, d, np.inf))
        pays.append(pay)
        hits.append(hit)
    depths = np.stack(depths)
    owner = depths.argmin(axis=0)
    any_hit = np.isfinite(depths.min(axis=0))
    visible = np.stack([(owner == i) & any_hit for i in range(len(surfs))])
    rgb = np.zeros(hw + (3,), np.float32)
    for i, pay in enumerate(pays):
        rgb[visible[i]] = pay[visible[i]]
    depth = np.where(any_hit, depths.min(axis=0), 0.0)
    fract = np.array([v.sum() / max(h.sum(), 1) for v, h in zip(visible, hits)])
    return depth, rgb.astype(np.uint8), visible, fract


def write_bop_job(root: str, rng: np.random.RandomState, obj_ids=(1, 5),
                  n_test_frames: int = 2, n_pbr_images: int = 24, n_det: int = 16,
                  hw=(480, 640), n_surface: int = 100000):
    """A BOP dataset tree under `root` (lmo's layout and camera, scaled to
    `hw`):

    - models/obj_{id:06d}.ply: two boxes in mm (the job's box and a box of
      SECOND_BOX_HALF extents), models_info.json with their diameters;
    - test/000001: `n_test_frames` RGB-D frames at `hw` with both boxes
      under random rotations side by side (rgb/*.png, uint16 mm depth/*.png,
      scene_camera.json);
    - train_pbr/000000: `n_pbr_images` frames (rgb/*.jpg, depth/*.png,
      mask_visib/*_*.png, scene_gt.json, scene_gt_info.json with the
      visible fractions, scene_camera.json), each with two instances of
      each box, so each object has 2 x n_pbr_images candidates;
    - detections.json: BOP-23 records, `n_det` a test frame (half on each
      box): rectangles cut from the box's visible pixels, RLE-encoded,
      scores 0.5-0.95.

    Returns dict(dataset_dir, seg_path, obj_ids, n_test_frames, dets)."""
    H, W = hw
    mdir = os.path.join(root, "models")
    os.makedirs(mdir, exist_ok=True)
    halves = [(40.0, 30.0, 20.0), SECOND_BOX_HALF]
    info, surfs, colours = {}, [], []
    for oid, half in zip(obj_ids, halves):
        path = os.path.join(mdir, f"obj_{oid:06d}.ply")
        info[str(oid)] = {"diameter": _write_ply_box(path, half),
                          "min_x": -half[0], "min_y": -half[1], "min_z": -half[2],
                          "size_x": 2 * half[0], "size_y": 2 * half[1], "size_z": 2 * half[2]}
        surf = load_ply(path).sample(n_surface, rng)
        surfs.append(surf)
        colours.append((surf / (2.0 * max(half)) + 0.5).clip(0, 1) * 255.0)
    with open(os.path.join(mdir, "models_info.json"), "w") as f:
        json.dump(info, f)
    # lmo's camera, scaled when the frames are smaller than lmo's 480x640
    K = LMO_K * np.array([[W / 640.0], [H / 480.0], [1.0]], np.float32)
    cam = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}

    def write_frames(scene_dir, n, offsets, rgb_ext):
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
        frames = []
        for k in range(n):
            poses = [(random_rotation(rng), np.array(o, np.float32)
                      + rng.uniform(-10, 10, 3).astype(np.float32)) for o in offsets]
            inst_surfs = [surfs[i % 2] for i in range(len(offsets))]
            inst_cols = [colours[i % 2] for i in range(len(offsets))]
            depth, rgb, visible, fract = _splat_scene(inst_surfs, poses, K, hw, inst_cols)
            Image.fromarray(rgb).save(os.path.join(scene_dir, "rgb", f"{k:06d}.{rgb_ext}"))
            Image.fromarray(np.round(depth).astype(np.uint16)).save(
                os.path.join(scene_dir, "depth", f"{k:06d}.png"))
            frames.append((poses, visible, fract))
        with open(os.path.join(scene_dir, "scene_camera.json"), "w") as f:
            json.dump({str(k): cam for k in range(n)}, f)
        return frames

    # test scene: the two boxes side by side
    test_dir = os.path.join(root, "test", "000001")
    test = write_frames(test_dir, n_test_frames,
                        [(-60.0, 0.0, 600.0), (70.0, 10.0, 620.0)], "png")
    dets = []
    for k, (_, visible, _) in enumerate(test):
        for j in range(n_det):
            obj = j % 2
            rows, cols = np.nonzero(visible[obj])
            r0, r1, c0, c1 = rows.min(), rows.max(), cols.min(), cols.max()
            dr, dc = rng.randint(0, max(2, (r1 - r0) // 6), 2)
            m = np.zeros((H, W), bool)
            m[r0 + dr:r1 - dr // 2 + 1, c0 + dc:c1 - dc // 2 + 1] = True
            m &= visible[obj]
            ys, xs = np.nonzero(m)
            dets.append(dict(scene_id=1, image_id=k, category_id=int(obj_ids[obj]),
                             bbox=[int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                                   int(ys.max() - ys.min() + 1)],
                             score=float(0.5 + 0.45 * j / max(n_det - 1, 1)), time=0.0,
                             segmentation=rle_encode_coco(m.astype(np.uint8))))
    seg_path = os.path.join(root, "detections.json")
    with open(seg_path, "w") as f:
        json.dump(dets, f)

    # train_pbr scene: two instances of each box a frame, in four corners
    pbr_dir = os.path.join(root, "train_pbr", "000000")
    os.makedirs(os.path.join(pbr_dir, "mask_visib"), exist_ok=True)
    pbr = write_frames(pbr_dir, n_pbr_images,
                       [(-80.0, -60.0, 620.0), (80.0, -60.0, 650.0),
                        (80.0, 60.0, 640.0), (-80.0, 60.0, 610.0)], "jpg")
    gt, gt_info = {}, {}
    for k, (poses, visible, fract) in enumerate(pbr):
        gt[str(k)] = [dict(obj_id=int(obj_ids[i % 2]), cam_R_m2c=R.reshape(-1).tolist(),
                           cam_t_m2c=t.tolist()) for i, (R, t) in enumerate(poses)]
        gt_info[str(k)] = [dict(visib_fract=float(v), px_count_visib=int(m.sum()))
                           for v, m in zip(fract, visible)]
        for i, m in enumerate(visible):
            Image.fromarray((m * 255).astype(np.uint8)).save(
                os.path.join(pbr_dir, "mask_visib", f"{k:06d}_{i:06d}.png"))
    for name, obj in (("scene_gt.json", gt), ("scene_gt_info.json", gt_info)):
        with open(os.path.join(pbr_dir, name), "w") as f:
            json.dump(obj, f)
    return dict(dataset_dir=root, seg_path=seg_path, obj_ids=list(obj_ids),
                n_test_frames=n_test_frames, dets=dets)
