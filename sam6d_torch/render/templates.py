"""Offline template generation: CAD -> 42-view rgb/mask/xyz assets.

Port of `sam6d_tpu/render/templates.py` (the custom-object and BOP paths;
the training-set renders are not ported). Equivalent of the reference
`Render/render_custom_templates.py` and `render_bop_templates.py` without
Blender: icosphere level-0
camera poses (the canonical order of `render/poses.py`), the rasterizer of
`render/rasterizer.py` on the device, Lambertian headlight shading on the
host. Output contract of the reference consumers: rgb_i.png, mask_i.png
(255 = object), xyz_i.npy (float16 per-pixel LOCAL object coordinates in the
CAD's units; consumers divide by 1000 for mm CADs, see
`Pose_Estimation_Model/run_inference_custom.py:123`).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..data.mesh import Mesh, load_mesh, load_ply
from .poses import template_cam_poses
from .rasterizer import interpolate_split_attrs, rasterize, split_large_triangles

# Blender default camera: 512x512, 50mm lens on a 36mm sensor
RENDER_SIZE = 512
RENDER_FOCAL = RENDER_SIZE * 50.0 / 36.0
BASE_COLOR = 0.4  # the JAX renderer's flat material for a mesh without colors


def _sample_texture(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear texture sampling at (u, v) in the OBJ/BOP convention
    (v origin at the image bottom); out-of-range coordinates wrap."""
    H, W = tex.shape[:2]
    u = np.where((u < 0) | (u > 1), u - np.floor(u), u)
    v = np.where((v < 0) | (v > 1), v - np.floor(v), v)
    x = u * (W - 1)
    y = (1.0 - v) * (H - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    return ((tex[y0, x0] * (1 - wx) + tex[y0, x1] * wx) * (1 - wy)
            + (tex[y1, x0] * (1 - wx) + tex[y1, x1] * wx) * wy)


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def _intrinsics(image_size: int) -> np.ndarray:
    f = RENDER_FOCAL * image_size / RENDER_SIZE
    return np.array([[f, 0, image_size / 2], [0, f, image_size / 2], [0, 0, 1]], np.float32)


def render_view(mesh: Mesh, pose: np.ndarray, image_size: int = RENDER_SIZE,
                device="cuda", vertex_colors: Optional[np.ndarray] = None,
                base_color: float = BASE_COLOR):
    """Rasterize one view of `mesh` from the camera `pose` (4x4 camera to
    object) on `device`. Returns the host arrays (attr_img (S, S, 6):
    shaded rgb, or (shade, u, v) for a textured mesh, then the local xyz;
    mask (S, S) bool; textured). Appearance: `vertex_colors` (V, 3) if
    given, else the mesh's texture map, else its vertex colors, else flat
    `base_color` gray, as BlenderProc keeps CAD materials unless told
    otherwise (reference Render/render_bop_templates.py:33-47)."""
    dev = torch.device(device)
    verts = mesh.vertices.astype(np.float64)
    K = _intrinsics(image_size)
    textured = (vertex_colors is None and mesh.texture is not None
                and mesh.uv is not None)
    if not textured and vertex_colors is None:
        vertex_colors = (mesh.colors.astype(np.float32) if mesh.colors is not None
                         else np.full((len(verts), 3), base_color, np.float32))
    # world->camera: x_cam = R^T (x - t); the camera looks along +z (forward
    # column of the look-at pose)
    t = pose[:3, 3]
    Rwc = pose[:3, :3].T

    def proj(v):
        vc = (v - t) @ Rwc.T
        z = np.maximum(vc[:, 2], 1e-9)
        return np.stack([vc[:, 0] / z * K[0, 0] + K[0, 2],
                         vc[:, 1] / z * K[1, 1] + K[1, 2]], axis=1)

    sverts, sfaces, parents = split_large_triangles(verts, mesh.faces, proj)
    snormals = _vertex_normals(sverts, sfaces)
    split = len(sverts) != len(verts)
    if textured:
        suv = (interpolate_split_attrs(mesh.uv.astype(np.float32), parents)
               if split else mesh.uv)
    else:
        scolors = interpolate_split_attrs(vertex_colors, parents) if split else vertex_colors
    sv_cam = (sverts - t) @ Rwc.T

    # headlight Lambertian + ambient
    view_dir = (t - sverts)
    view_dir /= np.maximum(np.linalg.norm(view_dir, axis=1, keepdims=True), 1e-12)
    diff = np.abs((snormals * view_dir).sum(1))[:, None]
    shade = 0.35 + 0.65 * diff  # (V, 1)
    # textured: interpolate (shade, u, v) and sample the texture per pixel
    # after rasterization (perspective-correct UVs from the raster)
    head = (np.concatenate([shade, suv], axis=1) if textured
            else np.clip(scolors * shade, 0, 1))
    attrs = np.concatenate([head, sverts], axis=1).astype(np.float32)
    attr_img, mask, _ = rasterize(
        torch.as_tensor(sv_cam.astype(np.float32), device=dev),
        torch.as_tensor(sfaces.astype(np.int64), device=dev),
        torch.as_tensor(attrs, device=dev), torch.as_tensor(K, device=dev),
        image_size, image_size)
    return attr_img.cpu().numpy(), mask.cpu().numpy(), textured


def render_templates(mesh: Mesh, output_dir: str, level: int = 0,
                     image_size: int = RENDER_SIZE, views=None, device="cuda",
                     vertex_colors: Optional[np.ndarray] = None,
                     base_color: float = BASE_COLOR,
                     cam_distance: Optional[float] = None,
                     subdir: str = "templates") -> str:
    """Render the level-`level` icosphere views into `{output_dir}/{subdir}`
    (`output_dir` itself when `subdir` is empty) with the rasterizer on
    `device`. The camera sits at `cam_distance`, by default 4x the mesh
    radius (the reference custom distance: a Blender camera at 2 units with
    the object scaled by 1/(2r)); `views` optionally restricts to a subset
    of view indices (files keep their canonical view index in the name).
    Appearance as in render_view. Returns the template dir."""
    save_dir = os.path.join(output_dir, subdir) if subdir else output_dir
    os.makedirs(save_dir, exist_ok=True)
    if cam_distance is None:
        cam_distance = 4.0 * float(np.linalg.norm(mesh.vertices.astype(np.float64),
                                                  axis=1).max())
    cam_poses = template_cam_poses(level, radius=cam_distance)
    for i in (range(len(cam_poses)) if views is None else views):
        attr_img, mask, textured = render_view(mesh, cam_poses[i], image_size, device,
                                               vertex_colors, base_color)
        if textured:
            texel = _sample_texture(mesh.texture, attr_img[..., 1], attr_img[..., 2])
            shaded_px = np.clip(texel * attr_img[..., 0:1], 0, 1)
            shaded_px = np.where(mask[..., None], shaded_px, 0.0)
            rgb = (shaded_px * 255).astype(np.uint8)
        else:
            rgb = (np.clip(attr_img[..., :3], 0, 1) * 255).astype(np.uint8)
        xyz = attr_img[..., 3:6].astype(np.float32)
        Image.fromarray(rgb).save(os.path.join(save_dir, f"rgb_{i}.png"))
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(save_dir, f"mask_{i}.png"))
        np.save(os.path.join(save_dir, f"xyz_{i}.npy"), xyz.astype(np.float16))
    return save_dir


def render_custom_templates(cad_path: str, output_dir: str, level: int = 0,
                            image_size: int = RENDER_SIZE, device="cuda") -> str:
    """The `render` entry point (reference render_custom_templates.py, a
    mm-unit CAD in PLY or OBJ)."""
    return render_templates(load_mesh(cad_path), output_dir, level=level,
                            image_size=image_size, device=device)


def render_bop_templates(dataset_dir: str, output_root: str, dataset_name: str,
                         level: int = 0, obj_ids=None, image_size: int = RENDER_SIZE,
                         device="cuda"):
    """Template sets of every object of one BOP dataset (reference
    Render/render_bop_templates.py:28-47), written straight into
    `{output_root}/{dataset_name}/obj_{id:06d}/`: the camera at 2x the
    diameter (the reference scales the CAD by 1/diameter with the camera at
    2 Blender units); tless renders `models_cad` in the reference's gray 0.4
    material, the other datasets keep the CAD's own appearance. xyz_i.npy
    holds local mm coordinates, as BOPObject.load_template and the
    reference's PEM consumer (bop_object_utils.py:57) expect. Returns the
    object directories."""
    model_path = os.path.join(dataset_dir, "models_cad" if dataset_name == "tless" else "models")
    with open(os.path.join(model_path, "models_info.json")) as f:
        info = json.load(f)
    out_dirs = []
    for key in sorted(info.keys(), key=int):
        obj_id = int(key)
        if obj_ids is not None and obj_id not in obj_ids:
            continue
        mesh = load_ply(os.path.join(model_path, f"obj_{obj_id:06d}.ply"))
        out_dir = os.path.join(output_root, dataset_name, f"obj_{obj_id:06d}")
        gray = (np.full((len(mesh.vertices), 3), 0.4, np.float32)
                if dataset_name == "tless" else None)
        render_templates(mesh, out_dir, level=level, image_size=image_size, device=device,
                         vertex_colors=gray, base_color=0.4,
                         cam_distance=2.0 * float(info[key]["diameter"]), subdir="")
        out_dirs.append(out_dir)
    return out_dirs
