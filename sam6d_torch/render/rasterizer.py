"""Triangle rasterizer for offline template rendering, in PyTorch on the
device.

Port of `sam6d_tpu/render/rasterizer.py`, the replacement for the
reference's BlenderProc stage (`Render/render_custom_templates.py`): RGB
(Lambertian headlight + ambient on vertex/base colors), a coverage mask and
per-pixel local object coordinates (the xyz channel read by `_get_template`,
`Pose_Estimation_Model/run_inference_custom.py:117-146`).

Every triangle is tested against a fixed 32x32 pixel tile anchored at its
bbox (triangles larger than a tile are split on the host first), in chunks
of FACE_CHUNK faces. Pass 1 z-resolves with a scatter-min of the fragment
depths over the linear pixel index; pass 2 picks, at every pixel, the
winning fragment (depth within 1e-6 relative of the z-buffer) that comes
LAST in face order, by a scatter-max of the fragment index. That rule is
what the JAX version's in-order scatter of the winners' attributes gives,
made explicit: a scatter of duplicate indices is nondeterministic on CUDA.
The winners' attributes are then evaluated once per pixel, with the same
float32 arithmetic as the fragments.

The rasterizer is plain tensor code, as the JAX one is plain XLA: there is
no Pallas kernel behind it.
"""
from __future__ import annotations

import numpy as np
import torch

TILE = 32
FACE_CHUNK = 4096
_BIG = 1e30


def split_large_triangles(verts: np.ndarray, faces: np.ndarray,
                          proj_fn, max_px: float = TILE - 2.0,
                          max_iter: int = 6):
    """Host-side: subdivide faces whose projected bbox exceeds max_px (any
    view among proj list). proj_fn: verts -> (V, 2) screen coords.

    Returns (verts, faces, parents): parents (V', 2) int32 maps every vertex
    to the two vertices it bisects (original vertices map to themselves), so
    callers can midpoint-interpolate any per-vertex attribute (colors, UVs)
    by chaining parents through the split generations."""
    faces = faces.copy()
    parents = np.stack([np.arange(len(verts))] * 2, axis=1).astype(np.int64)
    for _ in range(max_iter):
        xy = proj_fn(verts)
        tri = xy[faces]  # (F, 3, 2)
        ext = tri.max(1) - tri.min(1)
        big = (ext.max(-1) > max_px)
        if not big.any():
            break
        keep = faces[~big]
        split = faces[big]
        # midpoint split on the longest edge
        v = verts
        new_faces = []
        new_verts = [v]
        new_parents = [parents]
        next_id = len(v)
        for (a, b, c) in split:
            pts = xy[[a, b, c]]
            e = [np.linalg.norm(pts[0] - pts[1]), np.linalg.norm(pts[1] - pts[2]),
                 np.linalg.norm(pts[2] - pts[0])]
            k = int(np.argmax(e))
            pair = [(a, b, c), (b, c, a), (c, a, b)][k]
            m = (v[pair[0]] + v[pair[1]]) / 2.0
            new_verts.append(m[None])
            new_parents.append(np.asarray([[pair[0], pair[1]]], np.int64))
            new_faces.append((pair[0], next_id, pair[2]))
            new_faces.append((next_id, pair[1], pair[2]))
            next_id += 1
        verts = np.concatenate(new_verts, axis=0)
        parents = np.concatenate(new_parents, axis=0)
        faces = np.concatenate([keep, np.asarray(new_faces, faces.dtype)], axis=0)
    return verts, faces, parents


def interpolate_split_attrs(attr: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """Extend a per-vertex attribute (V0, A) to split vertices (V', A) by
    averaging each new vertex's two parents (parents from
    split_large_triangles; parent rows always precede their children)."""
    out = np.empty((len(parents),) + attr.shape[1:], attr.dtype)
    out[:len(attr)] = attr
    for i in range(len(attr), len(parents)):
        a, b = parents[i]
        out[i] = 0.5 * (out[a] + out[b])
    return out


def _barycentric(tri, inv_z, pxf, pyf):
    """Edge functions of the pixel centres (pxf, pyf) against triangles `tri`
    (..., 3, 2), broadcast over the leading axes. Returns (inside, the
    perspective weights wa, wb, wc, depth). The arithmetic is the JAX
    rasterizer's, in its order."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]

    def edge(x0, y0, x1, y1):
        return (x1 - x0) * (pyf - y0) - (y1 - y0) * (pxf - x0)

    e0 = edge(bx, by, cx, cy)
    e1 = edge(cx, cy, ax, ay)
    e2 = edge(ax, ay, bx, by)
    area = e0 + e1 + e2
    pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    big = area.abs() > 1e-12
    inside = (pos | neg) & big
    denom = torch.where(big, area, torch.ones_like(area))
    wa = e0 / denom * inv_z[..., 0]
    wb = e1 / denom * inv_z[..., 1]
    wc = e2 / denom * inv_z[..., 2]
    depth = 1.0 / torch.clamp(wa + wb + wc, min=1e-12)
    return inside, wa, wb, wc, depth


def rasterize(verts_cam: torch.Tensor, faces: torch.Tensor, attrs: torch.Tensor,
              K: torch.Tensor, height: int, width: int):
    """Rasterize with a z-buffer, on the device of `verts_cam`.

    verts_cam: (V, 3) float32 camera-space vertices (z > 0 in front); faces:
    (F, 3) integer; attrs: (V, A) float32 per-vertex attributes to
    interpolate; K: (3, 3) intrinsics. Returns (attr_img (H, W, A), mask
    (H, W) bool, depth (H, W))."""
    dev = verts_cam.device
    faces = faces.to(device=dev, dtype=torch.int64)
    F = faces.shape[0]
    K = K.to(device=dev, dtype=torch.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = verts_cam[:, 2]
    xy = torch.stack([verts_cam[:, 0] / z * fx + cx, verts_cam[:, 1] / z * fy + cy], -1)
    inv_zv = 1.0 / z
    HW = height * width
    T = TILE
    d = torch.arange(T, device=dev)
    lim = torch.tensor([width - 1, height - 1], device=dev)

    def tile_origin(f):
        tri = xy[faces[f]]                                       # (..., 3, 2)
        lo = torch.minimum(torch.clamp(torch.floor(tri.amin(dim=-2)).to(torch.int64),
                                       min=0), lim)
        return tri, lo

    def fragments(c0):
        """Fragments of faces [c0, c0 + FACE_CHUNK): (pix (n,), depth (n,),
        valid (n,), global fragment index (n,)), pixel-major within a face."""
        f = torch.arange(c0, min(c0 + FACE_CHUNK, F), device=dev)
        tri, lo = tile_origin(f)
        px = lo[:, 0:1] + d                                      # (C, T)
        py = lo[:, 1:2] + d
        inside, _, _, _, depth = _barycentric(
            tri[:, None, None], inv_zv[faces[f]][:, None, None],
            px.to(torch.float32)[:, None, :] + 0.5, py.to(torch.float32)[:, :, None] + 0.5)
        in_img = (px[:, None, :] < width) & (py[:, :, None] < height)
        valid = (inside & in_img & (depth > 1e-6)).reshape(-1)
        pix = (py[:, :, None] * width + px[:, None, :]).reshape(-1)
        return (torch.where(valid, pix, HW), depth.reshape(-1), valid,
                f[:, None] * (T * T) + torch.arange(T * T, device=dev))

    # pass 1: z-resolve
    zbuf = torch.full((HW + 1,), _BIG, dtype=torch.float32, device=dev)
    for c0 in range(0, F, FACE_CHUNK):
        pix, depth, valid, _ = fragments(c0)
        zbuf.scatter_reduce_(0, pix, torch.where(valid, depth, _BIG), "amin")
    # pass 2: the last winning fragment in face order at every pixel
    winner = torch.full((HW + 1,), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, F, FACE_CHUNK):
        pix, depth, valid, fid = fragments(c0)
        win = valid & (depth <= zbuf[pix] * (1 + 1e-6))
        winner.scatter_reduce_(0, torch.where(win, pix, HW),
                               torch.where(win, fid.reshape(-1), -1), "amax")
    # the winners' attributes, once per covered pixel
    winner = winner[:HW]
    hit = torch.nonzero(winner >= 0)[:, 0]
    fid = winner[hit]
    f = fid // (T * T)
    tri, lo = tile_origin(f)
    pxf = (lo[:, 0] + fid % T).to(torch.float32) + 0.5
    pyf = (lo[:, 1] + fid // T % T).to(torch.float32) + 0.5
    _, wa, wb, wc, depth = _barycentric(tri, inv_zv[faces[f]], pxf, pyf)
    a = attrs.to(device=dev, dtype=torch.float32)[faces[f]]     # (n, 3, A)
    interp = (wa[:, None] * a[:, 0] + wb[:, None] * a[:, 1] + wc[:, None] * a[:, 2]
              ) * depth[:, None]
    out = torch.zeros((HW, attrs.shape[-1]), dtype=torch.float32, device=dev)
    out[hit] = interp
    mask = zbuf[:HW] < _BIG
    depth_img = torch.where(mask, zbuf[:HW], torch.zeros_like(zbuf[:HW]))
    return (out.reshape(height, width, -1), mask.reshape(height, width),
            depth_img.reshape(height, width))
