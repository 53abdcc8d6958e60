"""Mesh IO (PLY / OBJ+MTL) + uniform surface sampling (numpy; replaces
trimesh).

The port's own copy of `sam6d_tpu/data/mesh.py`. The reference calls
`trimesh.load_mesh(path).sample(n)` for CAD point clouds
(`Pose_Estimation_Model/run_inference_custom.py:183-184`,
`Instance_Segmentation_Model/model/detector.py:183-184`) and renders CAD
appearance through BlenderProc, which keeps the model's own materials —
vertex colors and texture maps (`Render/render_bop_templates.py:33-47` only
overrides tless to gray). This module therefore loads, alongside geometry:

- per-vertex colors (PLY `red/green/blue`, uchar or float),
- texture coordinates (PLY per-vertex `texture_u/texture_v` or `s/t`, or
  per-face `texcoord` lists as in the BOP textured models; OBJ `vt`),
- the companion texture image (PLY `comment TextureFile x.png`; OBJ
  MTL `map_Kd`), decoded to float32 RGB in [0, 1].

Faces with per-corner UVs are unwelded so every vertex carries one UV.
Faces keep the JAX reader's order and fan triangulation, so `Mesh.sample`
draws the same points from the same seed. Sampling is area-weighted with
uniform barycentric coordinates — the same scheme trimesh uses.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32
    colors: Optional[np.ndarray] = None   # (V, 3) float32 in [0, 1]
    uv: Optional[np.ndarray] = None       # (V, 2) float32 texture coords
    texture: Optional[np.ndarray] = None  # (Th, Tw, 3) float32 in [0, 1]

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        a = v[self.faces[:, 1]] - v[self.faces[:, 0]]
        b = v[self.faces[:, 2]] - v[self.faces[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(a, b), axis=1)

    def sample(self, n: int, rng: np.random.RandomState | None = None) -> np.ndarray:
        """Area-weighted uniform surface sampling -> (n, 3) float32."""
        rng = rng or np.random.RandomState(0)
        areas = self.face_areas
        p = areas / areas.sum()
        fidx = rng.choice(len(p), size=n, p=p)
        tri = self.vertices[self.faces[fidx]]  # (n, 3, 3)
        # uniform barycentric: fold the unit square onto the triangle
        r1 = rng.rand(n, 1)
        r2 = rng.rand(n, 1)
        flip = (r1 + r2) > 1.0
        r1 = np.where(flip, 1.0 - r1, r1)
        r2 = np.where(flip, 1.0 - r2, r2)
        pts = tri[:, 0] + r1 * (tri[:, 1] - tri[:, 0]) + r2 * (tri[:, 2] - tri[:, 0])
        return pts.astype(np.float32)


def load_mesh(path: str) -> Mesh:
    """Load a mesh by extension (.ply or .obj)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path)
    if ext == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format {ext!r} ({path})")


def _load_texture_image(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _find_texture(mesh_path: str, declared: Optional[str]) -> Optional[np.ndarray]:
    """Resolve the companion texture image next to the mesh file."""
    d = os.path.dirname(os.path.abspath(mesh_path))
    candidates = []
    if declared:
        candidates.append(os.path.join(d, declared))
    stem = os.path.splitext(os.path.basename(mesh_path))[0]
    for ext in (".png", ".jpg", ".jpeg"):
        candidates.append(os.path.join(d, stem + ext))
    for c in candidates:
        tex = _load_texture_image(c)
        if tex is not None:
            return tex
    return None


def load_ply(path: str) -> Mesh:
    """Load ascii or binary PLY: xyz, faces, and appearance (colors / UVs /
    texture map). Per-face `texcoord` lists (BOP textured models) unweld the
    vertices so each carries a single UV."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    texture_file = None
    elements = []  # list of (name, count, [(prop_name, dtype) | ('list', idx_t, cnt_t, name)])
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "comment" and len(parts) >= 3 and parts[1] == "TextureFile":
            texture_file = parts[2]
        elif parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur[2].append((parts[2], parts[1]))  # (name, type)

    if fmt == "ascii":
        mesh = _parse_ascii(body, elements)
    elif fmt == "binary_little_endian":
        mesh = _parse_binary(body, elements, "<")
    elif fmt == "binary_big_endian":
        mesh = _parse_binary(body, elements, ">")
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    if mesh.uv is not None:
        mesh.texture = _find_texture(path, texture_file)
        if mesh.texture is None:
            mesh.uv = None  # UVs without an image are unusable
    return mesh


def _colors_from_fields(fields: dict[str, np.ndarray],
                        types: dict[str, str]) -> Optional[np.ndarray]:
    if not all(k in fields for k in ("red", "green", "blue")):
        return None
    cols = np.stack([fields["red"], fields["green"], fields["blue"]],
                    axis=1).astype(np.float32)
    if types.get("red") in ("uchar", "uint8", "char", "int8"):
        cols = cols / 255.0
    return np.clip(cols, 0.0, 1.0)


def _uv_from_fields(fields: dict[str, np.ndarray]) -> Optional[np.ndarray]:
    for u_name, v_name in (("texture_u", "texture_v"), ("s", "t"), ("u", "v")):
        if u_name in fields and v_name in fields:
            return np.stack([fields[u_name], fields[v_name]],
                            axis=1).astype(np.float32)
    return None


def _assemble(fields: dict[str, np.ndarray], types: dict[str, str],
              faces: np.ndarray,
              face_uv: Optional[np.ndarray]) -> Mesh:
    vertices = np.stack([fields["x"], fields["y"], fields["z"]],
                        axis=1).astype(np.float32)
    colors = _colors_from_fields(fields, types)
    uv = _uv_from_fields(fields)
    if face_uv is not None and uv is None:
        # per-corner UVs: unweld so every (vertex, uv) pair is one vertex
        flat = faces.reshape(-1)
        corner_uv = face_uv.reshape(-1, 2)
        key = np.concatenate(
            [flat[:, None].astype(np.float64),
             np.round(corner_uv, 8).astype(np.float64)], axis=1)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        vertices = vertices[flat[first]]
        colors = colors[flat[first]] if colors is not None else None
        uv = corner_uv[first]
        faces = inv.reshape(-1, 3).astype(np.int32)
    return Mesh(vertices, faces, colors=colors, uv=uv)


def _parse_ascii(body: bytes, elements) -> Mesh:
    lines = body.decode("ascii", errors="replace").split("\n")
    li = 0
    fields: dict[str, np.ndarray] = {}
    types: dict[str, str] = {}
    faces = None
    face_uv = None
    for name, count, props in elements:
        if name == "vertex":
            names = [p[0] if p[0] != "list" else p[3] for p in props]
            raw = np.empty((count, len(names)), np.float64)
            for i in range(count):
                vals = lines[li + i].split()
                raw[i] = [float(v) for v in vals[:len(names)]]
            for j, n in enumerate(names):
                fields[n] = raw[:, j]
                types[n] = props[j][1] if props[j][0] != "list" else "float"
            li += count
        elif name == "face":
            out, out_uv = [], []
            has_texcoord = any(p[0] == "list" and p[3] == "texcoord"
                               for p in props)
            for i in range(count):
                vals = lines[li + i].split()
                pos = 0
                idx, tuv = None, None
                for p in props:
                    if p[0] == "list":
                        k = int(float(vals[pos])); pos += 1
                        items = [float(v) for v in vals[pos:pos + k]]
                        pos += k
                        if p[3] in ("vertex_indices", "vertex_index"):
                            idx = [int(v) for v in items]
                        elif p[3] == "texcoord":
                            tuv = np.asarray(items, np.float32).reshape(-1, 2)
                    else:
                        pos += 1
                for j in range(1, len(idx) - 1):  # fan triangulation
                    out.append((idx[0], idx[j], idx[j + 1]))
                    if tuv is not None:
                        out_uv.append(np.stack([tuv[0], tuv[j], tuv[j + 1]]))
            faces = np.asarray(out, np.int32)
            if has_texcoord and out_uv:
                face_uv = np.stack(out_uv)  # (F, 3, 2)
            li += count
        else:
            li += count
    return _assemble(fields, types,
                     faces if faces is not None else np.zeros((0, 3), np.int32),
                     face_uv)


def _parse_binary(body: bytes, elements, endian: str) -> Mesh:
    off = 0
    fields: dict[str, np.ndarray] = {}
    types: dict[str, str] = {}
    faces = None
    face_uv = None
    for name, count, props in elements:
        if name == "vertex" and all(p[0] != "list" for p in props):
            dtype = np.dtype([(p[0], endian + _PLY_DTYPES[p[1]]) for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
            off += dtype.itemsize * count
            for p in props:
                fields[p[0]] = arr[p[0]].astype(np.float64)
                types[p[0]] = p[1]
        elif name == "face":
            out, out_uv = [], []
            has_texcoord = any(p[0] == "list" and p[3] == "texcoord"
                               for p in props)
            for _ in range(count):
                idx, tuv = None, None
                for p in props:
                    if p[0] == "list":
                        cnt_t = np.dtype(endian + _PLY_DTYPES[p[1]])
                        item_t = np.dtype(endian + _PLY_DTYPES[p[2]])
                        k = int(np.frombuffer(body, cnt_t, 1, off)[0])
                        off += cnt_t.itemsize
                        items = np.frombuffer(body, item_t, k, off)
                        off += item_t.itemsize * k
                        if p[3] in ("vertex_indices", "vertex_index"):
                            idx = items.astype(np.int64)
                        elif p[3] == "texcoord":
                            tuv = items.astype(np.float32).reshape(-1, 2)
                    else:
                        off += np.dtype(_PLY_DTYPES[p[1]]).itemsize
                for j in range(1, len(idx) - 1):
                    out.append((idx[0], idx[j], idx[j + 1]))
                    if tuv is not None:
                        out_uv.append(np.stack([tuv[0], tuv[j], tuv[j + 1]]))
            faces = np.asarray(out, np.int32)
            if has_texcoord and out_uv:
                face_uv = np.stack(out_uv)
        else:
            # skip fixed-size element
            size = sum(np.dtype(_PLY_DTYPES[p[1]]).itemsize for p in props
                       if p[0] != "list")
            off += size * count
    return _assemble(fields, types,
                     faces if faces is not None else np.zeros((0, 3), np.int32),
                     face_uv)


def load_obj(path: str) -> Mesh:
    """Load a Wavefront OBJ with optional MTL diffuse texture (map_Kd).

    Handles `v`, `vt`, and `f` with `v`, `v/vt`, `v/vt/vn`, `v//vn` corner
    encodings; polygons fan-triangulate. Vertices are unwelded per (v, vt)
    pair so UVs live on vertices."""
    verts, uvs, corners, faces = [], [], {}, []
    mtl_file = None
    tex = None
    d = os.path.dirname(os.path.abspath(path))

    def corner_id(vi: int, ti: int) -> int:
        key = (vi, ti)
        if key not in corners:
            corners[key] = len(corners)
        return corners[key]

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "mtllib":
                mtl_file = line.split(None, 1)[1].strip()
            elif parts[0] == "f":
                ids = []
                for c in parts[1:]:
                    sub = c.split("/")
                    vi = int(sub[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ti = -1
                    if len(sub) > 1 and sub[1]:
                        ti = int(sub[1])
                        ti = ti - 1 if ti > 0 else len(uvs) + ti
                    ids.append(corner_id(vi, ti))
                for j in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[j], ids[j + 1]))

    if mtl_file:
        mtl_path = os.path.join(d, mtl_file)
        if os.path.exists(mtl_path):
            with open(mtl_path, "r", errors="replace") as f:
                for line in f:
                    parts = line.split()
                    if parts and parts[0] == "map_Kd":
                        tex = _load_texture_image(
                            os.path.join(d, line.split(None, 1)[1].strip()))
                        break

    verts = np.asarray(verts, np.float32)
    uvs = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)
    order = sorted(corners, key=corners.get)
    vertices = verts[[vi for vi, _ in order]]
    has_uv = uvs.shape[0] > 0 and any(ti >= 0 for _, ti in order)
    uv = (np.stack([uvs[ti] if ti >= 0 else np.zeros(2, np.float32)
                    for _, ti in order])
          if has_uv else None)
    return Mesh(vertices, np.asarray(faces, np.int32),
                uv=uv, texture=tex if has_uv else None)
