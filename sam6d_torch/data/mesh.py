"""PLY geometry reader and uniform surface sampling (numpy).

The port's own copy of the geometry half of `sam6d_tpu/data/mesh.py`: the
reference samples CAD clouds with `trimesh.load_mesh(path).sample(n)`
(`Pose_Estimation_Model/run_inference_custom.py:183-184`,
`Instance_Segmentation_Model/model/detector.py:183-184`). Colours, UVs and
textures are for rendering, which the port does not do yet, so they are
skipped. Faces keep the JAX reader's order and fan triangulation, so
`Mesh.sample` draws the same points from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_FACE_INDEX_NAMES = ("vertex_indices", "vertex_index")


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32

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


def _fan(idx, out):
    for j in range(1, len(idx) - 1):
        out.append((idx[0], idx[j], idx[j + 1]))


def load_ply(path: str) -> Mesh:
    """Load an ascii or binary PLY's vertices (x, y, z) and faces
    (polygons fan-triangulated)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]
    fmt = None
    elements = []  # (name, count, [(name, type) | ('list', count_t, item_t, name)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    if fmt == "ascii":
        verts, faces = _parse_ascii(body, elements)
    elif fmt in ("binary_little_endian", "binary_big_endian"):
        verts, faces = _parse_binary(body, elements,
                                     "<" if fmt == "binary_little_endian" else ">")
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return Mesh(verts, faces)


def _xyz(fields) -> np.ndarray:
    return np.stack([fields["x"], fields["y"], fields["z"]], axis=1).astype(np.float32)


def _parse_ascii(body: bytes, elements):
    lines = body.decode("ascii", errors="replace").split("\n")
    li = 0
    fields, faces = {}, []
    for name, count, props in elements:
        if name == "vertex":
            names = [p[0] if p[0] != "list" else p[3] for p in props]
            raw = np.array([[float(v) for v in lines[li + i].split()[:len(names)]]
                            for i in range(count)], np.float64).reshape(count, len(names))
            fields = {n: raw[:, j] for j, n in enumerate(names)}
        elif name == "face":
            for i in range(count):
                vals = lines[li + i].split()
                pos = 0
                for p in props:
                    if p[0] != "list":
                        pos += 1
                        continue
                    k = int(float(vals[pos]))
                    items = vals[pos + 1:pos + 1 + k]
                    pos += 1 + k
                    if p[3] in _FACE_INDEX_NAMES:
                        _fan([int(float(v)) for v in items], faces)
        li += count
    return _xyz(fields), np.asarray(faces, np.int32).reshape(-1, 3)


def _parse_binary(body: bytes, elements, endian: str):
    off = 0
    fields, faces = {}, []
    for name, count, props in elements:
        if all(p[0] != "list" for p in props):
            dtype = np.dtype([(p[0], endian + _PLY_DTYPES[p[1]]) for p in props])
            if name == "vertex":
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
                fields = {p[0]: arr[p[0]].astype(np.float64) for p in props}
            off += dtype.itemsize * count
            continue
        for _ in range(count):
            for p in props:
                if p[0] != "list":
                    off += np.dtype(_PLY_DTYPES[p[1]]).itemsize
                    continue
                cnt_t = np.dtype(endian + _PLY_DTYPES[p[1]])
                item_t = np.dtype(endian + _PLY_DTYPES[p[2]])
                k = int(np.frombuffer(body, cnt_t, 1, off)[0])
                off += cnt_t.itemsize
                items = np.frombuffer(body, item_t, k, off)
                off += item_t.itemsize * k
                if name == "face" and p[3] in _FACE_INDEX_NAMES:
                    _fan(items.astype(np.int64).tolist(), faces)
    return _xyz(fields), np.asarray(faces, np.int32).reshape(-1, 3)
