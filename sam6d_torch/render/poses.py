"""Template viewpoints: icosphere camera/object poses (numpy).

The port's own copy of `sam6d_tpu/render/poses.py`. It regenerates the reference's predefined pose
assets (`Instance_Segmentation_Model/utils/poses/predefined_poses/*.npy`)
from first principles: an icosahedron subdivided L+1 times, vertices sorted
by (elevation, azimuth), cameras looking at the origin at radius 1000 (mm).
Levels 0/1/2 -> 42/162/642 views.
"""
from __future__ import annotations

import numpy as np

# Blender canonical icosahedron (icosphere subdivisions=1): poles at +-z and
# two pentagonal rings at z = -+1/sqrt(5).
_Z = 1.0 / np.sqrt(5.0)
_R = 2.0 / np.sqrt(5.0)


def _base_icosahedron() -> np.ndarray:
    verts = [(0.0, 0.0, -1.0)]
    for i in range(5):  # ring azimuth phases recovered from the assets
        az = np.deg2rad(-162.0 + 72.0 * i)
        verts.append((_R * np.sin(az), _R * np.cos(az), -_Z))
    for i in range(5):
        az = np.deg2rad(-126.0 + 72.0 * i)
        verts.append((_R * np.sin(az), _R * np.cos(az), _Z))
    verts.append((0.0, 0.0, 1.0))
    return np.asarray(verts, np.float64)


def _faces_from_vertices(verts: np.ndarray) -> np.ndarray:
    """Derive the 20 icosahedron faces geometrically: triangles whose three
    pairwise distances all equal the (minimal) edge length."""
    n = len(verts)
    d = np.linalg.norm(verts[:, None] - verts[None, :], axis=-1)
    edge = d[d > 1e-9].min()
    adj = np.abs(d - edge) < 1e-6
    faces = []
    for i in range(n):
        for j in range(i + 1, n):
            if not adj[i, j]:
                continue
            for k in range(j + 1, n):
                if adj[i, k] and adj[j, k]:
                    faces.append((i, j, k))
    return np.asarray(faces, np.int64)


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    """Midpoint subdivision, new vertices pushed to the unit sphere."""
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
            m = m / np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return np.asarray(verts, np.float64), np.asarray(new_faces, np.int64)


def icosphere_vertices(level: int) -> np.ndarray:
    """Unit-sphere camera directions for template level 0/1/2 (42/162/642),
    sorted by (elevation, azimuth) like the reference generator."""
    verts = _base_icosahedron()
    faces = _faces_from_vertices(verts)
    for _ in range(level + 1):
        verts, faces = _subdivide(verts, faces)
    az = np.arctan2(verts[:, 0], verts[:, 1])
    el = np.arctan2(verts[:, 2], np.linalg.norm(verts[:, :2], axis=1))
    order = np.lexsort((az, el))
    return verts[order]


def look_at(cam_location: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam2world 4x4 with columns (right, up, forward, location) — the
    reference convention (create_template_poses.py:75-104): forward toward
    the target, tmp = -z (or -y when parallel)."""
    forward = target - cam_location
    forward = forward / np.linalg.norm(forward)
    tmp = np.array([0.0, 0.0, -1.0])
    if min(np.linalg.norm(cam_location - tmp), np.linalg.norm(cam_location + tmp)) < 1e-3:
        tmp = np.array([0.0, -1.0, 0.0])
    right = np.cross(tmp, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    mat = np.eye(4)
    mat[:3, 0] = right
    mat[:3, 1] = up
    mat[:3, 2] = forward
    mat[:3, 3] = cam_location
    return mat


def template_cam_poses(level: int, radius: float = 1000.0) -> np.ndarray:
    """(N, 4, 4) cam2world poses at `radius` (mm), matching
    cam_poses_level{level}.npy."""
    dirs = icosphere_vertices(level)
    poses = np.stack([look_at(d, np.zeros(3)) for d in dirs])
    poses[:, :3, 3] *= radius
    return poses


def template_obj_poses(level: int, radius: float = 1000.0) -> np.ndarray:
    """(N, 4, 4) world2cam (object) poses, matching obj_poses_level{level}.npy
    (the inverse_transform of the cam poses)."""
    cams = template_cam_poses(level, radius)
    out = np.zeros_like(cams)
    out[:, 3, 3] = 1.0
    R = np.swapaxes(cams[:, :3, :3], 1, 2)
    out[:, :3, :3] = R
    out[:, :3, 3] = -np.einsum("nij,nj->ni", R, cams[:, :3, 3])
    return out


def get_obj_poses_from_template_level(level: int, pose_distribution: str = "all",
                                      return_cam: bool = False) -> np.ndarray:
    """API-compatible with reference pose_utils.get_obj_poses_from_template_level
    (:70-100): the object (or, with `return_cam`, camera) poses of a level,
    all of them or the upper hemisphere's (camera z >= 0)."""
    poses = template_cam_poses(level) if return_cam else template_obj_poses(level)
    if pose_distribution == "all":
        return poses
    if pose_distribution == "upper":
        return poses[template_cam_poses(level)[:, 2, 3] >= 0]
    raise ValueError(pose_distribution)


def match_pose_order(my_poses: np.ndarray, asset_poses: np.ndarray) -> np.ndarray:
    """Permutation `perm` with my_poses[perm[i]] ~ asset_poses[i] (nearest
    camera location). The reference assets were sorted with Blender's float
    noise in the elevation keys, so their order within a ring does not follow
    from exact geometry; templates rendered by the reference scripts are
    reordered with this. Raises unless the match is one-to-one."""
    d = np.linalg.norm(asset_poses[:, None, :3, 3] - my_poses[None, :, :3, 3], axis=-1)
    perm = d.argmin(axis=1)
    if len(set(perm.tolist())) != len(perm):
        raise ValueError("pose sets do not match one-to-one")
    return perm


def nearest_template_indices(level_src: int, level_dst: int = 2) -> np.ndarray:
    """For each view direction of `level_src`, the index of the nearest
    direction of `level_dst` (reference find_neighbors.py,
    idx_*_in_level2.npy)."""
    return np.argmax(icosphere_vertices(level_src) @ icosphere_vertices(level_dst).T, axis=1)
