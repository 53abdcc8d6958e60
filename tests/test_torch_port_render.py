"""The port's template rendering against the JAX package on the CPU:
`rasterize` on a split box and on textured quads at 64x64, `render_templates`
file for file on three views of a box, and the mesh appearance loaders (PLY
vertex colors, PLY UVs with a TextureFile, OBJ + MTL map_Kd).

Tolerances. Masks are exact, except where a shared edge passes exactly
through pixel centres: there the JAX rasterizer's rounding can leave a pixel
outside both triangles, which the port covers (a test pins this). Depths agree to 2e-6 relative and attributes
to 1e-5 (unit-scale coordinates): the two rasterizers round the
barycentric sums differently in the last place. A pixel where two winning
fragments carry different attributes is a tie: the port takes the last
winning fragment in face order, the rule the JAX version's in-order scatter
gives. Tie pixels are found by rendering the faces in reversed order, which
changes only them; they are counted, bounded, and left out of the
attribute comparison."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_tpu.data import mesh as jax_mesh
from sam6d_tpu.render import rasterizer as jax_rast
from sam6d_tpu.render.templates import render_templates as jax_render_templates
from sam6d_torch.data import mesh as port_mesh
from sam6d_torch.data.synthetic import box_ply
from sam6d_torch.render import rasterizer as rast
from sam6d_torch.render.poses import template_cam_poses
from sam6d_torch.render.templates import render_templates

from test_mesh_appearance import _write_texture, _write_textured_ply
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)

S = 64
K = np.array([[S * 50 / 36, 0, S / 2], [0, S * 50 / 36, S / 2], [0, 0, 1]], np.float32)
DEPTH_RTOL = 2e-6
ATTR_ATOL = 1e-5
MAX_TIE_SHARE = 0.02
XYZ_NEAR_ZERO_MM = 1e-4


def _view(verts, faces, i, max_px=6.0):
    """Camera-space vertices and split faces of icosphere view i (parents
    returned for attribute interpolation)."""
    pose = template_cam_poses(0, radius=4 * float(np.linalg.norm(verts, axis=1).max()))[i]
    R, t = pose[:3, :3], pose[:3, 3]

    def proj(v):
        vc = (v - t) @ R
        z = np.maximum(vc[:, 2], 1e-9)
        return np.stack([vc[:, 0] / z * K[0, 0] + K[0, 2], vc[:, 1] / z * K[1, 1] + K[1, 2]], 1)

    sv, sf, parents = rast.split_large_triangles(verts.astype(np.float64), faces, proj,
                                                 max_px=max_px)
    return ((sv - t) @ R).astype(np.float32), sf, sv, parents


def _port(cam, faces, attrs):
    out = rast.rasterize(torch.from_numpy(cam), torch.from_numpy(faces.astype(np.int64)),
                         torch.from_numpy(attrs), torch.from_numpy(K), S, S)
    return [o.numpy() for o in out]


def _compare(cam, faces, attrs, max_tie_share=MAX_TIE_SHARE):
    """JAX vs port on one scene; returns the number of tie pixels."""
    want = [np.asarray(o) for o in jax_rast.rasterize(
        jnp.asarray(cam), jnp.asarray(faces, jnp.int32), jnp.asarray(attrs),
        jnp.asarray(K), S, S)]
    got = _port(cam, faces, attrs)
    rev = _port(cam, faces[::-1].copy(), attrs)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(rev[1], got[1])
    assert got[1].sum() > 100
    np.testing.assert_allclose(got[2], want[2], rtol=DEPTH_RTOL, atol=0)
    tie = np.abs(got[0] - rev[0]).max(-1) > ATTR_ATOL
    assert tie.sum() <= max_tie_share * got[1].sum(), tie.sum()
    np.testing.assert_allclose(got[0][~tie], want[0][~tie], atol=ATTR_ATOL, rtol=0)
    return int(tie.sum())


@pytest.mark.parametrize("view", [0, 13, 30])
def test_rasterize_split_box_matches_jax(view):
    """A unit-scale box seen from three icosphere views, split to 6-pixel
    triangles (hundreds of faces; shared edges make fragments of two faces
    meet at one pixel): random colors and local coordinates."""
    verts = np.array([[sx * 0.4, sy * 0.3, sz * 0.2] for sx in (-1, 1)
                      for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    faces = np.array([f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))], np.int32)
    cam, sf, sv, _ = _view(verts, faces, view)
    assert len(sf) > 100
    attrs = np.concatenate([np.random.RandomState(view).rand(len(sv), 3), sv], 1)
    _compare(cam, sf, attrs.astype(np.float32))


def _quads(quad):
    """Two coplanar copies of a quad, the second with the UVs mirrored:
    attributes (shade, u, v, xyz)."""
    verts = np.concatenate([quad, quad])
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    attrs = np.concatenate([np.full((8, 1), 0.7, np.float32), np.concatenate([uv, 1 - uv]),
                            verts], 1)
    return verts, faces, attrs


def test_rasterize_textured_quads_resolve_ties_like_jax():
    """A textured quad (shade, u, v, xyz) in general position with a
    coplanar copy on top whose UVs are mirrored: every covered pixel has two
    winning fragments, and the later face wins in both packages."""
    quad = np.array([[-0.47, -0.52, 2.0], [0.53, -0.49, 2.1], [0.51, 0.5, 2.05],
                     [-0.5, 0.46, 1.95]], np.float32)
    verts, faces, attrs = _quads(quad)
    want = [np.asarray(o) for o in jax_rast.rasterize(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), jnp.asarray(K), S, S)]
    got = _port(verts, faces, attrs)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_allclose(got[0], want[0], atol=ATTR_ATOL, rtol=0)
    m = got[1]
    first = _port(verts[:4], faces[:2], attrs[:4])[0]
    np.testing.assert_allclose(got[0][m][:, 1:3], 1 - first[m][:, 1:3], atol=ATTR_ATOL)
    assert _compare(verts, faces, attrs, max_tie_share=1.0) > 0.9 * m.sum()


def test_rasterize_shared_edge_through_pixel_centres():
    """A symmetric quad whose diagonal passes exactly through pixel
    centres: the JAX rasterizer's rounding leaves some of those pixels
    outside both triangles, the port covers them. The port's mask is the
    JAX mask plus diagonal pixels only; elsewhere the two agree."""
    quad = np.array([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.5, 0.5, 2.0],
                     [-0.5, 0.5, 2.0]], np.float32)
    verts, faces, attrs = _quads(quad)
    want = [np.asarray(o) for o in jax_rast.rasterize(
        jnp.asarray(verts[:4]), jnp.asarray(faces[:2]), jnp.asarray(attrs[:4]),
        jnp.asarray(K), S, S)]
    got = _port(verts[:4], faces[:2], attrs[:4])
    extra = got[1] & ~want[1]
    assert not (want[1] & ~got[1]).any()
    ys, xs = np.nonzero(extra)
    assert (ys == xs).all() and len(ys) <= S // 4, (ys, xs)
    both = want[1]
    np.testing.assert_allclose(got[0][both], want[0][both], atol=ATTR_ATOL, rtol=0)


def test_render_templates_matches_jax_file_for_file(tmp_path):
    """Three views of the synthetic job's box (mm), flat base color: mask
    PNGs equal, rgb within one level, float16 xyz within one ulp (or
    XYZ_NEAR_ZERO_MM)."""
    cad = str(tmp_path / "box.ply")
    box_ply(cad)
    views = [0, 13, 27]
    jdir = jax_render_templates(jax_mesh.load_ply(cad), str(tmp_path / "jax"),
                                image_size=S, views=views)
    pdir = render_templates(port_mesh.load_ply(cad), str(tmp_path / "port"),
                            image_size=S, views=views, device="cpu")
    for i in views:
        def read(d, name):
            return np.array(Image.open(os.path.join(d, f"{name}_{i}.png"))).astype(np.int32)
        m = read(pdir, "mask")
        np.testing.assert_array_equal(m, read(jdir, "mask"))
        assert (m == 255).sum() > 200
        assert np.abs(read(pdir, "rgb") - read(jdir, "rgb")).max() <= 1
        xp = np.load(os.path.join(pdir, f"xyz_{i}.npy"))
        xj = np.load(os.path.join(jdir, f"xyz_{i}.npy"))
        assert xp.dtype == xj.dtype == np.float16
        # one float16 ulp; near 0, where an ulp is finer than the float32
        # rasterizers' own difference (~3e-5 mm), XYZ_NEAR_ZERO_MM
        ulp = np.spacing(np.maximum(np.abs(xp), np.abs(xj)).astype(np.float16))
        diff = np.abs(xp.astype(np.float32) - xj.astype(np.float32))
        assert (diff <= np.maximum(ulp.astype(np.float32), XYZ_NEAR_ZERO_MM)).all()


def test_render_templates_textured_and_colored_match_jax(tmp_path):
    """The texture path (UVs interpolated, texels sampled per pixel) and the
    vertex-color path, one view each."""
    textured = _write_textured_ply(tmp_path, per_face=False)
    for name, path in (("tex", textured), ("col", _write_colored_ply(tmp_path))):
        jdir = jax_render_templates(jax_mesh.load_ply(path), str(tmp_path / f"j{name}"),
                                    image_size=S, views=[5])
        pdir = render_templates(port_mesh.load_ply(path), str(tmp_path / f"p{name}"),
                                image_size=S, views=[5], device="cpu")
        rgb = [np.array(Image.open(os.path.join(d, "rgb_5.png"))).astype(np.int32)
               for d in (pdir, jdir)]
        assert rgb[0].max() > 0
        assert np.abs(rgb[0] - rgb[1]).max() <= 1, name
        xyz = [np.load(os.path.join(d, "xyz_5.npy")).astype(np.float32) for d in (pdir, jdir)]
        assert np.abs(xyz[0]).max() > 1
        assert np.abs(xyz[0] - xyz[1]).max() <= 0.05, name     # float16 at |x| < 40 mm


def _write_colored_ply(tmp_path):
    path = str(tmp_path / "colored.ply")
    rng = np.random.RandomState(3)
    verts = np.array([[sx * 30.0, sy * 20.0, sz * 10.0] for sx in (-1, 1)
                      for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    cols = rng.randint(0, 256, (8, 3))
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 8\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "property uchar green\nproperty uchar blue\nelement face 6\n"
                "property list uchar int vertex_indices\nend_header\n")
        f.writelines(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n" for v, c in zip(verts, cols))
        f.writelines(f"4 {a} {b} {c} {d}\n" for a, b, c, d in quads)
    return path


def _write_obj(tmp_path):
    _write_texture(str(tmp_path / "obj_tex.png"))
    with open(tmp_path / "m.mtl", "w") as f:
        f.write("newmtl mat\nmap_Kd obj_tex.png\n")
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write("mtllib m.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
                "f 1/1/1 2/2/1 3/3/1 4/4/1\nf 1/4 3/2 4/1\n")
    return path


@pytest.mark.parametrize("kind", ["ply_colors", "ply_uv_texture", "ply_face_texcoord", "obj_mtl"])
def test_mesh_appearance_loading_matches_jax(tmp_path, kind):
    path = {"ply_colors": lambda: _write_colored_ply(tmp_path),
            "ply_uv_texture": lambda: _write_textured_ply(tmp_path, per_face=False),
            "ply_face_texcoord": lambda: _write_textured_ply(tmp_path, per_face=True),
            "obj_mtl": lambda: _write_obj(tmp_path)}[kind]()
    got, want = port_mesh.load_mesh(path), jax_mesh.load_mesh(path)
    for field in ("vertices", "faces", "colors", "uv", "texture"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=field)
    has = {"ply_colors": "colors", "ply_uv_texture": "texture",
           "ply_face_texcoord": "texture", "obj_mtl": "texture"}[kind]
    assert getattr(got, has) is not None
    np.testing.assert_array_equal(got.sample(50, np.random.RandomState(0)),
                                  want.sample(50, np.random.RandomState(0)))
