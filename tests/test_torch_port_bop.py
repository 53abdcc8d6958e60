"""The BOP half of the port against the JAX package on the CPU: the readers
(scene discovery, frames, objects, sampled points, templates, the PEM
instance assembly), the PBR template miner, `render_bop_templates` file for
file, and both BOP onboardings of the ISM with their npz cache, on a mini
BOP tree: tests/test_data_providers.make_mini_bop (a 20 mm tetrahedron, two
48x64 frames) plus a vertex-coloured box as lmo's object 5, a models_cad
copy (tless), a train_pbr scene of random crops and templates rendered by
the port at 64^2. Also the smoke's `write_bop_job` tree at a reduced size.

Tolerances: reader outputs, mined records, crops and the PEM instance
arrays exact; renders as PERF.md's render_templates row: masks exact, rgb 1
level, float16 xyz 1 ulp or 1e-4 mm near 0, except at pixel centres a
projected edge passes through (the port may cover one JAX leaves out, or
let the other face win a tie), at most S/4 such pixels over the 42 views; DINOv2 descriptors atol =
rtol = 1e-4 (float32 sums in another order), poses exact."""
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from sam6d_tpu.data import bop as jax_bop
from sam6d_tpu.data import bop_pbr as jax_pbr
from sam6d_tpu.ops.pointcloud import depth_to_pointcloud as jax_backproject
from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.render.templates import render_bop_templates as jax_render_bop
from sam6d_torch.data import bop as port_bop
from sam6d_torch.data import bop_pbr as port_pbr
from sam6d_torch.data import mesh as port_mesh
from sam6d_torch.data.rle import rle_encode_coco
from sam6d_torch.data.synthetic import random_rotation, write_bop_job
from sam6d_torch.pipelines import ism as port_ism
from sam6d_torch.pipelines.pem import _host_backproject
from sam6d_torch.render.poses import template_cam_poses
from sam6d_torch.render.rasterizer import split_large_triangles
from sam6d_torch.render.templates import _intrinsics, render_bop_templates

from test_data_providers import make_mini_bop
from test_torch_port_ism_slice import _frame
from test_torch_port_render import S, XYZ_NEAR_ZERO_MM, _write_colored_ply
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, tiny_dinov2_weights, tiny_ism_cfgs

H, W = 48, 64
OBJ_IDS = (1, 5)          # lmo's first two object ids
K_MINI = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)


def write_mini_pbr(root, rng, n_images=12):
    """train_pbr/000000: random 48x64 jpg frames, each with two instances of
    each object (random rotations, rectangle visible masks, visible
    fractions drawn from [0.5, 1), so the 0.8 filter drops some)."""
    sd = root / "train_pbr" / "000000"
    (sd / "rgb").mkdir(parents=True)
    (sd / "mask_visib").mkdir()
    gt, info = {}, {}
    for k in range(n_images):
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            sd / "rgb" / f"{k:06d}.jpg")
        gt[str(k)], info[str(k)] = [], []
        for i in range(4):
            m = np.zeros((H, W), np.uint8)
            y0, x0 = rng.randint(0, H - 12), rng.randint(0, W - 12)
            m[y0:y0 + rng.randint(4, 12), x0:x0 + rng.randint(4, 12)] = 255
            Image.fromarray(m).save(sd / "mask_visib" / f"{k:06d}_{i:06d}.png")
            gt[str(k)].append(dict(obj_id=OBJ_IDS[i % 2],
                                   cam_R_m2c=random_rotation(rng).reshape(-1).tolist(),
                                   cam_t_m2c=[0.0, 0.0, 600.0]))
            info[str(k)].append(dict(visib_fract=float(rng.uniform(0.5, 1.0))))
    with open(sd / "scene_gt.json", "w") as f:
        json.dump(gt, f)
    with open(sd / "scene_gt_info.json", "w") as f:
        json.dump(info, f)


def make_mini_tree(root):
    """The mini BOP tree of this module (see the docstring); templates under
    root/templates/lmo/obj_{id:06d}."""
    np.random.seed(0)                 # make_mini_bop draws from the global RNG
    make_mini_bop(root, n_frames=2)
    models = root / "models"
    shutil.copy(_write_colored_ply(root), models / "obj_000005.ply")
    with open(models / "models_info.json", "w") as f:
        json.dump({"1": {"diameter": 34.6},
                   "5": {"diameter": float(2 * np.linalg.norm([30.0, 20.0, 10.0])),
                         "symmetries_discrete": [np.eye(4).reshape(-1).tolist()]}}, f)
    shutil.copytree(models, root / "models_cad")
    write_mini_pbr(root, np.random.RandomState(1))
    render_bop_templates(str(root), str(root / "templates"), "lmo", image_size=S,
                         device="cpu")
    return root


def mini_detections(rng, n_per_frame=7, score_lo=0.3):
    """BOP-23 records on the mini tree's two frames: rectangles of each
    object id, scores from `score_lo` up, plus per frame one below the 0.25
    seg filter, one of an unknown object and one too small to keep."""
    dets = []
    for im in (0, 1):
        for j in range(n_per_frame + 3):
            m = np.zeros((H, W), np.uint8)
            y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
            m[y0:y0 + rng.randint(12, H // 2), x0:x0 + rng.randint(12, W // 2)] = 1
            cat, score = OBJ_IDS[j % 2], score_lo + 0.05 * j
            if j == n_per_frame:
                score = 0.2
            elif j == n_per_frame + 1:
                cat = 3
            elif j == n_per_frame + 2:
                m[:] = 0
                m[5, 5:10] = 1
            dets.append(dict(scene_id=0, image_id=im, category_id=cat, score=score,
                             bbox=[0, 0, 1, 1], time=0.01,
                             segmentation=rle_encode_coco(m)))
    return dets


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_mini_tree(tmp_path_factory.mktemp("bop"))


def _objects(tree):
    args = (str(tree / "models"), str(tree / "templates"), "lmo")
    return jax_bop.load_bop_objects(*args), port_bop.load_bop_objects(*args)


# ------------------------------------------------------------------ readers

def test_scene_readers_match_jax(tree):
    want, got = jax_bop.discover_test_scenes(str(tree)), port_bop.discover_test_scenes(str(tree))
    assert [s.scene_id for s in got] == [s.scene_id for s in want] == [0]
    assert got[0].frame_ids() == want[0].frame_ids() == [0, 1]
    for im in (0, 1):
        assert (port_bop.frame_paths(got[0].scene_dir, im)
                == jax_bop.frame_paths(want[0].scene_dir, im))
        g, w = got[0].load_frame(im), want[0].load_frame(im)
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["depth"].dtype == np.float32 and g["K"].dtype == np.float32


def test_objects_points_and_templates_match_jax(tree):
    want, got = _objects(tree)
    assert [o.obj_id for o in got] == [o.obj_id for o in want] == list(OBJ_IDS)
    for g, w in zip(got, want):
        assert (g.diameter, g.symmetric, g.template_dir) == (w.diameter, w.symmetric,
                                                              w.template_dir)
        for field in ("vertices", "faces", "colors"):
            a, b = getattr(g.mesh, field), getattr(w.mesh, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        for n in (64, 2048, 64):
            np.testing.assert_array_equal(g.sample_points(n), w.sample_points(n))
        assert np.abs(g.sample_points(64)).max() < 0.05         # metres
        for v in (0, 17, 41):
            for a, b in zip(g.load_template(v), w.load_template(v)):
                np.testing.assert_array_equal(a, b)
        assert got[1].mesh.colors is not None and got[1].symmetric and not got[0].symmetric


def test_pem_loader_matches_jax(tree):
    """group_detections, assemble_instances (every array, on the frame's
    cloud from both backprojections, which agree exactly) and
    template_views."""
    want_objs, got_objs = _objects(tree)
    kw = dict(img_size=32, n_sample_observed=64, n_sample_template=50, n_template_view=4)
    jl, pl = jax_bop.PEMTestFrameLoader(want_objs, **kw), port_bop.PEMTestFrameLoader(got_objs, **kw)
    dets = mini_detections(np.random.RandomState(2))
    want, got = jl.group_detections(dets), pl.group_detections(dets)
    assert list(got) == list(want) == [(0, 0), (0, 1)]
    assert got == want and len(got[(0, 0)]) == 9          # the 0.2 one dropped
    scene = port_bop.discover_test_scenes(str(tree))[0]
    n_kept = 0
    for key in got:
        frame = scene.load_frame(key[1])
        cloud = _host_backproject(frame["depth"], frame["depth_scale"], frame["K"])
        np.testing.assert_array_equal(cloud, np.asarray(jax_backproject(
            frame["depth"] * frame["depth_scale"] / 1000.0, frame["K"])))
        gi, gk = pl.assemble_instances(frame, got[key], cloud)
        wi, wk = jl.assemble_instances(frame, want[key], cloud)
        assert gk == wk and len(gi) == len(wi) == 7        # unknown and tiny dropped
        for a, b in zip(gi, wi):
            assert set(a) == set(b) and a["obj_idx"] == b["obj_idx"]
            for k in ("rgb", "pts", "rgb_choose"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n_kept += len(gk)
    assert n_kept == 14
    for g, w in zip(got_objs, want_objs):
        tg, tw = pl.template_views(g), jl.template_views(w)
        assert set(tg) == set(tw) == {"rgb", "choose", "pts"}
        for k in tg:
            np.testing.assert_array_equal(tg[k], tw[k], err_msg=k)
        assert tg["pts"].shape == (4, 50, 3)


@pytest.mark.parametrize("max_candidates", [5000, 10])
def test_pbr_miner_matches_jax(tree, max_candidates):
    """mine() (the visib_fract filter, the seeded draw without replacement
    above max_candidates, the nearest viewing direction per level-0 view)
    and load_template_crop, exactly."""
    want = jax_pbr.PBRTemplateMiner(str(tree), max_candidates=max_candidates).mine([1, 5])
    miner = port_pbr.PBRTemplateMiner(str(tree), max_candidates=max_candidates)
    got = miner.mine([1, 5])
    assert sorted(got) == sorted(want) == [1, 5]
    for oid in got:
        assert len(got[oid]) == len(want[oid]) == 42
        for g, w in zip(got[oid], want[oid]):
            assert (g["scene_dir"], g["im_id"], g["inst_idx"]) == (w["scene_dir"], w["im_id"],
                                                                   w["inst_idx"])
            np.testing.assert_array_equal(g["R"], w["R"])
        for rec in got[oid][::10]:
            for a, b in zip(miner.load_template_crop(rec),
                            jax_pbr.PBRTemplateMiner(str(tree)).load_template_crop(rec)):
                np.testing.assert_array_equal(a, b)
    assert port_pbr.PBRTemplateMiner(str(tree)).mine([5]).keys() == {5}
    rng = np.random.RandomState(3)
    Ra = np.stack([random_rotation(rng) for _ in range(5)])
    Rb = np.stack([random_rotation(rng) for _ in range(7)])
    for name in ("viewing_direction_distance", "rotation_geodesic"):
        np.testing.assert_array_equal(getattr(port_pbr, name)(Ra, Rb),
                                      getattr(jax_pbr, name)(Ra, Rb))


# ------------------------------------------------------------------- render

def _on_edge(mesh, cam_distance, view, xs, ys, tol=1e-3):
    """Whether each pixel centre (xs + 0.5, ys + 0.5) lies within `tol` px of
    the projection of an edge of the split mesh, in the template view
    `view` at S^2 (render_view's camera and split). There the JAX
    rasterizer's rounding may leave the pixel outside the faces that meet
    on the edge, which the port covers (test_torch_port_render.py pins
    it), or the two may let different faces win the pixel (a tie). The
    split meets a neighbour face's edge at T-junctions, so edges are taken
    one by one, not as pairs of shared vertex indices."""
    pose = template_cam_poses(0, radius=cam_distance)[view]
    t, Rwc = pose[:3, 3], pose[:3, :3].T
    K = _intrinsics(S)

    def proj(v):
        vc = (v - t) @ Rwc.T
        z = np.maximum(vc[:, 2], 1e-9)
        return np.stack([vc[:, 0] / z * K[0, 0] + K[0, 2], vc[:, 1] / z * K[1, 1] + K[1, 2]], 1)

    sv, sf, _ = split_large_triangles(mesh.vertices.astype(np.float64), mesh.faces, proj)
    e = np.unique(np.sort(np.concatenate([sf[:, [0, 1]], sf[:, [1, 2]], sf[:, [2, 0]]]),
                          axis=1), axis=0)
    uv = proj(sv)
    a, b = uv[e[:, 0]], uv[e[:, 1]]
    p = np.stack([xs + 0.5, ys + 0.5], 1)[:, None, :]
    ab = b - a
    s = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-12), 0, 1)
    d = np.linalg.norm(p - (a + s[..., None] * ab), axis=-1)
    return d.min(axis=1) < tol


@pytest.mark.parametrize("dataset,obj_id", [("lmo", 5), ("tless", 1)])
def test_render_bop_templates_matches_jax_file_for_file(tree, tmp_path, dataset, obj_id):
    """lmo's vertex-coloured box from `models`, tless's tetrahedron from
    `models_cad` in the gray 0.4 material, 42 views at 64^2, written
    straight into {root}/{dataset}/obj_{id:06d}/: masks exact, rgb within
    one level, float16 xyz within one ulp (or XYZ_NEAR_ZERO_MM)."""
    jd = jax_render_bop(str(tree), str(tmp_path / "jax"), dataset, obj_ids=[obj_id],
                        image_size=S)
    pd = render_bop_templates(str(tree), str(tmp_path / "port"), dataset, obj_ids=[obj_id],
                              image_size=S, device="cpu")
    assert [os.path.relpath(d, tmp_path / "port") for d in pd] == \
        [os.path.relpath(d, tmp_path / "jax") for d in jd] == [f"{dataset}/obj_{obj_id:06d}"]
    assert sorted(os.listdir(pd[0])) == sorted(os.listdir(jd[0]))
    assert len(os.listdir(pd[0])) == 3 * 42
    with open(tree / ("models_cad" if dataset == "tless" else "models") / "models_info.json") as f:
        dist = 2.0 * json.load(f)[str(obj_id)]["diameter"]
    mesh = port_mesh.load_ply(str(tree / ("models_cad" if dataset == "tless" else "models")
                                  / f"obj_{obj_id:06d}.ply"))
    n_edge = 0
    for i in range(42):
        def read(d, name):
            return np.array(Image.open(os.path.join(d, f"{name}_{i}.png"))).astype(np.int32)
        m, mj = read(pd[0], "mask") == 255, read(jd[0], "mask") == 255
        assert not (mj & ~m).any() and m.sum() > 20, i
        rgb = read(pd[0], "rgb")
        if dataset == "tless":       # gray material: equal channels
            assert (rgb[..., 0] == rgb[..., 1]).all() and (rgb[..., 1] == rgb[..., 2]).all()
        xp = np.load(os.path.join(pd[0], f"xyz_{i}.npy"))
        xj = np.load(os.path.join(jd[0], f"xyz_{i}.npy"))
        assert xp.dtype == xj.dtype == np.float16
        ulp = np.spacing(np.maximum(np.abs(xp), np.abs(xj)).astype(np.float16))
        diff = np.abs(xp.astype(np.float32) - xj.astype(np.float32))
        off = ((m != mj) | (np.abs(rgb - read(jd[0], "rgb")).max(-1) > 1)
               | (diff > np.maximum(ulp.astype(np.float32), XYZ_NEAR_ZERO_MM)).any(-1))
        if off.any():
            ys, xs = np.nonzero(off)
            assert _on_edge(mesh, dist, i, xs, ys).all(), (i, ys, xs)
            n_edge += len(ys)
    assert n_edge <= S // 4
    if dataset == "lmo":
        rgb = np.array(Image.open(os.path.join(pd[0], "rgb_0.png")))
        assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 10     # vertex colours kept


# --------------------------------------------------------------- onboarding

@pytest.fixture(scope="module")
def ism_pipes():
    jcfg, pcfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(4))
    return (JaxISMPipeline(jcfg, dinov2_variables=variables),
            lambda: port_ism.ISMPipeline(pcfg, state_dict=sd, device="cpu"))


def _close_ref(got, want):
    assert got["descriptors"].shape == (2, 42, 32)
    close(got["descriptors"], want["descriptors"])
    close(got["appe_descriptors"], want["appe_descriptors"])
    np.testing.assert_array_equal(got["poses_R"].numpy(), np.asarray(want["poses_R"]))


def test_onboard_bop_objects_and_cache_match_jax(tree, tmp_path, ism_pipes, monkeypatch):
    """Rendered-template onboarding of both objects (ImageNet normalization
    after the crop) against JAX's; the cache: a second call reads it back
    (no describe), reset_descriptors recomputes it, and a cache written by
    JAX loads into the port and scores a frame as JAX does."""
    jax_pipe, make_port = ism_pipes
    want_objs, got_objs = _objects(tree)
    jcache, pcache = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want = jax_pipe.onboard_bop_objects(want_objs, cache_path=jcache)
    port = make_port()
    got = port.onboard_bop_objects(got_objs, cache_path=pcache)
    _close_ref(got, want)
    # the custom path (onboard_templates_from_dir: the same views, crops not
    # normalized) describes differently
    plain = make_port().onboard_templates_from_dir(got_objs[0].template_dir)
    assert (plain["descriptors"][0] - got["descriptors"][0]).abs().max() > 1e-3

    with np.load(pcache) as cached, np.load(jcache) as jcached:
        assert sorted(cached.files) == sorted(jcached.files) == [
            "appe_descriptors", "descriptors", "poses_R"]
    calls = []
    orig = port_ism.ISMPipeline._describe_template_stack

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(port_ism.ISMPipeline, "_describe_template_stack", spy)
    again = make_port().onboard_bop_objects(got_objs, cache_path=pcache)
    assert not calls
    for k in got:
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy())
    reset = make_port().onboard_bop_objects(got_objs, cache_path=pcache,
                                            reset_descriptors=True)
    assert len(calls) == 2
    for k in got:
        np.testing.assert_array_equal(reset[k].numpy(), got[k].numpy())

    from_jax = make_port()
    loaded = from_jax.onboard_bop_objects(got_objs, cache_path=jcache)
    assert len(calls) == 2
    for k in loaded:
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(want[k]))
    rgb, depth, dets = _frame(np.random.RandomState(5))
    clouds = np.stack([o.sample_points(64) for o in got_objs])
    kw = dict(detections=dets, apply_nms_per_object=True)
    g = from_jax.match_frame(rgb, depth, K_MINI, 1.0, clouds, **kw)
    w = jax_pipe.match_frame(rgb, depth, K_MINI, 1.0, clouds, **kw)
    for k in ("valid", "object_ids", "best_template"):
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    assert g["valid"].sum() >= 2
    for k in ("semantic_score", "appe_score", "visible_ratio"):
        close(g[k], w[k])


def test_onboard_bop_objects_pbr_matches_jax(tree, tmp_path, ism_pipes):
    """PBR onboarding (mined train_pbr crops, masked, tight box, normalized
    crops) against JAX's, and its cache read back."""
    jax_pipe, make_port = ism_pipes
    want = jax_pipe.onboard_bop_objects_pbr(str(tree), [1, 5])
    cache = str(tmp_path / "pbr.npz")
    got = make_port().onboard_bop_objects_pbr(str(tree), [1, 5], cache_path=cache)
    _close_ref(got, want)
    again = make_port().onboard_bop_objects_pbr(str(tmp_path / "no_tree"), [1, 5],
                                                cache_path=cache)
    for k in got:
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy())


# --------------------------------------------------------- the smoke's tree

def test_write_bop_job_tree_reads_back(tmp_path):
    """write_bop_job at 120x160 with 8 train_pbr frames: the readers see
    one test scene of two frames and both objects, the miner finds both
    objects' candidates (all visible enough), and every detection's mask
    lies on its box's depth."""
    job = write_bop_job(str(tmp_path), np.random.RandomState(6), n_pbr_images=8, n_det=4,
                        hw=(120, 160), n_surface=20000)
    objs = port_bop.load_bop_objects(os.path.join(job["dataset_dir"], "models"))
    assert [o.obj_id for o in objs] == job["obj_ids"] == [1, 5]
    assert objs[0].diameter == pytest.approx(2 * np.linalg.norm([40, 30, 20]))
    scenes = port_bop.discover_test_scenes(job["dataset_dir"])
    assert [s.scene_id for s in scenes] == [1] and scenes[0].frame_ids() == [0, 1]
    frame = scenes[0].load_frame(1)
    assert frame["rgb"].shape == (120, 160, 3) and frame["depth"].max() > 500
    mined = port_pbr.PBRTemplateMiner(job["dataset_dir"]).mine()
    assert sorted(mined) == [1, 5] and all(len(v) == 42 for v in mined.values())
    masked, mask = port_pbr.PBRTemplateMiner(job["dataset_dir"]).load_template_crop(mined[5][0])
    assert mask.sum() > 20 and masked[mask].max() > 0
    with open(job["seg_path"]) as f:
        dets = json.load(f)
    assert len(dets) == 8 and {d["category_id"] for d in dets} == {1, 5}
    grouped = port_bop.PEMTestFrameLoader(objs).group_detections(dets)
    assert sorted(grouped) == [(1, 0), (1, 1)]
    from sam6d_torch.data.rle import rle_decode_coco
    for d in dets:
        m = rle_decode_coco(d["segmentation"]).astype(bool)
        depth = scenes[0].load_frame(d["image_id"])["depth"]
        assert m.sum() > 8 and (depth[m] > 0).all()
