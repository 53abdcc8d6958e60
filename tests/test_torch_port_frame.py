"""The frame slice of the port against the JAX package on the CPU, at tiny
widths with shared seeded weights: ISM's packed (K, 12) pull, multi-object
PEM (`dispatch_frame_multi` / `finalize_frame_multi`), the bitpacked mask
pull, synchronous against pipelined `MultiObjectStream`, the composed frame
(`run_demo` render -> ISM -> PEM in both packages on one set of port-rendered
templates), the `render`, `demo` and `stream` subcommands and the BOP
writers (the FastSAM frame is in test_torch_port_fastsam.py).

Tolerances: indices, flags, boxes, RLE masks and file layouts exact; scores
and descriptors atol = rtol = 1e-4 (float32 sums in another order), except
the geometric score of a slot whose projected box corner lies within 1e-3
px of an integer (test_torch_port_ism_slice.py); PEM poses of the fine
half from JAX's own coarse pose at 1e-4. The coarse RNG differs between the
frameworks, so the composed frame holds the port's poses to the rotation
group, not to JAX's poses."""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_tpu.core import config as jc
from sam6d_tpu.pipelines.demo import run_demo as jax_run_demo
from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.pipelines.pem import PEMPipeline as JaxPEMPipeline
from sam6d_torch.core import config as pc
from sam6d_torch.data.mesh import load_ply
from sam6d_torch.data.synthetic import box_ply
from sam6d_torch.eval import bop_writer
from sam6d_torch.pipelines import ism as port_ism
from sam6d_torch.pipelines import pem as port_pem
from sam6d_torch.pipelines.demo import run_demo
from sam6d_torch.pipelines.sam_amg import SAMSegmentor
from sam6d_torch.pipelines.streaming import MultiObjectStream, pack_mask_bits
from sam6d_torch.render.templates import render_templates
from sam6d_torch.weights.pem import pem_state_dict_from_flax

from test_torch_port_ism_slice import K_CAM, _frame, _near_pixel_slots, _template_dir
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import (close, jax_variables, tiny_cfg, tiny_dinov2_weights,
                               tiny_ism_cfgs, tiny_sam_cfgs, tiny_sam_weights, tt)


# ------------------------------------------------------------- ISM packed

@pytest.fixture(scope="module")
def ism_pipes(tmp_path_factory):
    jcfg, pcfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(1))
    jax_pipe = JaxISMPipeline(jcfg, dinov2_variables=variables)
    port = port_ism.ISMPipeline(pcfg, state_dict=sd, device="cpu")
    tdir = _template_dir(tmp_path_factory.mktemp("templates"), np.random.RandomState(2))
    jax_pipe.onboard_templates_from_dir(tdir)
    ref = port.onboard_templates_from_dir(tdir)
    return jax_pipe, port, ref


def test_packed_pull_matches_the_dict_and_jax(ism_pipes):
    """(K, 12): score, object id, valid, sem, appe, geo, vis, best template,
    box x1 y1 x2 y2 -- the port's own fields exactly, JAX's packed row for
    row."""
    jax_pipe, port, ref = ism_pipes
    rng = np.random.RandomState(3)
    rgb, depth, dets = _frame(rng)
    cloud = (rng.rand(64, 3).astype(np.float32) - 0.5) * 0.05
    kw = dict(detections=dets, apply_nms_per_object=True, apply_size_filters=True)
    got = port.match_frame(rgb, depth, K_CAM, 1.0, cloud[None], **kw)
    want = np.asarray(jax_pipe.match_frame(rgb, depth, K_CAM, 1.0, cloud[None], **kw)["packed"])
    pk = got["packed"]
    assert pk.shape == want.shape == (16, 12) and pk.dtype == np.float32
    cols = ("scores", "object_ids", "valid", "semantic_score", "appe_score",
            "geometric_score", "visible_ratio", "best_template")
    for j, k in enumerate(cols):
        np.testing.assert_array_equal(pk[:, j], got[k].astype(np.float32), err_msg=k)
    np.testing.assert_array_equal(pk[:, 8:], got["boxes"])
    for j in (1, 2, 7, 8, 9, 10, 11):
        np.testing.assert_array_equal(pk[:, j], want[:, j], err_msg=str(j))
    for j in (3, 4, 6):
        close(pk[:, j], want[:, j])
    keep = np.abs(pk[:, 5] - want[:, 5]) <= 1e-4
    near = _near_pixel_slots(dict(got, depth=depth, poses_R=ref["poses_R"].numpy()), cloud)
    assert (keep | near).all()
    close(pk[keep][:, [0, 5]], want[keep][:, [0, 5]])


# ------------------------------------------------------- multi-object PEM

def _pem_frame(rng, H=48, W=64, n=3):
    rgb = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    depth = (rng.rand(H, W) * 200 + 500).astype(np.float32)
    dets = []
    for k in range(n):
        m = np.zeros((H, W), np.uint8)
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        m[y0:y0 + H // 2, x0:x0 + W // 2] = 1
        dets.append(dict(object_id=k % 2, score=0.5 + 0.1 * k, bbox=[0, 0, 1, 1], mask=m))
    return rgb, depth, dets


@pytest.fixture(scope="module")
def pem_pipes():
    cfg = tiny_cfg()
    jnet, variables = jax_variables(cfg)
    port = port_pem.PEMPipeline(cfg, state_dict=pem_state_dict_from_flax(variables),
                                device="cpu")
    rng = np.random.RandomState(4)
    S, P = cfg.img_size, cfg.n_sample_template_point
    objs = []
    for _ in range(2):
        base = (rng.rand(2, 60, 3).astype(np.float32) - 0.5) * 0.1
        tem = dict(rgb=rng.randn(2, S, S, 3).astype(np.float32),
                   choose=rng.randint(0, S * S, (2, P)),
                   pts=np.stack([b[rng.randint(0, 60, P)] for b in base]))
        objs.append(port.onboard_templates(tem))
    templates_all = {k: torch.stack([o[k] for o in objs]) for k in objs[0]}
    model_all = torch.from_numpy(
        (rng.rand(2, cfg.n_sample_model_point, 3).astype(np.float32) - 0.5) * 0.1)
    return cfg, jnet, variables, port, templates_all, model_all


def test_dispatch_frame_multi_matches_jax(pem_pipes, monkeypatch):
    """Both packages gather the same per-instance inputs (templates by object
    index), and from JAX's own coarse pose the port's fine half gives JAX's
    (eager) poses; finalize_frame_multi gives JAX's result layout."""
    cfg, jnet, variables, port, templates_all, model_all = pem_pipes
    rgb, depth, dets = _pem_frame(np.random.RandomState(5))
    jpipe = JaxPEMPipeline(cfg, params=variables)
    captured = {}
    # eager JAX as the reference: under jit XLA folds the `cos + 0.0` of
    # the geometric embedding, which moves geo_m's diagonal (see
    # test_torch_port_pem_slice.py)
    monkeypatch.setattr(jpipe, "_infer_jit", lambda v, inputs, key: captured.setdefault(
        "jax", (inputs, jnet.apply(v, inputs, key)))[1])
    jstate = jpipe.dispatch_frame_multi(
        rgb, depth, K_CAM, 1.0, dets, jnp.asarray(model_all.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in templates_all.items()},
        det_score_thresh=0.0, seed=2)
    pinfer = port.net.infer
    monkeypatch.setattr(port.net, "infer", lambda inputs, gen: captured.setdefault(
        "port", (inputs, pinfer(inputs, gen)))[1])
    pstate = port.dispatch_frame_multi(rgb, depth, K_CAM, 1.0, dets, model_all, templates_all,
                                       det_score_thresh=0.0, seed=2)
    j_in, j_out = captured["jax"]
    p_in = captured["port"][0]
    assert pstate["n"] == jstate["n"] == 3 and p_in["rgb"].shape[0] == 4
    assert set(p_in) == set(j_in)
    for k, v in p_in.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_in[k]), err_msg=k)
    with torch.no_grad():
        tr = port.net._shared_trunk(p_in)
        scale = tr["radius"][:, None] + 1e-6
        R, t, score = port.net.infer_fine(tr, p_in["model"] / scale[..., None],
                                          tt(j_out["init_R"]), tt(j_out["init_t"]) / scale,
                                          p_in["pe_o"])
    close(R, j_out["pred_R"])
    close(t * scale, j_out["pred_t"])
    close(score, j_out["pred_pose_score"])
    got, _ = port.finalize_frame_multi(pstate)
    want, _ = jpipe.finalize_frame_multi(jstate)
    assert [set(g) for g in got] == [set(w) for w in want]
    assert [g["object_id"] for g in got] == [w["object_id"] for w in want] == [0, 1, 0]
    for g in got:
        R = np.asarray(g["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_pack_mask_bits_is_jax_packing_byte_for_byte():
    rng = np.random.RandomState(6)
    masks = rng.rand(5, 48, 64) < 0.4
    got = pack_mask_bits(torch.from_numpy(masks)).numpy()
    # the JAX serving loop's packing (a float matmul with weights 128..1)
    w8 = jnp.asarray(np.array([128, 64, 32, 16, 8, 4, 2, 1], np.float32))
    want = np.asarray((jnp.asarray(masks).reshape(5, 48, 8, 8).astype(jnp.float32) @ w8
                       ).astype(jnp.uint8))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.packbits(masks, axis=-1))
    np.testing.assert_array_equal(np.unpackbits(got, axis=-1).astype(bool), masks)


# --------------------------------------------------------------- streaming

def _stream(w):
    _, psam = tiny_sam_cfgs()
    _, pism = tiny_ism_cfgs()
    seg = SAMSegmentor(psam, state_dict=w["sam_sd"], device="cpu")
    ism = port_ism.ISMPipeline(pism, state_dict=w["dino_sd"], device="cpu", segmentor=seg)
    pem = port_pem.PEMPipeline(w["pem_cfg"], state_dict=w["pem_sd"], device="cpu")
    return MultiObjectStream(ism, pem, det_score_thresh=-1.0)


@pytest.fixture(scope="module")
def weights():
    """One set of seeded tiny weights in both packages: SAM (blocky masks,
    so NMS keeps several proposals), DINOv2, PEM."""
    _, psam = tiny_sam_cfgs()
    sam_vars, sam_sd = tiny_sam_weights(psam, seed=1, rng=np.random.RandomState(1),
                                        blocky_masks=True)
    _, pism = tiny_ism_cfgs()
    dino_sd, dino_vars = tiny_dinov2_weights(pism, rng=np.random.RandomState(2))
    pem_cfg = tiny_cfg()
    _, pem_vars = jax_variables(pem_cfg)
    return dict(sam_vars=sam_vars, sam_sd=sam_sd, dino_vars=dino_vars, dino_sd=dino_sd,
                pem_cfg=pem_cfg, pem_vars=pem_vars, pem_sd=pem_state_dict_from_flax(pem_vars))


def test_pipelined_stream_matches_synchronous(weights, tmp_path):
    """Two onboarded objects, three frames: process_stream with one frame in
    flight yields the synchronous results, in order (R atol 1e-5, t atol
    1e-3 mm, as the JAX package holds its own stream)."""
    rng = np.random.RandomState(7)
    pem_cfg = weights["pem_cfg"]
    tdirs = []
    for i in range(2):
        (tmp_path / f"obj{i}").mkdir()
        tdirs.append(_template_dir(tmp_path / f"obj{i}", rng))
        for v in range(42):
            np.save(os.path.join(tdirs[-1], f"xyz_{v}.npy"),
                    (rng.rand(32, 32, 3).astype(np.float32) - 0.5) * 100)
    models = [(rng.rand(pem_cfg.n_sample_model_point, 3).astype(np.float32) - 0.5) * 0.08
              for _ in tdirs]
    items = []
    for _ in range(3):
        items.append(((rng.rand(48, 64, 3) * 255).astype(np.uint8),
                      (rng.rand(48, 64) * 400 + 400).astype(np.float32), K_CAM, 1.0))

    def run(pipelined):
        s = _stream(weights)
        for oid, (d, m) in enumerate(zip(tdirs, models)):
            s.onboard_object(7 + oid, d, m)
        out = (list(s.process_stream(iter(items), depth_in_flight=1)) if pipelined
               else [s.process_frame(*it) for it in items])
        return s, out

    s_sync, ref = run(False)
    s_pipe, out = run(True)
    assert len(out) == len(ref) == 3
    assert s_pipe.throughput()["frames"] == 3 and s_sync.throughput()["ms_per_frame"] > 0
    assert sum(len(r["poses"]) for r in ref) >= 3
    for a, b in zip(out, ref):
        assert [d["object_id"] for d in a["detections"]] == [d["object_id"] for d in b["detections"]]
        for da, db in zip(a["detections"], b["detections"]):
            assert da["segmentation"] == db["segmentation"]
        assert len(a["poses"]) == len(b["poses"])
        for pa, pb in zip(a["poses"], b["poses"]):
            assert pa["object_id"] == pb["object_id"] and pa["object_id"] in (7, 8)
            np.testing.assert_allclose(pa["R"], pb["R"], atol=1e-5)
            np.testing.assert_allclose(pa["t"], pb["t"], atol=1e-3)
    assert s_pipe.check_latency_slo(1e9)["ok"]


# ---------------------------------------------------------- composed frame

def _configs(image_size=64):
    jsam, psam = tiny_sam_cfgs()
    jism, pism = tiny_ism_cfgs()
    pem_cfg = tiny_cfg()
    return (jc.Config(ism=dataclasses.replace(jism, sam=jsam), pem=pem_cfg,
                      render=jc.RenderConfig(image_size=image_size)),
            pc.Config(ism=dataclasses.replace(pism, sam=psam), pem=pem_cfg,
                      render=pc.RenderConfig(image_size=image_size)))


def _write_frame(path, rng, H=48, W=64):
    rgb = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    depth = (rng.rand(H, W) * 200 + 500).astype(np.uint16)
    Image.fromarray(rgb).save(path / "rgb.png")
    Image.fromarray(depth).save(path / "depth.png")
    with open(path / "camera.json", "w") as f:
        json.dump({"cam_K": K_CAM.reshape(-1).tolist(), "depth_scale": 1.0}, f)
    box_ply(str(path / "obj.ply"))
    return [str(path / n) for n in ("obj.ply", "rgb.png", "depth.png", "camera.json")]


def test_composed_frame_matches_jax(weights, tmp_path):
    """Both packages' run_demo(skip_render=True) on one frame and one set of
    templates rendered by the port: the same detection_ism.json records
    (scores 1e-4; boxes, category ids, RLE masks exact), the same kept
    detections sent to PEM, the port's rotations orthonormal."""
    jcfg, pcfg = _configs()
    files = _write_frame(tmp_path, np.random.RandomState(8))
    render_templates(load_ply(files[0]), str(tmp_path / "port"), image_size=64, device="cpu")
    shutil.copytree(tmp_path / "port" / "templates", tmp_path / "jax" / "templates")
    want = jax_run_demo(jcfg, *files, str(tmp_path / "jax"),
                        ism_variables=weights["dino_vars"], sam_variables=weights["sam_vars"],
                        pem_variables=weights["pem_vars"], det_score_thresh=-1.0,
                        skip_render=True)
    got = run_demo(pcfg, *files, str(tmp_path / "port"), dinov2_state_dict=weights["dino_sd"],
                   sam_state_dict=weights["sam_sd"], pem_state_dict=weights["pem_sd"],
                   det_score_thresh=-1.0, skip_render=True, device="cpu")
    for side in ("jax", "port"):
        for name in ("detection_ism.json", "vis_ism.png", "detection_pem.json"):
            assert (tmp_path / side / "sam6d_results" / name).exists(), (side, name)
    assert len(got["ism"]) == len(want["ism"]) >= 2
    for g, w in zip(got["ism"], want["ism"]):
        assert set(g) == set(w)
        for k in ("scene_id", "image_id", "category_id", "bbox", "segmentation"):
            assert g[k] == w[k], k
        assert abs(g["score"] - w["score"]) <= 1e-4
    assert len(got["pem"]) == len(want["pem"]) >= 1
    for g, w in zip(got["pem"], want["pem"]):
        for k in ("category_id", "bbox", "segmentation"):
            assert g[k] == w[k], k
        R = np.asarray(g["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.isfinite(g["t"]).all()
    assert set(got["split_ms"]) >= {"render_ms", "ism_onboard_ms", "ism_frame_ms",
                                    "pem_onboard_ms", "pem_frame_ms"}


# -------------------------------------------------------------------- CLI

def test_render_demo_and_stream_subcommands(tmp_path, monkeypatch):
    """`render`, `demo` and `stream` through main([...]) at tiny widths
    (default_config patched) on the CPU: every output file of each."""
    from sam6d_torch.cli.main import main
    from sam6d_torch.data.synthetic import write_pem_job, write_stream_frames
    _, pcfg = _configs(image_size=32)
    ism = dataclasses.replace(pcfg.ism, matching=dataclasses.replace(
        pcfg.ism.matching, confidence_thresh=-1.0))
    monkeypatch.setattr(pc, "default_config", lambda: dataclasses.replace(pcfg, ism=ism))
    job = write_pem_job(str(tmp_path), np.random.RandomState(10), n_det=1, n_views=2)
    main(["render", "--cad_path", job["cad"], "--output_dir", str(tmp_path / "r"),
          "--device", "cpu"])
    masks = [np.array(Image.open(tmp_path / "r" / "templates" / f"mask_{i}.png"))
             for i in range(42)]
    assert all(m.shape == (32, 32) and m.max() == 255 for m in masks)
    assert np.load(tmp_path / "r" / "templates" / "xyz_0.npy").dtype == np.float16

    main(["demo", "--cad_path", job["cad"], "--rgb_path", job["rgb"],
          "--depth_path", job["depth"], "--cam_path", job["cam"],
          "--output_dir", str(tmp_path / "d"), "--stability_score_thresh", "0",
          "--det_score_thresh", "-1", "--device", "cpu"])
    res = tmp_path / "d" / "sam6d_results"
    for name in ("detection_ism.json", "vis_ism.png", "detection_pem.json"):
        assert (res / name).exists(), name
    assert (tmp_path / "d" / "templates" / "rgb_41.png").exists()

    cad2, fdir, frames = write_stream_frames(str(tmp_path), np.random.RandomState(11),
                                             n_moved=1)
    assert len(frames) == 2 and frames[1][1].max() > 0
    main(["stream", "--cad_paths", job["cad"], cad2, "--frames_dir", fdir,
          "--cam_path", job["cam"], "--output_dir", str(tmp_path / "s"),
          "--det_score_thresh", "-1", "--device", "cpu"])
    with open(tmp_path / "s" / "results.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert [x["frame"] for x in lines] == ["rgb_000.png", "rgb_001.png"]
    assert all((tmp_path / "s" / f"obj_{i}" / "templates" / "mask_0.png").exists()
               for i in range(2))


def test_stream_subcommand_onboards_model_points_in_metres(tmp_path, monkeypatch):
    """`stream` hands MultiObjectStream.onboard_object the mesh's millimetre
    samples / 1000 for both the PEM model cloud and the ISM cloud, as its
    contract (metres) asks. The JAX CLI passes millimetres (PERF.md /
    ROADMAP Queue 3); the port does not copy that."""
    from sam6d_torch.cli.main import main
    from sam6d_torch.data.mesh import load_mesh
    from sam6d_torch.data.synthetic import write_pem_job
    _, pcfg = _configs(image_size=32)
    monkeypatch.setattr(pc, "default_config", lambda: pcfg)
    job = write_pem_job(str(tmp_path), np.random.RandomState(10), n_det=1, n_views=2)
    out = tmp_path / "s"
    (out / "obj_0" / "templates").mkdir(parents=True)   # no render

    class Onboarded(Exception):
        pass

    seen = {}

    def onboard(self, obj_id, template_dir, model_points, ism_points=None, **kw):
        seen.update(obj_id=obj_id, model=model_points, ism=ism_points)
        raise Onboarded

    monkeypatch.setattr(MultiObjectStream, "onboard_object", onboard)
    with pytest.raises(Onboarded):
        main(["stream", "--cad_paths", job["cad"], "--frames_dir", str(tmp_path),
              "--cam_path", job["cam"], "--output_dir", str(out), "--device", "cpu"])
    mesh, rng = load_mesh(job["cad"]), np.random.RandomState(0)
    model_mm = mesh.sample(pcfg.pem.n_sample_model_point, rng)
    ism_mm = mesh.sample(pcfg.ism.matching.pointcloud_sample_num, rng)
    assert seen["obj_id"] == 0
    np.testing.assert_array_equal(seen["model"], model_mm / 1000.0)
    np.testing.assert_array_equal(seen["ism"], ism_mm / 1000.0)
    # the 80 x 60 x 40 mm box: metres, not millimetres
    assert 0.01 < np.abs(seen["model"]).max() < 0.1


# ------------------------------------------------------------- BOP writers

def test_bop_writers_match_jax(tmp_path):
    from sam6d_tpu.eval import bop_writer as jax_writer
    rng = np.random.RandomState(12)
    masks = rng.rand(4, 20, 30) < 0.5
    result = dict(valid=np.array([True, False, True, True]),
                  boxes=rng.rand(4, 4).astype(np.float32) * 20,
                  object_ids=np.array([0, 1, 2, 0]), scores=rng.rand(4).astype(np.float32),
                  masks=masks)
    for mod, name in ((bop_writer, "port.npz"), (jax_writer, "jax.npz")):
        mod.save_detections_npz(str(tmp_path / name), result, 3, 7, 0.5, "lmo")
    got = bop_writer.convert_npz_to_json(str(tmp_path / "port.npz"))
    assert got == jax_writer.convert_npz_to_json(str(tmp_path / "jax.npz"))
    assert [r["category_id"] for r in got] == [1, 6, 1]
    row = bop_writer.format_pose_row(1, 2, 3, 0.5, np.eye(3), np.ones(3), 0.1)
    assert row == jax_writer.format_pose_row(1, 2, 3, 0.5, np.eye(3), np.ones(3), 0.1)
