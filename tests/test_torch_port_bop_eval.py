"""The BOP evaluation functions of the port against the JAX package on the CPU,
on the mini BOP tree of test_torch_port_bop.py (two 48x64 frames, lmo's
objects 1 and 5) at tiny widths with shared seeded weights:
`run_ism_bop_eval` (SAM proposals, DINOv2 matching against both objects,
size filters, per-object NMS, lmo's category remap), `run_pem_bop_eval`
(per-object onboarding, chunks padded to a power of two, the BOP19 rows),
the shard merges, and the `render-bop` and `bop-eval` subcommands.

Tolerances: record ids, category ids, boxes and RLE masks exact, scores
atol 1e-4 except a slot whose projected box corner lies within 1e-3 px of
an integer (test_torch_port_ism_slice.py); every chunk's PEM inputs exact,
padding included; the coarse RNG differs between the frameworks and JAX's
jitted PEM folds `cos + 0.0` on geo_m's diagonal, so the port's fine half
is held at 1e-4 from eager JAX's coarse pose (as
test_torch_port_frame.py::test_dispatch_frame_multi_matches_jax) and the
CSV rows by their scene, image and object ids and their order; merged
shards equal one run (the time column aside) and JAX's merge byte for
byte."""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.data import bop as jax_bop
from sam6d_tpu.pipelines import bop_eval as jax_eval
from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.pipelines.pem import PEMPipeline as JaxPEMPipeline
from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
from sam6d_torch.core import config as pc
from sam6d_torch.data import bop as port_bop
from sam6d_torch.ops.pointcloud import masked_depth_mean_translation
from sam6d_torch.pipelines import bop_eval as port_eval
from sam6d_torch.pipelines import ism as port_ism
from sam6d_torch.pipelines.pem import PEMPipeline
from sam6d_torch.pipelines.sam_amg import SAMSegmentor
from sam6d_torch.weights.pem import pem_state_dict_from_flax

from test_torch_port_bop import make_mini_tree, mini_detections
from test_torch_port_ism_slice import NEAR_PIXEL
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import (close, jax_variables, tiny_cfg, tiny_dinov2_weights,
                               tiny_ism_cfgs, tiny_sam_cfgs, tiny_sam_weights, tt)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_mini_tree(tmp_path_factory.mktemp("bop"))


def _objects(tree):
    args = (str(tree / "models"), str(tree / "templates"), "lmo")
    return jax_bop.load_bop_objects(*args), port_bop.load_bop_objects(*args)


def _tiny_ism_cfgs():
    jsam, psam = tiny_sam_cfgs()
    jism, pism = tiny_ism_cfgs()
    return dataclasses.replace(jism, sam=jsam), dataclasses.replace(pism, sam=psam)


@pytest.fixture(scope="module")
def ism_pipes(tree):
    """JAX and port ISM pipelines on one set of tiny weights (SAM with blocky
    masks, so NMS keeps several proposals), onboarded with both objects'
    rendered templates."""
    jcfg, pcfg = _tiny_ism_cfgs()
    sam_vars, sam_sd = tiny_sam_weights(pcfg.sam, seed=1, rng=np.random.RandomState(1),
                                        blocky_masks=True)
    dino_sd, dino_vars = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(2))
    jpipe = JaxISMPipeline(jcfg, dinov2_variables=dino_vars,
                           segmentor=JaxSAMSegmentor(jcfg.sam, variables=sam_vars))
    ppipe = port_ism.ISMPipeline(pcfg, state_dict=dino_sd, device="cpu",
                                 segmentor=SAMSegmentor(pcfg.sam, state_dict=sam_sd,
                                                        device="cpu"))
    jobjs, pobjs = _objects(tree)
    jpipe.onboard_bop_objects(jobjs)
    ppipe.onboard_bop_objects(pobjs)
    return jpipe, ppipe, jobjs, pobjs


def _near_pixel_slots(res, depth, K, poses_R, clouds):
    """Slots whose projected object cloud has a point within NEAR_PIXEL of
    an integer pixel (float64 projection from the port's own translation)."""
    t = masked_depth_mean_translation(torch.as_tensor(res["masks"]), torch.as_tensor(depth),
                                      torch.as_tensor(K), 1.0).numpy()
    near = np.zeros(len(t), bool)
    for p in range(len(t)):
        R = poses_R[res["best_template"][p]].astype(np.float64)
        posed = clouds[res["object_ids"][p]].astype(np.float64) @ R.T + t[p]
        uv = posed @ K.T.astype(np.float64)
        uv = uv[:, :2] / uv[:, 2:3]
        near[p] = (np.abs(uv - np.round(uv)) < NEAR_PIXEL).any()
    return near


def test_run_ism_bop_eval_matches_jax(tree, tmp_path, ism_pipes, monkeypatch):
    """Both frames, both objects, lmo: the records' scene and image ids,
    remapped category ids, boxes and RLE masks exactly, scores at 1e-4
    (the near-pixel geometric exception), the file as returned."""
    jpipe, ppipe, jobjs, pobjs = ism_pipes
    want = jax_eval.run_ism_bop_eval(jpipe, str(tree), jobjs, str(tmp_path / "j.json"),
                                     dataset_name="lmo")
    results = []
    match = ppipe.match_frame

    def spy(rgb, depth, K, *a, **kw):
        results.append((match(rgb, depth, K, *a, **kw), depth, K))
        return results[-1][0]

    monkeypatch.setattr(ppipe, "match_frame", spy)
    got = port_eval.run_ism_bop_eval(ppipe, str(tree), pobjs, str(tmp_path / "p.json"),
                                     dataset_name="lmo")
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == got
    assert len(results) == 2 and len(got) == len(want) >= 3
    assert {r["image_id"] for r in got} == {0, 1}
    # object index 1 -> lmo's id 5 (index 0 would be 1)
    assert 5 in {r["category_id"] for r in got} <= {1, 5}
    clouds = np.stack([o.sample_points(ppipe.cfg.matching.pointcloud_sample_num)
                       for o in pobjs])
    poses_R = ppipe.ref_data["poses_R"].numpy()
    slots = []
    for res, depth, K in results:
        near = _near_pixel_slots(res, depth, K, poses_R, clouds)
        slots += [near[i] for i in np.flatnonzero(res["valid"])]
    for g, w, near in zip(got, want, slots):
        assert set(g) == set(w)
        for k in ("scene_id", "image_id", "category_id", "bbox", "segmentation"):
            assert g[k] == w[k], k
        assert abs(g["score"] - w["score"]) <= 1e-4 or near


def _check_onboarding(got, want, tem_pts, eager_trunk):
    """The port's PEM onboarding of one object's views against JAX's: FPS
    picks equal up to the first place where they part, and there only at
    an exact tie (both points at one float64 min-distance from the picks
    before), which the port gives to the lower index as its contract says
    and JAX's float32 sum rounds either way; without a tie, every cached
    array as test_torch_port_pem_slice.py holds them (the structure
    embedding against `eager_trunk`). Returns the pick at which they
    parted, or None."""
    gp, wp = got["dense_po"].numpy(), np.asarray(want["dense_po"])
    differ = np.flatnonzero((gp != wp).any(axis=1))
    if differ.size:
        k = differ[0]
        pts = tem_pts.reshape(-1, 3).astype(np.float64)
        d = np.min(((pts[:, None, :] - gp[:k].astype(np.float64)[None]) ** 2).sum(-1), axis=1)
        ig = np.flatnonzero((pts == gp[k]).all(1))[0]
        iw = np.flatnonzero((pts == wp[k]).all(1))[0]
        assert d[ig] == d[iw] == d.max() and ig < iw, (k, d[ig], d[iw], d.max())
        return int(k)
    np.testing.assert_array_equal(got["fps_idx_o"].numpy(), np.asarray(want["fps_idx_o"]))
    for k in ("dense_fo", "pe_o", "sparse_po", "sparse_fo"):
        close(got[k], want[k])
    # jit folds the embedding's `cos + 0.0` (test_torch_port_pem_slice.py):
    # the structure embedding is held to eager JAX's trunk
    po_n = want["dense_po"] / (jnp.max(jnp.linalg.norm(want["dense_po"], axis=-1)) + 1e-6)
    close(got["geo_o"], eager_trunk(po_n[None], want["dense_fo"][None])["geo_o"][0])
    return None


@pytest.fixture(scope="module")
def pem_pipes():
    cfg = tiny_cfg()
    jnet, variables = jax_variables(cfg)
    port = PEMPipeline(cfg, state_dict=pem_state_dict_from_flax(variables), device="cpu")
    return cfg, jnet, variables, port


def test_run_pem_bop_eval_matches_jax(tree, tmp_path, pem_pipes, monkeypatch):
    """Two frames of 7 kept detections (of 10: one below the seg filter, one
    of an unknown object, one too small) in chunks of 4: each object's
    onboarding as JAX's (_check_onboarding), every chunk's infer_batch
    inputs equal JAX's (the chunk of 3 padded to 4 by its last instance),
    the port's fine half from eager JAX's coarse pose, and the rows' ids in
    JAX's order."""
    cfg, jnet, variables, port = pem_pipes
    jobjs, pobjs = _objects(tree)
    dets = mini_detections(np.random.RandomState(2))
    jpipe = JaxPEMPipeline(cfg, params=variables)
    # both evaluations get the port's template features, once each object was
    # held to JAX's own onboarding of the same views
    onboard_jax, ties = jpipe.onboard_templates, []

    def shared_onboarding(tem):
        got = port.onboard_templates(tem)
        ties.append(_check_onboarding(got, onboard_jax(tem), tem["pts"], lambda po, fo: jnet.apply(
            variables, po, fo, method="template_trunk")))
        return {k: jnp.asarray(v.numpy()) for k, v in got.items()}

    monkeypatch.setattr(jpipe, "onboard_templates", shared_onboarding)
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jpipe, "_infer_jit", lambda v, inputs, key: jax_calls.append(
        (inputs, jnet.apply(v, inputs, key))) or jax_calls[-1][1])
    infer = port.net.infer
    monkeypatch.setattr(port.net, "infer", lambda inputs, gen: port_calls.append(inputs)
                        or infer(inputs, gen))
    want = jax_eval.run_pem_bop_eval(jpipe, str(tree), jobjs, dets, str(tmp_path / "j.csv"),
                                     chunk_size=4)
    assert len(ties) == 2
    got = port_eval.run_pem_bop_eval(port, str(tree), pobjs, dets, str(tmp_path / "p.csv"),
                                     chunk_size=4)
    assert len(port_calls) == len(jax_calls) == 4
    assert [c["rgb"].shape[0] for c in port_calls] == [4, 4, 4, 4]
    for p_in, (j_in, j_out) in zip(port_calls, jax_calls):
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
    # the padded chunk repeats its last instance
    np.testing.assert_array_equal(port_calls[1]["pts"][3].numpy(), port_calls[1]["pts"][2].numpy())
    assert len(got) == len(want) == 14
    assert [r.split(",")[:3] for r in got] == [r.split(",")[:3] for r in want]
    assert {r.split(",")[2] for r in got} == {"1", "5"}
    for r in got:
        R = np.array(r.split(",")[4].split(), float).reshape(3, 3)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    with open(tmp_path / "p.csv") as f:
        assert f.read().splitlines() == ["scene_id,im_id,obj_id,score,R,t,time"] + got


def _drop_time(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


def test_shards_merge_to_one_run_and_as_jax_merges(tree, tmp_path, ism_pipes, pem_pipes):
    """ISM and PEM over two shards (a frame each): the merges equal one
    run, the time column aside, and JAX's merge of the same rank files
    writes the same bytes."""
    _, ppipe, _, pobjs = ism_pipes
    single = port_eval.run_ism_bop_eval(ppipe, str(tree), pobjs, str(tmp_path / "one.json"),
                                        dataset_name="lmo")
    out = str(tmp_path / "ism.json")
    for r in range(2):
        recs = port_eval.run_ism_bop_eval(ppipe, str(tree), pobjs, out, dataset_name="lmo",
                                          shard=r, num_shards=2)
        assert {x["image_id"] for x in recs} <= {r}
        assert os.path.exists(port_eval.shard_path(out, r, 2)) and not os.path.exists(out)
    merged = port_eval.merge_ism_shards(out, 2)
    assert _drop_time(merged) == _drop_time(single) and len(merged) >= 3

    _, _, _, pem = pem_pipes
    dets = mini_detections(np.random.RandomState(2))
    rows1 = port_eval.run_pem_bop_eval(pem, str(tree), pobjs, dets,
                                       str(tmp_path / "one.csv"), chunk_size=4)
    csv = str(tmp_path / "pem.csv")
    for r in range(2):
        port_eval.run_pem_bop_eval(pem, str(tree), pobjs, dets, csv, chunk_size=4, shard=r,
                                   num_shards=2)
    rows = port_eval.merge_pem_shards(csv, 2)
    assert [x.rsplit(",", 1)[0] for x in rows] == [x.rsplit(",", 1)[0] for x in rows1]

    for path in (out, csv):
        base, ext = os.path.splitext(path)
        for r in range(2):
            shutil.copy(port_eval.shard_path(path, r, 2),
                        jax_eval.shard_path(base + "_jax" + ext, r, 2))
    jax_eval.merge_ism_shards(str(tmp_path / "ism_jax.json"), 2)
    jax_eval.merge_pem_shards(str(tmp_path / "pem_jax.csv"), 2)
    for a, b in (("ism.json", "ism_jax.json"), ("pem.csv", "pem_jax.csv")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    assert port_eval.shard_path("a/b.json", 1, 2) == jax_eval.shard_path("a/b.json", 1, 2)


# --------------------------------------------------------------------- CLI

def test_render_bop_and_bop_eval_subcommands(tree, tmp_path, monkeypatch):
    """`render-bop` and `bop-eval` through main([...]) on the CPU at tiny
    widths (default_config patched): JAX's file names, both onboardings'
    caches, the PEM stage on a given detection json, and --merge_shards."""
    from sam6d_torch.cli.main import main
    _, pism = _tiny_ism_cfgs()
    cfg = pc.Config(ism=pism, pem=tiny_cfg(), render=pc.RenderConfig(image_size=64))
    monkeypatch.setattr(pc, "default_config", lambda: cfg)
    troot, out = str(tmp_path / "templates"), tmp_path / "out"
    main(["render-bop", "--dataset_dir", str(tree), "--dataset_name", "lmo",
          "--output_dir", troot, "--obj_ids", "5", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(troot, "lmo"))) == ["obj_000005"]
    main(["render-bop", "--dataset_dir", str(tree), "--dataset_name", "lmo",
          "--output_dir", troot, "--device", "cpu"])
    for oid in (1, 5):
        assert len(os.listdir(os.path.join(troot, "lmo", f"obj_{oid:06d}"))) == 3 * 42
    seg = tmp_path / "dets.json"
    with open(seg, "w") as f:
        json.dump(mini_detections(np.random.RandomState(2)), f)
    common = ["bop-eval", "--dataset_dir", str(tree), "--dataset_name", "lmo",
              "--template_dir", troot, "--output_dir", str(out), "--device", "cpu"]
    main(common + ["--stage", "ism", "--max_frames", "2"])
    main(common + ["--stage", "ism", "--max_frames", "1", "--onboarding", "render"])
    assert {"ism_lmo.json", "descriptors_pbr.npz", "descriptors.npz"} <= set(os.listdir(out))
    with open(out / "ism_lmo.json") as f:
        assert {r["image_id"] for r in json.load(f)} <= {0}
    main(common + ["--stage", "pem", "--seg_path", str(seg)])
    with open(out / "sam6dtpu_lmo-test.csv") as f:
        single = f.read().splitlines()
    assert single[0] == "scene_id,im_id,obj_id,score,R,t,time" and len(single) == 15
    for r in range(2):
        main(common + ["--stage", "pem", "--seg_path", str(seg), "--num_shards", "2",
                       "--shard", str(r)])
    main(common + ["--stage", "pem", "--num_shards", "2", "--merge_shards"])
    with open(out / "sam6dtpu_lmo-test.csv") as f:
        merged = f.read().splitlines()
    assert [x.rsplit(",", 1)[0] for x in merged] == [x.rsplit(",", 1)[0] for x in single]


def test_bop_subcommands_refuse_a_missing_card(tree, tmp_path, monkeypatch):
    """Without --device cpu both subcommands ask for the card and fail at
    once, saying so, where there is none; they never fall back to the
    CPU."""
    from sam6d_torch.cli.main import build_parser, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["render-bop", "--dataset_dir", str(tree), "--dataset_name", "lmo",
                  "--output_dir", str(tmp_path / "t")],
                 ["bop-eval", "--dataset_dir", str(tree), "--dataset_name", "lmo",
                  "--output_dir", str(tmp_path / "o")]):
        assert build_parser().parse_args(argv).device == "cuda"
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    assert not os.path.exists(tmp_path / "t") and not os.path.exists(tmp_path / "o")
