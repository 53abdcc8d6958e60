"""The port's FastSAM against the JAX package on the CPU, at tiny widths
(TINY_W, TINY_D and imgsz 64, as tests/test_fastsam.py): the modules and the
network with the weights carried across both ways, the segmentor
(letterbox, top-k, NMS, mask assembly), the full-width ultralytics layout,
the composed FastSAM frame (the port's run_demo against the JAX chain
composed by hand, since the JAX demo cannot feed its ISM from FastSAM) and
the `demo --segmentor_model fastsam` subcommand.

Weights: the port's seeded random weights with perturbed BatchNorm
statistics, each conv rescaled on the test frame (`rescale_to_input`), so
that scores, boxes and masks spread instead of sitting at 0.5.

Tolerances: weights carried across exactly; module outputs atol = rtol =
1e-5, network outputs and scores atol = rtol = 1e-4 (float32 sums in
another order); top-k indices, NMS keep sets, `valid` and RLE records
exact; boxes atol 1e-3 px; a mask pixel may differ only where JAX's value
before the threshold lies within NEAR_MASK of 0.5, and those pixels are
counted and bounded."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_tpu.models import fastsam as jfs
from sam6d_tpu.pipelines.fastsam import FastSAMConfig as JaxFastSAMConfig
from sam6d_tpu.pipelines.fastsam import FastSAMSegmentor as JaxFastSAMSegmentor
from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.pipelines.ism import detections_to_bop_json as jax_bop_json
from sam6d_tpu.pipelines.pem import PEMPipeline as JaxPEMPipeline
from sam6d_tpu.pipelines.sam_amg import bilinear_matrix
from sam6d_tpu.weights.convert_fastsam import convert_fastsam_state_dict
from sam6d_torch.core import config as pc
from sam6d_torch.data.mesh import load_ply
from sam6d_torch.data.rle import rle_decode_coco
from sam6d_torch.models import fastsam as pfs
from sam6d_torch.pipelines.demo import run_demo
from sam6d_torch.pipelines.fastsam import FastSAMConfig, FastSAMSegmentor
from sam6d_torch.ops.masks import box_iou
from sam6d_torch.pipelines.sam_amg import stable_top_k
from sam6d_torch.render.templates import render_templates
from sam6d_torch.weights.fastsam import (fastsam_arch, fastsam_state_dict_from_flax,
                                         load_reference_checkpoint, rescale_to_input)
from sam6d_torch.weights.pem import pem_state_dict_from_flax

from test_fastsam_convert import synth_fastsam_x
from test_torch_port_frame import _configs, _write_frame
from test_torch_port_ism_slice import K_CAM
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, jax_variables, tiny_dinov2_weights, tiny_ism_cfgs

TINY_W = (8, 16, 32, 64, 64)
TINY_D = (1, 1, 1, 1)
MODULE_TOL = 1e-5
NET_TOL = 1e-4
BOX_ATOL = 1e-3
NEAR_MASK = 1e-5
FS_KW = dict(imgsz=64, max_det=16)


def _frame(rng, H=60, W=80):
    """A frame whose letterbox is resized (scale 0.8) and padded."""
    return (rng.rand(H, W, 3) * 255).astype(np.uint8)


def _perturb_bn(sd, rng):
    for k in list(sd):
        n = sd[k].shape
        if k.endswith("bn.weight"):
            sd[k] = sd[k] + torch.from_numpy((rng.randn(*n) * 0.2).astype(np.float32))
        elif k.endswith(("bn.bias", "bn.running_mean")):
            sd[k] = sd[k] + torch.from_numpy((rng.randn(*n) * 0.05).astype(np.float32))
        elif k.endswith("bn.running_var"):
            sd[k] = sd[k] * torch.from_numpy(np.exp(rng.randn(*n) * 0.2).astype(np.float32))
    return sd


def tiny_fastsam_weights(image, seed=1, imgsz=64):
    """(port `state_dict`, JAX variables) of one tiny FastSAM: seeded
    random, BatchNorm perturbed, each conv rescaled on `image`'s
    letterboxed canvas."""
    seg = FastSAMSegmentor(FastSAMConfig(imgsz=imgsz), seed=seed, device="cpu",
                           widths=TINY_W, depths=TINY_D)
    seg.net.load_state_dict(_perturb_bn(seg.net.state_dict(), np.random.RandomState(seed)))
    resized, _, _ = seg.letterbox_u8(image)
    rescale_to_input(seg.net, seg.canvas(torch.as_tensor(resized)))
    sd = {k: v.clone() for k, v in seg.net.state_dict().items()}
    return sd, convert_fastsam_state_dict({k: v.numpy() for k, v in sd.items()}, depths=TINY_D)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ------------------------------------------------------------------ weights

def test_weights_round_trip_both_ways():
    """port -> convert_fastsam_state_dict -> fastsam_state_dict_from_flax is
    the identity, and so is JAX init -> port -> JAX, leaf for leaf."""
    sd, variables = tiny_fastsam_weights(_frame(np.random.RandomState(0)))
    back = fastsam_state_dict_from_flax(variables)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    net = jfs.FastSAMNet(widths=TINY_W, depths=TINY_D)
    init = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    again = convert_fastsam_state_dict(_np_sd(fastsam_state_dict_from_flax(init)), depths=TINY_D)
    flat_a = jax.tree_util.tree_flatten_with_path(again)[0]
    flat_i = dict(jax.tree_util.tree_flatten_with_path(init)[0])
    assert len(flat_a) == len(flat_i)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, np.asarray(flat_i[path]), err_msg=str(path))
    assert fastsam_arch(sd) == (TINY_W, TINY_D)


# ------------------------------------------------------------------ modules

def _module_pair(kind, rng):
    """(JAX module, port module, the JAX name the converter gives it, the
    port prefix it maps to, input channels)."""
    if kind == "ConvBnSiLU":
        return jfs.ConvBnSiLU(16, 3, 2), pfs.ConvBnSiLU(8, 16, 3, 2), "m0", "model.0.", 8
    if kind == "C2f":
        return jfs.C2f(16, 2, True), pfs.C2f(12, 16, 2, True), "m2", "model.2.", 12
    if kind == "C2f_neck":
        return jfs.C2f(16, 1, False), pfs.C2f(24, 16, 1, False), "m12", "model.12.", 24
    if kind == "SPPF":
        return jfs.SPPF(16), pfs.SPPF(12, 16), "m9", "model.9.", 12
    return jfs.Proto(24, 8), pfs.Proto(16, 24, 8), "proto", "model.22.proto.", 16


@pytest.mark.parametrize("kind", ["ConvBnSiLU", "C2f", "C2f_neck", "SPPF", "Proto"])
def test_module_matches_jax(kind):
    """Each building block on JAX-initialised weights with random BatchNorm
    statistics, carried into the port by fastsam_state_dict_from_flax."""
    rng = np.random.RandomState(1)
    jmod, pmod, jname, prefix, cin = _module_pair(kind, rng)
    x = rng.randn(1, 12, 10, cin).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.exp(rng.randn(*v.shape) * 0.3).astype(np.float32)),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    sd = fastsam_state_dict_from_flax({"params": {jname: variables["params"]},
                                       "batch_stats": {jname: variables["batch_stats"]}})
    pmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pmod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    close(got, want, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_net_matches_jax(direction):
    """FastSAMNet's decoded predictions (B, A, 4 + 1 + 32), anchors in JAX's
    order (boxes in pixels at BOX_ATOL, the rest at NET_TOL), and its
    prototypes, on a frame's letterboxed canvas: with the port's weights
    converted to JAX, and with JAX's init carried into the port."""
    img = _frame(np.random.RandomState(3))
    if direction == "port_to_jax":
        sd, variables = tiny_fastsam_weights(img)
    else:
        net = jfs.FastSAMNet(widths=TINY_W, depths=TINY_D)
        variables = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        sd = fastsam_state_dict_from_flax(variables)
    seg = FastSAMSegmentor(FastSAMConfig(imgsz=64), state_dict=sd, device="cpu")
    resized, _, _ = seg.letterbox_u8(img)
    x = seg.canvas(torch.as_tensor(resized))
    jp, jproto = jfs.FastSAMNet(widths=TINY_W, depths=TINY_D).apply(
        variables, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    net = pfs.FastSAMNet(TINY_W, TINY_D)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        preds, protos = net.eval()(x)
    assert preds.shape == (1, 84, 37) and protos.shape == (1, 32, 16, 16)
    close(preds[..., :4], np.asarray(jp)[..., :4], atol=BOX_ATOL, rtol=0)
    close(preds[..., 4:], np.asarray(jp)[..., 4:], atol=NET_TOL, rtol=NET_TOL)
    close(protos.permute(0, 2, 3, 1), jproto, atol=NET_TOL, rtol=NET_TOL)
    if direction == "port_to_jax":
        # the rescaled weights spread the scores and the boxes
        assert float(preds[0, :, 4].std()) > 0.05
        assert float((preds[0, :, 2] - preds[0, :, 0]).std()) > 1.0


# ---------------------------------------------------------------- segmentor

def jax_mask_probs(jseg, image):
    """JAX FastSAM's mask values at (H0, W0) before the threshold, with its
    top-k indices: generate_masks' own steps up to `> mask_thresh`."""
    cfg = jseg.cfg
    H0, W0 = image.shape[:2]
    from sam6d_tpu.data.preprocess import bilinear_resize
    scale = cfg.imgsz / max(H0, W0)
    h_in, w_in = int(round(H0 * scale)), int(round(W0 * scale))
    canvas = np.full((cfg.imgsz, cfg.imgsz, 3), 114 / 255.0, np.float32)
    canvas[:h_in, :w_in] = bilinear_resize(image, h_in, w_in).astype(np.float32) / 255.0
    preds, _ = jseg.net.apply(jseg.vars, jnp.asarray(canvas[None]))
    _, top = jax.lax.top_k(preds[0, :, 4], cfg.max_det)
    _, _, _, masks = jseg._predict(jseg.vars, jnp.asarray(canvas[None]), h_in=h_in, w_in=w_in)
    hp, wp = max(int(round(h_in / 4)), 1), max(int(round(w_in / 4)), 1)
    m = jnp.einsum("ah,dhw->daw", jnp.asarray(bilinear_matrix(H0, hp)), masks[:, :hp, :wp])
    m = jnp.einsum("bw,daw->dab", jnp.asarray(bilinear_matrix(W0, wp)), m)
    return np.asarray(m), np.asarray(top)


def assert_masks_match(got, want, probs, thresh=0.5):
    """Masks equal except where JAX's value before the threshold lies within
    NEAR_MASK of it; returns the number of such pixels (bounded by 0.1%)."""
    near = np.abs(probs - thresh) < NEAR_MASK
    assert not ((got != want) & ~near).any()
    assert near.sum() <= 1e-3 * near.size, int(near.sum())
    return int(near.sum())


# the segmentor tests take 64 of the 84 anchors with the class threshold at
# 0.5 and NMS at IoU 0.5, so that both drop some
SEG_KW = dict(imgsz=64, max_det=64, conf_thresh=0.5, iou_thresh=0.5)


@pytest.fixture(scope="module")
def segmentors():
    img = _frame(np.random.RandomState(5))
    sd, variables = tiny_fastsam_weights(img)
    jseg = JaxFastSAMSegmentor(JaxFastSAMConfig(**SEG_KW), variables=variables,
                               widths=TINY_W, depths=TINY_D)
    pseg = FastSAMSegmentor(FastSAMConfig(**SEG_KW), state_dict=sd, device="cpu")
    return jseg, pseg, img


def test_generate_masks_matches_jax(segmentors):
    """The 60x80 frame letterboxed to 48x64 on the 64^2 canvas: the same
    top-k anchors and kept set, boxes in original coordinates, scores, and
    masks thresholded after the bilinear resize."""
    jseg, pseg, img = segmentors
    want = jseg.generate_masks(img)
    got = pseg.generate_masks(img)
    probs, top_j = jax_mask_probs(jseg, img)
    resized, _, _ = pseg.letterbox_u8(img)
    with torch.no_grad():
        preds, _ = pseg.net(pseg.canvas(torch.as_tensor(resized)))
    # exact selections need no near-tie: the ranked scores, the scores
    # against the class threshold and the box IoUs against the NMS
    # threshold are all further apart than the frameworks' rounding
    scores = torch.sort(preds[0, :, 4]).values
    assert float((scores[1:] - scores[:-1]).min()) > NET_TOL
    assert float((scores - pseg.cfg.conf_thresh).abs().min()) > NET_TOL
    boxes = preds[0, stable_top_k(preds[0, :, 4], pseg.cfg.max_det), :4]
    assert float((box_iou(boxes, boxes) - pseg.cfg.iou_thresh).abs().min()) > NET_TOL
    top_p = stable_top_k(preds[0, :, 4], pseg.cfg.max_det).numpy()
    np.testing.assert_array_equal(top_p, top_j)
    for k, shape in (("masks", (64, 60, 80)), ("boxes", (64, 4)), ("valid", (64,)),
                     ("iou_preds", (64,))):
        assert got[k].shape == want[k].shape == shape, k
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # the class threshold and NMS both drop proposals here
    dropped_by_score = int((got["iou_preds"] <= pseg.cfg.conf_thresh).sum())
    assert dropped_by_score >= 1 and 1 <= got["valid"].sum() < 64 - dropped_by_score
    close(got["iou_preds"], want["iou_preds"], atol=NET_TOL, rtol=NET_TOL)
    close(got["boxes"], want["boxes"], atol=BOX_ATOL, rtol=0)
    assert_masks_match(got["masks"], want["masks"], probs)
    assert 0 < got["masks"].mean() < 1
    assert pseg.last_nms_rounds >= 1


def test_generate_masks_device_contract(segmentors):
    """The device contract ISMPipeline._segment takes: bool masks at the
    frame's size, the host path's boxes and flags."""
    _, pseg, img = segmentors
    dev = pseg.generate_masks_device(img)
    host = pseg.generate_masks(img)
    assert dev["orig_size"] == dev["seg_size"] == (60, 80)
    assert dev["masks"].dtype == torch.bool and dev["masks"].shape == (64, 60, 80)
    np.testing.assert_array_equal(dev["masks"].numpy(), host["masks"] > 0)
    np.testing.assert_array_equal(dev["boxes"].numpy(), host["boxes"])
    np.testing.assert_array_equal(dev["valid"].numpy(), host["valid"])
    b = host["boxes"]
    assert (b >= 0).all() and (b[:, [0, 2]] <= 79).all() and (b[:, [1, 3]] <= 59).all()


def test_full_width_layout_loads():
    """The real FastSAM-x layout (ultralytics names, derived independently
    by tests/test_fastsam_convert.py) loads into the port's FastSAM-x:
    every model.* tensor is consumed except the DFL conv, and the widths
    and depths are read back from it."""
    sd = synth_fastsam_x()
    for i, v in enumerate(sd.values()):       # one value per tensor, in place
        if v.dtype == np.float32:
            v += i
    with torch.device("meta"):
        net = pfs.FastSAMNet()
    net = net.to_empty(device="cpu")
    unused = load_reference_checkpoint(sd, net)
    assert unused == ["model.22.dfl.conv.weight"]
    own = net.state_dict()
    assert len(own) == len(sd) - 1
    for k, v in own.items():
        assert torch.equal(v, torch.as_tensor(sd["model." + k])), k
    arch = fastsam_arch({k.replace("model.model.", "model.", 1): v for k, v in sd.items()})
    assert arch == ((80, 160, 320, 640, 640), (3, 6, 6, 3))


# ---------------------------------------------------------- composed frame

def _fastsam_configs(image_size=64):
    jcfg, pcfg = _configs(image_size)
    return jcfg, dataclasses.replace(pcfg, ism=dataclasses.replace(
        pcfg.ism, segmentor="fastsam", fastsam=FastSAMConfig(**FS_KW)))


def test_composed_fastsam_frame_matches_jax(tmp_path):
    """The port's run_demo(segmentor='fastsam') against the JAX chain
    composed by hand (FastSAMSegmentor.generate_masks -> ISMPipeline.
    match_frame(detections=...) -> detections_to_bop_json ->
    PEMPipeline.run_frame) on one frame and one set of port-rendered
    templates: the same detection_ism.json records (RLE masks and category
    ids exact, boxes 1e-3 px, scores 1e-4) and the same detections sent to
    PEM; every output file; the port's rotations orthonormal."""
    jcfg, pcfg = _fastsam_configs()
    files = _write_frame(tmp_path, np.random.RandomState(8))
    rgb = np.array(Image.open(files[1]).convert("RGB"))
    depth = np.array(Image.open(files[2])).astype(np.float32)
    fs_sd, fs_vars = tiny_fastsam_weights(rgb)
    _, pism = tiny_ism_cfgs()
    dino_sd, dino_vars = tiny_dinov2_weights(pism, rng=np.random.RandomState(2))
    _, pem_vars = jax_variables(pcfg.pem)
    mesh = load_ply(files[0])
    tdir = render_templates(mesh, str(tmp_path / "port"), image_size=64, device="cpu")
    got = run_demo(pcfg, *files, str(tmp_path / "port"), dinov2_state_dict=dino_sd,
                   sam_state_dict=fs_sd, pem_state_dict=pem_state_dict_from_flax(pem_vars),
                   det_score_thresh=-1.0, skip_render=True, device="cpu")
    for name in ("detection_ism.json", "vis_ism.png", "detection_pem.json", "vis_pem.png"):
        assert (tmp_path / "port" / "sam6d_results" / name).exists(), name

    jseg = JaxFastSAMSegmentor(JaxFastSAMConfig(**FS_KW), variables=fs_vars,
                               widths=TINY_W, depths=TINY_D)
    dets = jseg.generate_masks(rgb)
    probs, _ = jax_mask_probs(jseg, rgb)
    # a box corner near an integer could truncate to either side in the
    # describe's crop; none is here, so every score compares at 1e-4
    inner = dets["boxes"][(dets["boxes"] > 0) & (dets["boxes"] < [63, 47, 63, 47])]
    assert np.abs(inner - np.round(inner)).min() > BOX_ATOL
    jism = JaxISMPipeline(jcfg.ism, dinov2_variables=dino_vars)
    jism.onboard_templates_from_dir(tdir)
    pts_ism = mesh.sample(jcfg.ism.matching.pointcloud_sample_num,
                          np.random.RandomState(0)).astype(np.float32) / 1000.0
    result = jism.match_frame(rgb, depth, K_CAM, 1.0, jnp.asarray(pts_ism[None]),
                              detections=dets, apply_size_filters=False)
    want_ism = jax_bop_json(result)
    jpem = JaxPEMPipeline(jcfg.pem, params=pem_vars)
    pts = mesh.sample(jcfg.pem.n_sample_model_point,
                      np.random.RandomState(0)).astype(np.float32) / 1000.0
    want_pem, _ = jpem.run_frame(rgb, depth, K_CAM, 1.0, want_ism, pts,
                                 jpem.onboard_templates(jpem.load_template_views(tdir)), -1.0)

    assert len(got["ism"]) == len(want_ism) >= 2
    slots = np.where(np.asarray(result["valid"]))[0]
    for g, w, slot in zip(got["ism"], want_ism, slots):
        assert set(g) == set(w)
        for k in ("scene_id", "image_id", "category_id"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_ATOL, rtol=0)
        assert abs(g["score"] - w["score"]) <= NET_TOL
        assert_masks_match(rle_decode_coco(g["segmentation"]),
                           rle_decode_coco(w["segmentation"]), probs[slot])
    with open(tmp_path / "port" / "sam6d_results" / "detection_ism.json") as f:
        assert len(json.load(f)) == len(got["ism"])
    assert len(got["pem"]) == len(want_pem) == len(want_ism)
    for g, w in zip(got["pem"], want_pem):
        assert g["category_id"] == w["category_id"] and g["segmentation"] == w["segmentation"]
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_ATOL, rtol=0)
        R = np.asarray(g["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.isfinite(g["t"]).all()


def test_demo_subcommand_with_fastsam(tmp_path, monkeypatch):
    """`demo --segmentor_model fastsam` through main([...]) on the CPU, the
    FastSAM weights read from --sam_ckpt (ultralytics names, with the DFL
    conv and num_batches_tracked the real file carries): every output
    file."""
    from sam6d_torch.cli.main import main
    from sam6d_torch.data.synthetic import write_pem_job
    _, pcfg = _fastsam_configs(image_size=32)
    ism = dataclasses.replace(pcfg.ism, matching=dataclasses.replace(
        pcfg.ism.matching, confidence_thresh=-1.0))
    monkeypatch.setattr(pc, "default_config", lambda: dataclasses.replace(pcfg, ism=ism))
    job = write_pem_job(str(tmp_path), np.random.RandomState(10), n_det=1, n_views=2)
    rgb = np.array(Image.open(job["rgb"]).convert("RGB"))
    sd, _ = tiny_fastsam_weights(rgb)
    ckpt = {k.replace("model.", "model.model.", 1): v for k, v in sd.items()}
    ckpt["model.model.22.dfl.conv.weight"] = torch.arange(16.0).reshape(1, 16, 1, 1)
    torch.save(ckpt, tmp_path / "fastsam.pt")
    main(["demo", "--segmentor_model", "fastsam", "--sam_ckpt", str(tmp_path / "fastsam.pt"),
          "--cad_path", job["cad"], "--rgb_path", job["rgb"], "--depth_path", job["depth"],
          "--cam_path", job["cam"], "--output_dir", str(tmp_path / "d"),
          "--det_score_thresh", "-1", "--device", "cpu"])
    res = tmp_path / "d" / "sam6d_results"
    for name in ("detection_ism.json", "vis_ism.png", "detection_pem.json", "vis_pem.png"):
        assert (res / name).exists(), name
    assert (tmp_path / "d" / "templates" / "rgb_41.png").exists()
    with open(res / "detection_ism.json") as f:
        records = json.load(f)
    with open(res / "detection_pem.json") as f:
        poses = json.load(f)
    # PEM skips a detection with too few depth points in its mask
    assert len(records) >= 1 and 1 <= len(poses) <= len(records)
    assert {json.dumps(p["segmentation"]) for p in poses} <= {
        json.dumps(r["segmentation"]) for r in records}
