"""The port's ISM matching slice against the JAX package's ISMPipeline on the
CPU, at the tiny DINOv2 of torch_port_common (C=32, 2 blocks, 4 heads, 28x28
crops, chunk 8) on carried-over weights: template onboarding from one
directory, then match_frame on a 48x64 frame with 16 proposal slots of which
the first 5 are valid, with and without per-object NMS and size filters, and
the BOP json records; and the smoke's synthetic proposal buffer."""
import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.pipelines.ism import detections_to_bop_json as jax_to_json
from sam6d_torch.data.rle import rle_decode_coco
from sam6d_torch.data.synthetic import write_ism_job
from sam6d_torch.ops.pointcloud import masked_depth_mean_translation
from sam6d_torch.pipelines import ism as port_ism

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, tiny_dinov2_weights, tiny_ism_cfgs

H, W = 48, 64
K_CAM = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
# a projected box corner within this of an integer pixel may truncate to
# either side of it in the two frameworks (their depth means differ in the
# last float32 places), which moves the geometric score by a whole pixel
NEAR_PIXEL = 1e-3


def _template_dir(path, rng, n=42):
    for i in range(n):
        rgb = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        m = np.zeros((32, 32), np.uint8)
        r0, c0 = rng.randint(2, 10, 2)
        m[r0:r0 + rng.randint(10, 20), c0:c0 + rng.randint(10, 20)] = 255
        Image.fromarray(rgb).save(path / f"rgb_{i}.png")
        Image.fromarray(m).save(path / f"mask_{i}.png")
    return str(path)


def _frame(rng, K=16, n_valid=5):
    rgb = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    depth = (rng.rand(H, W) * 900 + 100).astype(np.float32)
    depth[rng.rand(H, W) < 0.1] = 0.0
    masks = np.zeros((K, H, W), bool)
    boxes = np.zeros((K, 4), np.float32)
    for k in range(K):
        y0, x0 = rng.randint(0, H - 12), rng.randint(0, W - 12)
        h, w = rng.randint(1, H - y0 + 1), rng.randint(1, W - x0 + 1)
        masks[k, y0:y0 + h, x0:x0 + w] = rng.rand(h, w) > 0.3
        if k == 3:                             # removed by the size filters
            masks[k] = False
            masks[k, y0:y0 + 2, x0:x0 + 3] = True
        ys, xs = np.nonzero(masks[k])
        boxes[k] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    boxes[1] = boxes[0] + [1, 0, 1, 1]         # near-duplicate: NMS suppresses
    masks[1] = masks[0]
    return rgb, depth, dict(masks=masks, boxes=boxes, valid=np.arange(K) < n_valid)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    jcfg, pcfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(1))
    jax_pipe = JaxISMPipeline(jcfg, dinov2_variables=variables)
    port = port_ism.ISMPipeline(pcfg, state_dict=sd, device="cpu")
    tdir = _template_dir(tmp_path_factory.mktemp("templates"), np.random.RandomState(2))
    want = jax_pipe.onboard_templates_from_dir(tdir)
    got = port.onboard_templates_from_dir(tdir)
    return jax_pipe, port, want, got


def test_onboarding_matches_jax(pipes):
    _, _, want, got = pipes
    assert got["descriptors"].shape == (1, 42, 32)
    close(got["descriptors"], want["descriptors"])
    close(got["appe_descriptors"], want["appe_descriptors"])
    np.testing.assert_array_equal(got["poses_R"].numpy(), np.asarray(want["poses_R"]))


def _near_pixel_slots(res, cloud):
    """Slots whose projected CAD box has a corner within NEAR_PIXEL of an
    integer pixel (float64 projection from the port's own translation)."""
    t = masked_depth_mean_translation(torch.as_tensor(res["masks"]),
                                      torch.as_tensor(res["depth"]),
                                      torch.as_tensor(K_CAM), 1.0).numpy()
    near = np.zeros(len(t), bool)
    for p in range(len(t)):
        R = res["poses_R"][res["best_template"][p]].astype(np.float64)
        posed = cloud.astype(np.float64) @ R.T + t[p]
        uv = (posed @ K_CAM.T.astype(np.float64))
        uv = uv[:, :2] / uv[:, 2:3]
        near[p] = (np.abs(uv - np.round(uv)) < NEAR_PIXEL).any()
    return near


@pytest.mark.parametrize("nms,size_filters", [(False, False), (True, True)])
def test_match_frame_matches_jax(pipes, nms, size_filters):
    """valid, object_ids and best_template exactly; the scores at 1e-4,
    except that the geometric score (and so the final score) may differ on
    a slot whose projected box corner lies within NEAR_PIXEL of an integer
    pixel; then the BOP records."""
    jax_pipe, port, _, got_ref = pipes
    rng = np.random.RandomState(3)
    rgb, depth, dets = _frame(rng)
    cloud = (rng.rand(64, 3).astype(np.float32) - 0.5) * 0.05
    kw = dict(detections=dets, apply_nms_per_object=nms,
              apply_size_filters=size_filters)
    want = jax_pipe.match_frame(rgb, depth, K_CAM, 1.0, cloud[None], **kw)
    got = port.match_frame(rgb, depth, K_CAM, 1.0, cloud[None], **kw)
    for k in ("valid", "object_ids", "best_template"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    if size_filters:
        assert not got["valid"][3]
    if nms:
        assert got["valid"][0] != got["valid"][1]
    assert got["valid"].sum() >= 2
    for k in ("semantic_score", "appe_score", "visible_ratio"):
        close(got[k], want[k])
    geo_diff = np.abs(got["geometric_score"] - np.asarray(want["geometric_score"])) > 1e-4
    if geo_diff.any():
        near = _near_pixel_slots(dict(got, depth=depth, poses_R=got_ref["poses_R"].numpy()),
                                 cloud)
        assert not (geo_diff & ~near).any(), np.flatnonzero(geo_diff & ~near)
    keep = ~geo_diff
    close(got["geometric_score"][keep], np.asarray(want["geometric_score"])[keep])
    close(got["scores"][keep], np.asarray(want["scores"])[keep])
    np.testing.assert_array_equal(got["masks"], np.asarray(want["masks"]))
    np.testing.assert_array_equal(got["boxes"], np.asarray(want["boxes"]))

    recs = port_ism.detections_to_bop_json(got)
    wrecs = jax_to_json({k: np.asarray(v) for k, v in want.items()})
    assert len(recs) == len(wrecs) == int(got["valid"].sum())
    for r, w in zip(recs, wrecs):
        assert set(r) == set(w)
        for k in ("scene_id", "image_id", "category_id", "bbox", "segmentation", "time"):
            assert r[k] == w[k], k
        assert abs(r["score"] - w["score"]) < 1e-4


def test_adaptive_describe_leaves_the_unneeded_chunks_zero(pipes):
    """Only ceil(n_needed / chunk) chunks are described; the others stay
    zero, and the described ones equal the full describe."""
    _, port, _, _ = pipes
    imgs = torch.from_numpy(np.random.RandomState(4).rand(20, 28, 28, 3).astype(np.float32))
    with torch.no_grad():
        full_cls, full_patch = port._dino_forward_chunked(imgs)
        for n, described in ((0, 0), (5, 8), (9, 16), (20, 20)):
            cls, patch = port._dino_forward_chunked(imgs, n)
            assert torch.equal(cls[:described], full_cls[:described])
            assert torch.equal(patch[:described], full_patch[:described])
            assert not cls[described:].any() and not patch[described:].any()


def test_host_size_filter_and_needed_prefix():
    masks = np.zeros((4, 10, 20), bool)
    masks[0, :5, :5] = True
    masks[1, 0, 0] = True                       # mask area 1/200 > 3e-4
    masks[2, :8, :8] = True
    boxes = np.array([[0, 0, 5, 5], [0, 0, 1, 1], [0, 0, 8, 8], [0, 0, 9, 9]],
                     np.float32)
    valid = np.array([True, True, False, True])
    keep = port_ism.host_size_filter(masks, boxes, valid, 0.05, 3e-4)
    # box area 1/200 = 0.005 > 0.0025 keeps slot 1; slot 3 has an empty mask
    np.testing.assert_array_equal(keep, [True, True, False, False])
    assert port_ism.needed_prefix(keep) == 2
    assert port_ism.needed_prefix(np.zeros(4, bool)) == 0


def test_write_ism_job_proposal_buffer(tmp_path):
    """The smoke's proposal buffer: 128 slots, the first 48 valid, the first
    16 the PEM job's detection masks, every mask on the object's visible
    pixels with its tight xyxy box."""
    job = write_ism_job(str(tmp_path), np.random.RandomState(5), n_views=2)
    p = job["proposals"]
    assert p["masks"].shape == (128, 480, 640) and p["masks"].dtype == bool
    np.testing.assert_array_equal(p["valid"], np.arange(128) < 48)
    for k, det in enumerate(job["dets"]):
        np.testing.assert_array_equal(p["masks"][k], rle_decode_coco(det["segmentation"]))
    assert not (p["masks"] & ~(job["depth_arr"] > 0)).any()
    for m, b in zip(p["masks"][::17], p["boxes"][::17]):
        ys, xs = np.nonzero(m)
        np.testing.assert_array_equal(b, [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    with np.load(tmp_path / "proposals.npz") as f:
        np.testing.assert_array_equal(f["boxes"], p["boxes"])
