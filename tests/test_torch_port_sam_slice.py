"""The port's SAM segmentor slice against the JAX package on the CPU, on one
set of seeded weights (tiny_sam_cfgs: a C=32 encoder of 3 blocks on a
64x64 canvas, an 8x8 prompt grid in chunks of 8, capacity 8, so the iou
prefix keeps 8 of 64 points and NMS runs over the top 16 of 24
candidates): the device AMG, the host AMG at another frame size (mask and
box resize), the device size filter, and ISMPipeline.match_frame taking its
proposals from the segmentor (detections=None) against the JAX pipeline
with its segmentor."""
import numpy as np
import pytest
import torch

from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
from sam6d_torch.ops.masks import box_iou, masks_to_boxes
from sam6d_torch.pipelines import ism as port_ism
from sam6d_torch.pipelines.sam_amg import SAMSegmentor, resize_logits, stable_top_k

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import (close, tiny_dinov2_weights, tiny_ism_cfgs,
                               tiny_sam_cfgs, tiny_sam_weights, tt)

# The comparisons below are exact for indices, masks and boxes, with one
# exception. A mask pixel is `logit > 0`, and float32 sums taken in another
# order move a logit by ~1e-6: across the 24 scored candidates of 48x64
# pixels some logit lies within 1e-4 of 0 (the smallest here is 3.2e-5), so
# a kept mask may differ from JAX's only at pixels whose logit (the port's)
# is within NEAR_LOGIT of 0, and its box only as far as such pixels move it.
# Selections rank by predicted IoU, so exact `valid` and slot order need no
# near-tie there: `_scored` measures the gaps between the ranked IoUs and
# between each box-pair IoU and the NMS threshold, and the tests assert them
# first.
NEAR_LOGIT = 1e-4
NEAR_IOU = 1e-5


def _frame(rng, H=48, W=64):
    return (rng.rand(H, W, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def segmentors():
    jcfg, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, seed=1, rng=np.random.RandomState(1),
                                     blocky_masks=True)
    return (JaxSAMSegmentor(jcfg, variables=variables),
            SAMSegmentor(pcfg, state_dict=sd, device="cpu"))


def _scored(seg, image):
    """The port's scored candidates on `image` (iou (3p,), logits (3p, hs,
    ws)), after asserting that no ranking or NMS decision is a near-tie."""
    cfg = seg.cfg
    resized, _, (hs, ws), (h_in, w_in) = seg.preprocess_frame_u8(image)
    Ry, Rx, pts = seg.frame_constants(hs, ws, h_in, w_in)
    with torch.no_grad():
        emb = seg._encode_u8(torch.as_tensor(resized))
        pe = seg.sam.prompt_encoder.dense_pe()
        key = seg._iou_all_impl(emb, pe, pts).max(dim=1).values
        top = stable_top_k(key, seg.last_prefix)
        iou, _, boxes, lows = seg._score_all_impl(emb, pe, pts[top], Ry, Rx)

    def gap(x):
        s = torch.sort(x).values
        return float((s[1:] - s[:-1]).min())

    assert min(gap(key), gap(iou)) > NEAR_IOU
    assert float((box_iou(boxes, boxes) - cfg.box_nms_thresh).abs().min()) > NEAR_IOU
    return iou, resize_logits(lows, Ry, Rx)


def _assert_same_proposals(pseg, image, got, want):
    """got / want: the port's and JAX's generate_masks_device on `image`.
    Returns the slots whose masks are bit-equal."""
    iou, logits = _scored(pseg, image)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    close(got["iou_preds"], want["iou_preds"])
    same = []
    for k, (m, wm) in enumerate(zip(got["masks"].numpy(), np.asarray(want["masks"]))):
        c = int(torch.argmin((iou - got["iou_preds"][k]).abs()))
        assert iou[c] == got["iou_preds"][k]
        near = (logits[c].abs() < NEAR_LOGIT).numpy()
        assert not ((m != wm) & ~near).any(), k
        if (m == wm).all():
            same.append(k)
            np.testing.assert_array_equal(got["boxes"][k].numpy(), np.asarray(want["boxes"])[k])
        else:
            np.testing.assert_array_equal(
                np.asarray(want["boxes"])[k],
                masks_to_boxes(torch.from_numpy(wm)[None])[0].numpy())
    return same


def test_generate_masks_device_matches_jax(segmentors):
    jseg, pseg = segmentors
    img = _frame(np.random.RandomState(2))
    want = jseg.generate_masks_device(img)
    got = pseg.generate_masks_device(img)
    # the prefix and the NMS truncation are both exercised
    assert pseg.last_prefix == 8 < 64 and pseg.cfg.amg_nms_topk < 3 * pseg.last_prefix
    assert got["masks"].dtype == torch.bool and got["masks"].shape == (8, 48, 64)
    _assert_same_proposals(pseg, img, got, want)
    # distinct kept proposals, not one frame-sized box
    kept = got["boxes"][got["valid"]].numpy()
    assert len(np.unique(kept, axis=0)) >= 3
    assert got["orig_size"] == want["orig_size"] and got["seg_size"] == want["seg_size"]


def test_generate_masks_resizes_like_jax(segmentors):
    """A 60x80 frame: segmented at 48x64, masks resized back to float
    coverage and boxes scaled and clipped."""
    jseg, pseg = segmentors
    img = _frame(np.random.RandomState(3), 60, 80)
    same = _assert_same_proposals(pseg, img, pseg.generate_masks_device(img),
                                  jseg.generate_masks_device(img))
    want = jseg.generate_masks(img)
    got = pseg.generate_masks(img)
    assert got["masks"].shape == (8, 60, 80) and got["masks"].dtype == np.float32
    np.testing.assert_array_equal(got["valid"], want["valid"])
    close(got["masks"][same], want["masks"][same], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["boxes"][same], want["boxes"][same])
    close(got["iou_preds"], want["iou_preds"])


def test_device_size_filter_matches_host():
    rng = np.random.RandomState(4)
    m = rng.rand(16, 30, 40) < rng.rand(16, 1, 1) * 0.01
    boxes = np.sort(rng.rand(16, 2, 2) * 40, axis=1).reshape(16, 4).astype(np.float32)[:, [0, 2, 1, 3]]
    valid = rng.rand(16) < 0.8
    want = port_ism.host_size_filter(m, boxes, valid, 0.05, 3e-4)
    got = port_ism.device_size_filter(tt(m), tt(boxes), tt(valid), 0.05, 3e-4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


@pytest.fixture(scope="module")
def ism_pipes(segmentors):
    jseg, pseg = segmentors
    jcfg, pcfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(5))
    rng = np.random.RandomState(6)
    desc = rng.randn(1, 6, 32).astype(np.float32)
    appe = rng.randn(1, 6, 4, 32).astype(np.float32)
    poses = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(6)]).astype(np.float32)
    jax_pipe = JaxISMPipeline(jcfg, dinov2_variables=variables, segmentor=jseg)
    port = port_ism.ISMPipeline(pcfg, state_dict=sd, device="cpu", segmentor=pseg)
    for p in (jax_pipe, port):
        p.set_reference_data(desc, appe, poses)
    return jax_pipe, port


@pytest.mark.parametrize("size_filters", [False, True])
def test_match_frame_from_the_segmentor_matches_jax(ism_pipes, size_filters):
    """detections=None on a 60x80 frame: the segmentor's proposals resized to
    the frame, optionally size-filtered on the device, then described and
    scored; valid, object ids and templates exactly, the scores at 1e-4."""
    jax_pipe, port = ism_pipes
    rng = np.random.RandomState(7)
    rgb = _frame(rng, 60, 80)
    depth = (rng.rand(60, 80) * 900 + 100).astype(np.float32)
    K = np.array([[75.0, 0, 40.0], [0, 75.0, 30.0], [0, 0, 1]], np.float32)
    cloud = ((rng.rand(64, 3) - 0.5) * 0.05).astype(np.float32)[None]
    kw = dict(detections=None, apply_size_filters=size_filters)
    want = jax_pipe.match_frame(rgb, depth, K, 1.0, cloud, **kw)
    got = port.match_frame(rgb, depth, K, 1.0, cloud, **kw)
    for k in ("valid", "object_ids", "best_template"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() >= 2
    for k in ("masks", "boxes", "semantic_score", "appe_score", "visible_ratio",
              "geometric_score", "scores"):
        close(got[k], want[k])
