"""The SAM AMG options the reference operating point leaves off, ported
with the JAX package's host code, against the JAX package on the CPU: the
crop cascade's boxes and its cross-crop merge (`generate_crop_boxes`,
`_host_greedy_nms`, including ties among crops of one area), the
small-region cleanup (`remove_small_regions`, `postprocess_small_regions`,
on the JAX package's own cases and a seeded one), and tiny SAM's
`generate_masks` with the cascade (`crop_n_layers=1`,
`crop_n_points_downscale_factor=2`) and with `min_mask_region_area > 0`.

Tolerances: crop boxes, merge order, cleaned masks, boxes and keep flags
exact; predicted IoUs atol = rtol = 1e-4; the cascade's float mask
coverage atol 1e-5 (bilinear matrices applied in another order)."""
import dataclasses

import numpy as np
import pytest

from sam6d_tpu.ops import masks as jax_masks
from sam6d_tpu.pipelines import sam_amg as jax_amg
from sam6d_torch.data import regions
from sam6d_torch.pipelines import sam_amg
from sam6d_torch.pipelines.sam_amg import SAMSegmentor

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, tiny_sam_cfgs, tiny_sam_weights

COVERAGE_ATOL = 1e-5


@pytest.mark.parametrize("size,layers,ratio", [
    ((48, 64), 1, 512 / 1500), ((480, 640), 1, 512 / 1500), ((480, 640), 2, 512 / 1500),
    ((61, 97), 3, 0.25), ((97, 61), 2, 0.0), ((1, 5), 1, 512 / 1500)])
def test_crop_boxes_equal_jax(size, layers, ratio):
    got = sam_amg.generate_crop_boxes(size, layers, ratio)
    assert got == jax_amg.generate_crop_boxes(size, layers, ratio)
    boxes, idx = got
    assert len(boxes) == sum(4 ** i for i in range(layers + 1))
    assert boxes[0] == [0, 0, size[1], size[0]] and idx[0] == 0


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.7])
def test_host_greedy_nms_equals_jax_under_area_ties(thresh):
    """Scores 1 / crop area as the cascade forms them: every crop of one
    layer has one area, so most scores tie and np.argsort's order among
    them decides the merge."""
    rng = np.random.RandomState(0)
    n = 60
    xy = rng.rand(n, 2).astype(np.float32) * 50
    wh = rng.rand(n, 2).astype(np.float32) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], axis=1)
    boxes[10] = boxes[3]                       # an exact duplicate
    areas = rng.choice([3072.0, 1280.0, 1280.0, 320.0], n)
    scores = 1.0 / areas.astype(np.float32)
    got = sam_amg._host_greedy_nms(boxes, scores, thresh)
    want = jax_amg._host_greedy_nms(boxes, scores, thresh)
    assert [int(i) for i in got] == [int(i) for i in want]
    assert len(got) < n or thresh >= 0.7


def test_remove_small_regions_jax_cases():
    """tests/test_data_and_masks.py's holes-and-islands case, run through
    both packages."""
    m = np.zeros((20, 20), bool)
    m[2:18, 2:18] = True
    m[8:10, 8:10] = False
    m[0, 19] = True
    for mod in (regions, jax_masks):
        out, changed = mod.remove_small_regions(m, 6, "holes")
        assert changed and out[8:10, 8:10].all()
        out2, changed2 = mod.remove_small_regions(out, 6, "islands")
        assert changed2 and not out2[0, 19] and out2[2:18, 2:18].all()
        assert not mod.remove_small_regions(out2, 1, "islands")[1]
    for mode in ("holes", "islands"):
        for area in (1, 6, 500):
            g, gc = regions.remove_small_regions(m, area, mode)
            w, wc = jax_masks.remove_small_regions(m, area, mode)
            assert gc == wc
            np.testing.assert_array_equal(g, w)


def test_postprocess_small_regions_jax_case():
    """tests/test_data_and_masks.py's duplicate case: the hole is filled,
    the duplicate loses to the unchanged mask."""
    H = W = 24
    clean = np.zeros((H, W), np.float32)
    clean[4:20, 4:20] = 1
    dirty = clean.copy()
    dirty[10, 10] = 0
    masks = np.stack([dirty, clean, np.zeros((H, W), np.float32)])
    valid = np.array([True, True, False])
    got = regions.postprocess_small_regions(masks, valid, 4, 0.7)
    want = jax_masks.postprocess_small_regions(masks, valid, 4, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2][1] and not got[2][0] and not got[2][2] and got[0][0, 10, 10] == 1
    assert (got[1][1] == np.array([4, 4, 20, 20])).all()


def test_postprocess_small_regions_seeded_equals_jax():
    """Blobs with holes, islands and near-duplicates, some slots invalid."""
    rng = np.random.RandomState(1)
    K, H, W = 12, 32, 40
    masks = np.zeros((K, H, W), np.float32)
    for k in range(K):
        y0, x0 = rng.randint(0, H - 10), rng.randint(0, W - 10)
        masks[k, y0:y0 + rng.randint(6, H - y0), x0:x0 + rng.randint(6, W - x0)] = 1
        masks[k][rng.rand(H, W) < 0.04] = 1 - masks[k][rng.rand(H, W) < 0.04][0]
        masks[k][rng.rand(H, W) < 0.03] = 0
    masks[5] = masks[4]
    masks[5, 0, 0] = 1 - masks[5, 0, 0]
    valid = rng.rand(K) < 0.8
    for area in (3, 10):
        got = regions.postprocess_small_regions(masks, valid, area, 0.7)
        want = jax_masks.postprocess_small_regions(masks, valid, area, 0.7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[0] != masks).any() and got[2].sum() < valid.sum()


@pytest.fixture(scope="module")
def sam_weights():
    jcfg, pcfg = tiny_sam_cfgs()
    return tiny_sam_weights(pcfg, seed=1, rng=np.random.RandomState(1), blocky_masks=True)


def _segmentors(sam_weights, **kw):
    from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
    jcfg, pcfg = tiny_sam_cfgs(**kw)
    variables, sd = sam_weights
    return (JaxSAMSegmentor(jcfg, variables=variables),
            SAMSegmentor(pcfg, state_dict=sd, device="cpu"))


def _assert_same(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    close(got["iou_preds"], want["iou_preds"])
    close(got["masks"], want["masks"], atol=COVERAGE_ATOL, rtol=0)


def test_crop_cascade_equals_jax(sam_weights):
    """crop_n_layers=1 on a 48x64 frame: the full image at 8x8 points and
    four 32x40 crops at 4x4, merged across crops: the same slots, boxes,
    IoUs and mask coverage as JAX; boxes inside the frame, invalid slots
    empty (tests/test_ism_pipeline.py::test_crop_cascade_amg's contract)."""
    jseg, pseg = _segmentors(sam_weights, crop_n_layers=1, crop_n_points_downscale_factor=2,
                             max_proposals=16)
    img = (np.random.RandomState(2).rand(48, 64, 3) * 255).astype(np.uint8)
    got = pseg.generate_masks(img)
    want = jseg.generate_masks(img)
    _assert_same(got, want)
    assert got["masks"].shape == (16, 48, 64)
    v = got["valid"]
    assert v.sum() >= 2
    b = got["boxes"][v]
    assert (b >= 0).all() and (b[:, [0, 2]] <= 64).all() and (b[:, [1, 3]] <= 48).all()
    assert np.abs(got["masks"][~v]).sum() == 0 and not got["boxes"][~v].any()


@pytest.mark.parametrize("area", [300, 1200])
def test_min_mask_region_area_equals_jax(sam_weights, area):
    """The small-region cleanup and its re-NMS in generate_masks, on a
    60x80 frame (segmented at 48x64, masks resized back). The tiny SAM's
    masks are unions of 16x16-pixel blocks, so the areas are a block and a
    few blocks."""
    jseg, pseg = _segmentors(sam_weights, min_mask_region_area=area)
    img = (np.random.RandomState(3).rand(60, 80, 3) * 255).astype(np.uint8)
    got = pseg.generate_masks(img)
    want = jseg.generate_masks(img)
    _assert_same(got, want)
    plain = dataclasses.replace(pseg.cfg, min_mask_region_area=0)
    base = SAMSegmentor(plain, state_dict=pseg.sam.state_dict(), device="cpu").generate_masks(img)
    # the cleanup changed something: a mask, or a slot dropped by the re-NMS
    assert (got["masks"] != base["masks"]).any() or (got["valid"] != base["valid"]).any()


def test_device_path_ignores_the_host_options(sam_weights):
    """generate_masks_device (and so match_frame(detections=None)) runs
    neither option, as in the JAX package."""
    _, pseg = _segmentors(sam_weights, crop_n_layers=1, min_mask_region_area=40)
    _, plain = _segmentors(sam_weights)
    img = (np.random.RandomState(4).rand(48, 64, 3) * 255).astype(np.uint8)
    a, b = pseg.generate_masks_device(img), plain.generate_masks_device(img)
    for k in ("masks", "boxes", "valid", "iou_preds"):
        assert (a[k] == b[k]).all(), k
