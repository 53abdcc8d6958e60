"""The modules of the port's ISM matching slice against the JAX package on
the CPU, on seeded numpy inputs: the fused-attention plain version (K5)
against the Pallas kernel in interpret mode and the einsum path, the crops
(bit-exact), box IoU, NMS, the depth means, DINOv2, the four scores and the
DINOv2 weights bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.kernels.flash_attention import fused_attention_qkv as jax_fused_attention_qkv
from sam6d_tpu.models import dinov2 as jdino
from sam6d_tpu.models import ism_scoring as jscore
from sam6d_tpu.ops import images as jimages
from sam6d_tpu.ops import masks as jmasks
from sam6d_tpu.ops import pointcloud as jpc
from sam6d_tpu.weights.convert_dinov2 import convert_dinov2_state_dict
from sam6d_torch.kernels import attention_qkv
from sam6d_torch.models import dinov2, ism_scoring
from sam6d_torch.ops import images, masks, pointcloud
from sam6d_torch.weights.dinov2 import (dinov2_state_dict_from_flax,
                                        load_reference_checkpoint,
                                        random_dinov2_state_dict)

from torch_port_common import close, tiny_dinov2_weights, tiny_ism_cfgs, tt


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("B,heads,N,hd", [(3, 4, 17, 64), (2, 4, 257, 64),
                                          (2, 4, 17, 8)])
def test_fused_attention_qkv_plain_matches_pallas_and_einsum(B, heads, N, hd):
    """atol 2e-5, the tolerance of the JAX package's own kernel test."""
    rng = np.random.RandomState(0)
    C = heads * hd
    scale = hd ** -0.5
    qkv = rng.randn(B, N, 3 * C).astype(np.float32) * 0.5
    got = attention_qkv.fused_attention_qkv(torch.from_numpy(qkv), heads, scale)
    assert got.shape == (B, N, C)
    pallas = jax_fused_attention_qkv(jnp.asarray(qkv), heads, scale=scale,
                                     interpret=True)
    close(got, pallas, atol=2e-5, rtol=0)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, heads, hd) for i in range(3))
    s = jnp.einsum("bnhd,bmhd->bhnm", q, k) / jnp.sqrt(hd).astype(jnp.float32)
    want = jnp.einsum("bhnm,bmhd->bnhd", jax.nn.softmax(s, axis=-1), v).reshape(B, N, C)
    close(got, want, atol=2e-5, rtol=0)


# ------------------------------------------------------------------ crops


def _boxes(rng, H, W, n):
    """Random boxes, plus sizes whose scale 224 / size lands floors on
    integer boundaries (sizes dividing 224, squares, 1-pixel sides)."""
    special = [(0, 0, 7, 7), (3, 5, 59, 61), (10, 2, 38, 30), (0, 0, W, H),
               (5, 5, 6, 40), (20, 1, 21, 2), (1, 1, 113, 57), (2, 9, 34, 41),
               (7, 3, 82, 3 + 75), (0, 0, 3, 96)]
    x1 = rng.randint(0, W - 2, n)
    y1 = rng.randint(0, H - 2, n)
    x2 = np.minimum(x1 + rng.randint(1, W, n), W)
    y2 = np.minimum(y1 + rng.randint(1, H, n), H)
    rand = np.stack([x1, y1, x2, y2], 1)
    return np.concatenate([np.array(special), rand]).astype(np.float32)


def test_crops_equal_jax_bit_for_bit():
    rng = np.random.RandomState(1)
    H, W = 120, 160
    img = rng.rand(H, W, 3).astype(np.float32)
    boxes = _boxes(rng, H, W, 40)
    m = (rng.rand(len(boxes), H, W) > 0.5).astype(np.float32)
    for target in (224, 28):
        got = images.crop_resize_pad_nearest(tt(img), tt(boxes), target)
        want = jimages.crop_resize_pad_nearest(jnp.asarray(img), jnp.asarray(boxes), target)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        gc, gm = images.masked_crop_resize_pad_nearest(tt(img), tt(m), tt(boxes), target)
        wc, wm = jimages.masked_crop_resize_pad_nearest(
            jnp.asarray(img), jnp.asarray(m), jnp.asarray(boxes), target)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_floor_helpers_equal_jax_at_every_scale():
    """The exact floors over every box side 1..480 and every destination
    index: the boundary cases torch's double-precision floors decide."""
    sizes = np.arange(1, 481, dtype=np.float32)
    scale = np.float32(224.0) / sizes
    got_mul = images._floor_mul_f32(tt(sizes), tt(scale))
    want_mul = jimages._floor_mul_f32(jnp.asarray(sizes), jnp.asarray(scale))
    np.testing.assert_array_equal(got_mul.numpy(), np.asarray(want_mul))
    dst = np.arange(224, dtype=np.float32)[None, :].repeat(len(sizes), 0)
    got_div = images._floor_div_f32(tt(dst), tt(scale[:, None]))
    want_div = jimages._floor_div_f32(jnp.asarray(dst), jnp.asarray(scale[:, None]))
    np.testing.assert_array_equal(got_div.numpy(), np.asarray(want_div))
    exact = np.floor(dst / scale[:, None].astype(np.float64))
    np.testing.assert_array_equal(got_div.numpy(), exact)


def test_stacked_crops_and_normalize_match_jax():
    rng = np.random.RandomState(2)
    imgs = rng.rand(5, 40, 32, 3).astype(np.float32)
    boxes = _boxes(rng, 40, 32, 5)[-5:]
    got = images.crop_resize_pad_nearest_stack(tt(imgs), tt(boxes), 28)
    for i in range(5):
        want = jimages.crop_resize_pad_nearest(jnp.asarray(imgs[i]),
                                               jnp.asarray(boxes[i:i + 1]), 28)[0]
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    close(images.normalize_imagenet(tt(imgs)),
          jimages.normalize_imagenet(jnp.asarray(imgs)), atol=1e-6, rtol=0)


# --------------------------------------------------------- masks, depth


def test_box_iou_matches_jax():
    rng = np.random.RandomState(3)
    a = _boxes(rng, 48, 64, 12)
    b = _boxes(rng, 48, 64, 7)
    b[0] = b[0, [2, 3, 0, 1]]                     # inverted box: area 0
    close(masks.box_iou(tt(a), tt(b)), jmasks.box_iou(jnp.asarray(a), jnp.asarray(b)),
          atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_masked_keep_set_equals_jax_and_greedy(seed):
    rng = np.random.RandomState(seed)
    N = 40
    boxes = _boxes(rng, 48, 64, N)[:N]
    scores = np.round(rng.rand(N), 1).astype(np.float32)   # ties
    valid = rng.rand(N) > 0.2
    group = rng.randint(0, 3, N)
    same = group[:, None] == group[None, :]
    iou = np.asarray(jmasks.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    keep, rounds = masks.nms_masked_rounds(tt(iou), tt(scores), tt(valid),
                                           tt(same), 0.25)
    want = np.asarray(jmasks.nms_masked(jnp.asarray(iou), jnp.asarray(scores),
                                        jnp.asarray(valid), jnp.asarray(same), 0.25))
    np.testing.assert_array_equal(keep.numpy(), want)
    # sequential greedy NMS in stable score order
    greedy = np.zeros(N, bool)
    for i in sorted(np.flatnonzero(valid), key=lambda i: (-scores[i], i)):
        greedy[i] = not any(greedy[j] and same[i, j] and iou[i, j] > 0.25
                            for j in range(N))
    np.testing.assert_array_equal(keep.numpy(), greedy)
    assert 1 <= rounds <= N
    assert torch.equal(masks.nms_masked(tt(iou), tt(scores), tt(valid), tt(same), 0.25),
                       keep)


def test_depth_means_match_jax():
    rng = np.random.RandomState(4)
    H, W = 48, 64
    depth = (rng.rand(H, W) * 900 + 100).astype(np.float32)
    depth[rng.rand(H, W) < 0.2] = 0.0
    m = (rng.rand(6, H, W) > 0.6).astype(np.float32)
    m[1] *= 0.5                                  # fractional mask
    m[2] = 0.0                                   # empty mask
    K = np.array([[60.0, 0, 32.5], [0, 61.0, 24.2], [0, 0, 1]], np.float32)
    got = pointcloud.masked_depth_mean_translation(tt(m), tt(depth), tt(K),
                                                   torch.tensor(np.float32(1.5)))
    want = jpc.masked_depth_mean_translation(jnp.asarray(m), jnp.asarray(depth),
                                             jnp.asarray(K), jnp.float32(1.5))
    close(got, want, atol=1e-5, rtol=1e-5)
    close(pointcloud.depth_to_pointcloud(tt(depth / 1000), tt(K)),
          jpc.depth_to_pointcloud(jnp.asarray(depth / 1000), jnp.asarray(K)),
          atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ DINOv2


@pytest.fixture(scope="module")
def dino():
    _, cfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(cfg, rng=np.random.RandomState(5))
    d = cfg.dinov2
    dims = (d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads)
    jmod = jdino.DINOv2(*dims)
    return cfg, sd, variables, dims, jmod


def test_dinov2_matches_jax_folded_and_unfolded(dino):
    """cls and patch at 1e-4 against JAX; the folded kernel-path model equals
    the unfolded one at 2e-5 (the JAX package's own fold tolerance)."""
    cfg, sd, variables, dims, jmod = dino
    x = np.random.RandomState(6).rand(3, 28, 28, 3).astype(np.float32)
    want_cls, want_patch = jmod.apply(variables, jnp.asarray(x))
    plain = dinov2.DINOv2(*dims)
    plain.load_state_dict(sd)
    folded = dinov2.DINOv2(*dims, use_flash=True, ln_folded=True)
    folded.load_state_dict(dinov2.fold_ln_affine(sd))
    assert not any(".norm1." in k for k in folded.state_dict())
    with torch.no_grad():
        cls, patch = plain(tt(x))
        fcls, fpatch = folded(tt(x))
    close(cls, want_cls)
    close(patch, want_patch)
    close(fcls, cls.numpy(), atol=2e-5, rtol=0)
    close(fpatch, patch.numpy(), atol=2e-5, rtol=0)
    jf = jdino.fold_ln_affine(variables)
    jcls, _ = jdino.DINOv2(*dims, ln_folded=True).apply(jf, jnp.asarray(x))
    close(fcls, jcls)


def test_masked_patch_descriptors_match_jax():
    rng = np.random.RandomState(7)
    tokens = rng.randn(3, 16, 8).astype(np.float32)
    m = (rng.rand(3, 56, 56) > 0.4).astype(np.float32)
    m[0] = 0.0
    close(dinov2.masked_patch_descriptors(tt(tokens), tt(m), 14),
          jdino.masked_patch_descriptors(jnp.asarray(tokens), jnp.asarray(m), 14),
          atol=1e-5, rtol=0)


# ------------------------------------------------------------------ scores


def _score_inputs(rng, P=10, O=3, T=7, Np=9, C=16):
    q_patch = rng.randn(P, Np, C).astype(np.float32)
    q_patch[:, ::3] = 0.0                       # masked-out patches
    q_patch /= np.maximum(np.linalg.norm(q_patch, axis=-1, keepdims=True), 1e-12)
    r_patch = rng.randn(P, Np, C).astype(np.float32)
    r_patch /= np.linalg.norm(r_patch, axis=-1, keepdims=True)
    return dict(q_cls=rng.randn(P, C).astype(np.float32),
                r_cls=rng.randn(O, T, C).astype(np.float32) + 0.5,
                valid=rng.rand(P) > 0.3, q_patch=q_patch, r_patch=r_patch)


@pytest.mark.parametrize("agg", ["avg_5", "mean", "max", "median"])
def test_semantic_scores_match_jax(agg):
    x = _score_inputs(np.random.RandomState(8))
    got = ism_scoring.semantic_scores(tt(x["q_cls"]), tt(x["r_cls"]), tt(x["valid"]),
                                      agg, 0.2)
    want = jscore.semantic_scores(jnp.asarray(x["q_cls"]), jnp.asarray(x["r_cls"]),
                                  jnp.asarray(x["valid"]), agg, 0.2)
    close(got["score"], want["score"])
    for k in ("object_idx", "best_template", "selected"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_appearance_visible_and_final_scores_match_jax():
    x = _score_inputs(np.random.RandomState(9))
    args_t = (tt(x["q_patch"]), tt(x["r_patch"]))
    args_j = (jnp.asarray(x["q_patch"]), jnp.asarray(x["r_patch"]))
    appe = ism_scoring.appearance_scores(*args_t)
    close(appe, jscore.appearance_scores(*args_j))
    vis = ism_scoring.visible_ratio(*args_t, 0.3)
    close(vis, jscore.visible_ratio(*args_j, 0.3))
    rng = np.random.RandomState(10)
    sem, geo = rng.rand(2, 10).astype(np.float32)
    close(ism_scoring.final_scores(tt(sem), appe, tt(geo), vis),
          jscore.final_scores(sem, np.asarray(appe), geo, np.asarray(vis)))


def test_geometric_scores_match_jax():
    rng = np.random.RandomState(11)
    P, H, W = 6, 48, 64
    boxes = _boxes(rng, H, W, P)[-P:]
    m = (rng.rand(P, H, W) > 0.5).astype(np.float32)
    depth = (rng.rand(H, W) * 900 + 500).astype(np.float32)
    K = np.array([[60.0, 0, 32.3], [0, 60.7, 24.1], [0, 0, 1]], np.float32)
    R = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(P)]).astype(np.float32)
    pts = (rng.rand(P, 50, 3).astype(np.float32) - 0.5) * 0.1
    got = ism_scoring.geometric_scores(tt(boxes), tt(m), tt(depth), tt(K),
                                       torch.tensor(np.float32(1.0)), tt(R), tt(pts))
    want = jscore.geometric_scores(jnp.asarray(boxes), jnp.asarray(m), jnp.asarray(depth),
                                   jnp.asarray(K), jnp.float32(1.0), jnp.asarray(R),
                                   jnp.asarray(pts))
    close(got, want)
    t = rng.rand(P, 3).astype(np.float32) * 0.1 + np.float32([0, 0, 0.8])
    np.testing.assert_array_equal(
        ism_scoring.project_points_to_boxes(tt(pts), tt(R), tt(t), tt(K), (H, W)).numpy(),
        np.asarray(jscore.project_points_to_boxes(jnp.asarray(pts), jnp.asarray(R),
                                                  jnp.asarray(t), jnp.asarray(K), (H, W))))


# ------------------------------------------------------------------ weights


def test_state_dict_round_trips_through_the_jax_converter(dino):
    cfg, sd, variables, _, _ = dino
    back = dinov2_state_dict_from_flax(variables)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def test_load_reference_checkpoint_interpolates_a_37x37_pos_embed(tmp_path):
    """A synthetic 518-input checkpoint (37x37 grid, plus a mask_token the
    port has no module for) into a 224-input net: the pos_embed equals the
    JAX converter's bicubic interpolation."""
    net = dinov2.DINOv2(224, 14, 32, 1, 4)
    sd = random_dinov2_state_dict(net, 3)
    rng = np.random.RandomState(12)
    sd["pos_embed"] = torch.from_numpy(rng.randn(1, 1 + 37 * 37, 32).astype(np.float32))
    sd["mask_token"] = torch.zeros(1, 32)
    path = str(tmp_path / "dinov2.pth")
    torch.save(sd, path)
    extra = load_reference_checkpoint(path, net)
    assert extra == ["mask_token"]
    want = convert_dinov2_state_dict({k: v.numpy() for k, v in sd.items()},
                                     depth=1, target_grid=16)["params"]["pos_embed"]
    np.testing.assert_array_equal(net.pos_embed.detach().numpy(), want)
    np.testing.assert_array_equal(net.blocks[0].attn.qkv.weight.detach().numpy(),
                                  sd["blocks.0.attn.qkv.weight"].numpy())


def test_crop_scale_is_the_quotient_jax_takes_not_torch_rdiv():
    """The crop scale is the correctly rounded float32 quotient, as in the
    JAX package. The reference writes it as `target / tensor`, which torch
    evaluates as target * (1 / side): for some box sides the two differ in
    the last place (logged in ROADMAP Queue 3)."""
    sides = torch.arange(2, 481, dtype=torch.float32)
    quotient = np.float32(224.0) / sides.numpy()
    rdiv = (224.0 / sides).numpy()
    assert (rdiv != quotient).sum() > 0
    # w x (w - 1) boxes: the stage-1 width floor(w * scale) is the number of
    # columns inside the crop, which reads the port's scale back
    boxes = torch.stack([torch.zeros_like(sides), torch.zeros_like(sides),
                         sides, sides - 1], dim=1)
    _, _, inside = images._source_indices(boxes, 480, 480, 224)
    w1 = inside.any(dim=1).sum(dim=1).numpy()
    want = np.floor(sides.numpy().astype(np.float64) * quotient.astype(np.float64))
    np.testing.assert_array_equal(w1, want)
    assert (np.floor(sides.numpy().astype(np.float64) * rdiv.astype(np.float64))
            != want).any()
