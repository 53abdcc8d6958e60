"""The port's counterparts of the JAX package's remaining helpers, each held
to its JAX function on the CPU: indices, masks and counts exactly, floats
within 1e-5 (rtol 1e-5 where values reach tens). The SAM entries
(`_masks_for` with the decoder's `sel_channel`, `truncation_divergence`)
run on the tiny SAM of tests/test_torch_port_sam_slice.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.ops.ball_query import ball_query as jax_ball_query
from sam6d_tpu.ops.ball_query import query_and_group as jax_query_and_group
from sam6d_tpu.ops import embedding as jemb
from sam6d_tpu.ops import masks as jmasks
from sam6d_tpu.ops import pointcloud as jpc
from sam6d_tpu.ops import sampling as jsampling
from sam6d_tpu.render import poses as jposes
from sam6d_torch.ops import ball_query, embedding, masks, pointcloud, sampling
from sam6d_torch.render import poses

from torch_port_common import (close, one_torch_thread,  # noqa: F401 (autouse)
                               separated_cloud, tiny_sam_cfgs, tiny_sam_weights, tt)

FLOAT = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_valid,capacity,num", [(50, 64, 20), (7, 64, 20), (0, 16, 5),
                                                  (64, 64, 64)])
def test_random_choice_fixed_matches_jax_given_its_draws(n_valid, capacity, num):
    key = jax.random.PRNGKey(n_valid + num)
    want = np.asarray(jsampling.random_choice_fixed(key, jnp.asarray(n_valid), capacity, num))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (capacity,))))
    got = sampling.random_choice_fixed(n_valid, capacity, num, u=u)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(0)
    drawn = sampling.random_choice_fixed(n_valid, capacity, num, generator=g)
    assert int(drawn.max()) < max(n_valid, 1)
    if n_valid >= num:
        assert len(set(drawn.tolist())) == num


def test_ball_query_and_query_and_group_match_jax():
    rng = np.random.RandomState(3)
    radius, nsample = 0.3, 6
    xyz = separated_cloud(rng, (2, 40, 3), (radius,))
    new_xyz = xyz[:, :12] + np.float32(0.0)
    feats = rng.randn(2, 40, 5).astype(np.float32)
    want = np.asarray(jax_ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    got = ball_query.ball_query(radius, nsample, tt(xyz), tt(new_xyz))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for f, use_xyz in ((None, True), (feats, True), (feats, False)):
        want = jax_query_and_group(radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz),
                                   None if f is None else jnp.asarray(f), use_xyz=use_xyz)
        got = ball_query.query_and_group(radius, nsample, tt(xyz), tt(new_xyz),
                                         None if f is None else tt(f), use_xyz=use_xyz)
        close(got, want, **FLOAT)


def test_pointcloud_helpers_match_jax():
    rng = np.random.RandomState(4)
    cloud = (rng.randn(60, 3) * 0.1).astype(np.float32)
    valid = rng.rand(60) > 0.3
    center = cloud[valid].mean(axis=0)
    d = np.linalg.norm(cloud - center, axis=1)
    near = np.sort(d[valid])[20:22]
    limit = np.float32(near.mean())            # halfway between two points
    assert np.abs(d - limit).min() > 1e-5
    want = np.asarray(jpc.radius_outlier_mask(jnp.asarray(cloud), jnp.asarray(valid), limit))
    got = pointcloud.radius_outlier_mask(tt(cloud), torch.from_numpy(valid), float(limit))
    np.testing.assert_array_equal(got.numpy(), want)
    clouds = (rng.randn(3, 20, 3)).astype(np.float32)
    vmask = rng.rand(3, 20) > 0.2
    for v in (None, vmask):
        want = jpc.cloud_radius(jnp.asarray(clouds), None if v is None else jnp.asarray(v))
        got = pointcloud.cloud_radius(tt(clouds), None if v is None else torch.from_numpy(v))
        close(got, want, **FLOAT)
    r = np.asarray(want)
    close(pointcloud.normalize_cloud_by_radius(tt(clouds), tt(r)),
          jpc.normalize_cloud_by_radius(jnp.asarray(clouds), jnp.asarray(r)), **FLOAT)


def test_embeddings_match_jax():
    rng = np.random.RandomState(5)
    idx = (rng.rand(2, 7, 9) * 20).astype(np.float32)
    close(embedding.sinusoidal_embedding(tt(idx), 16),
          jemb.sinusoidal_embedding(jnp.asarray(idx), 16), **FLOAT)
    pts = separated_cloud(rng, (2, 12, 3), (0.05,), scale=0.3)
    want_d, want_a = jemb.geometric_embedding_indices(jnp.asarray(pts), 0.2, 15.0, 3)
    got_d, got_a = embedding.geometric_embedding_indices(tt(pts), 0.2, 15.0, 3)
    close(got_d, want_d, **FLOAT)
    close(got_a, want_a, **FLOAT)


def test_mask_iou_matrix_matches_jax():
    m = np.random.RandomState(6).rand(5, 12, 16) > 0.6
    m[4] = False                                    # an empty mask
    close(masks.mask_iou_matrix(torch.from_numpy(m)),
          jmasks.mask_iou_matrix(jnp.asarray(m)), **FLOAT)


def test_pose_helpers_match_jax():
    for level in (0, 1):
        for dist in ("all", "upper"):
            for cam in (False, True):
                np.testing.assert_array_equal(
                    poses.get_obj_poses_from_template_level(level, dist, cam),
                    jposes.get_obj_poses_from_template_level(level, dist, cam))
        np.testing.assert_array_equal(poses.nearest_template_indices(level),
                                      jposes.nearest_template_indices(level))
    mine = poses.template_cam_poses(1)
    perm = np.random.RandomState(7).permutation(len(mine))
    assets = mine[perm] + np.float32(1e-3)
    got = poses.match_pose_order(mine, assets)
    np.testing.assert_array_equal(got, jposes.match_pose_order(mine, assets))
    np.testing.assert_array_equal(got, perm)
    with pytest.raises(ValueError):
        poses.match_pose_order(mine, np.repeat(mine[:1], len(mine), axis=0))


# ------------------------------------------------------------------ SAM

NEAR_LOGIT = 1e-4     # tests/test_torch_port_sam_slice.py's


@pytest.fixture(scope="module")
def segmentors():
    from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    jcfg, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, seed=1, rng=np.random.RandomState(1),
                                     blocky_masks=True)
    return (JaxSAMSegmentor(jcfg, variables=variables),
            SAMSegmentor(pcfg, state_dict=sd, device="cpu"))


def test_masks_for_channel_selected_decode_matches_jax(segmentors):
    from sam6d_torch.pipelines.sam_amg import resize_logits
    jseg, pseg = segmentors
    cfg = pseg.cfg
    g, C = cfg.img_size // cfg.patch_size, cfg.prompt_embed_dim
    rng = np.random.RandomState(8)
    emb = (rng.randn(g, g, C) * 0.5).astype(np.float32)
    hs, ws, h_in, w_in = 48, 64, 48, 64
    K = 2 * cfg.points_per_batch
    pts = (rng.rand(K, 2) * [w_in, h_in]).astype(np.float32)
    ch = rng.randint(0, 3, K).astype(np.int32)
    Ry, Rx, _ = jseg.frame_constants(hs, ws, h_in, w_in)
    want = np.asarray(jseg._masks_for(jseg.vars, jnp.asarray(emb), jnp.asarray(pts),
                                      jnp.asarray(ch), Ry, Rx, hs=hs, ws=ws, h_in=h_in,
                                      w_in=w_in))
    pRy, pRx = tt(Ry), tt(Rx)
    with torch.no_grad():
        got = pseg._masks_for(tt(emb), tt(pts), tt(ch).long(), pRy, pRx)
        # the logits of every channel from the full decode, for the near-zero pixels
        full, _ = pseg._decode_chunk(tt(emb), pseg.sam.prompt_encoder.dense_pe(), tt(pts))
        logits = resize_logits(full, pRy, pRx)[torch.arange(K), tt(ch).long()]
    assert got.shape == (K, hs, ws) and got.dtype == torch.bool
    far = logits.abs() > NEAR_LOGIT
    assert float(far.float().mean()) > 0.99
    np.testing.assert_array_equal(got.numpy()[far.numpy()], want[far.numpy()])
    np.testing.assert_array_equal(got[far].numpy(), (logits > 0)[far].numpy())


def test_truncation_divergence_matches_jax(segmentors):
    jseg, pseg = segmentors
    image = (np.random.RandomState(9).rand(48, 64, 3) * 255).astype(np.uint8)
    want = jseg.truncation_divergence(image)
    got = pseg.truncation_divergence(image)
    assert got == want
    assert got["n_kept_full"] > 0
