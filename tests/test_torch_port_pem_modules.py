"""The port's PEM modules held to the JAX package's fp32 path on the CPU:
the same seeded numpy inputs and the same weights in both packages
(torch_port_common.jax_variables). Tolerance: atol = rtol = 1e-4 (ATOL/RTOL in
torch_port_common) unless a test states otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.ops import geometry as jgeo
from sam6d_tpu.ops.embedding import sinusoid_phase_tables as jax_phase_tables
from sam6d_tpu.pose import solvers as jsolvers
from sam6d_tpu.weights.convert_pem import convert_pem_state_dict
from sam6d_torch.models.coarse_matching import cosine_similarity_matrix
from sam6d_torch.models.pem import PEMNet
from sam6d_torch.models.vit import sample_pixel_feats
from sam6d_torch.ops import geometry as geo
from sam6d_torch.ops.embedding import pairwise_planar_diffs, sinusoid_phase_tables
from sam6d_torch.pose import solvers
from sam6d_torch.weights.pem import (load_reference_checkpoint,
                                     pem_state_dict_from_flax,
                                     random_pem_state_dict)

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import (close, jax_variables, separated_cloud,
                               tiny_cfg, torch_net, tt)


@pytest.fixture(scope="module")
def nets():
    cfg = tiny_cfg()
    jnet, variables = jax_variables(cfg)
    return cfg, jnet, variables, torch_net(cfg, variables)


def _apply(jnet, variables, fn, *args):
    return jnet.apply(variables, *[jnp.asarray(a) for a in args], method=fn)


# ------------------------------------------------------------------ geometry

def _random_rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def test_pairwise_sq_distance_and_transforms_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 30, 3).astype(np.float32)
    y = rng.randn(2, 20, 3).astype(np.float32)
    close(geo.pairwise_sq_distance(tt(x), tt(y)),
          jgeo.pairwise_sq_distance(jnp.asarray(x), jnp.asarray(y)), atol=1e-5)
    R = _random_rotations(rng, 2)
    t = rng.randn(2, 3).astype(np.float32)
    close(geo.transform_points(tt(x), tt(R), tt(t)),
          jgeo.transform_points(jnp.asarray(x), jnp.asarray(R), jnp.asarray(t)), atol=1e-5)
    close(geo.inverse_transform_points(tt(x), tt(R), tt(t)),
          jgeo.inverse_transform_points(jnp.asarray(x), jnp.asarray(R), jnp.asarray(t)),
          atol=1e-5)


def test_svd3x3_and_symeig_match_jax_and_torch_linalg():
    """Singular values come from the eigenvalues of H^T H, so the smallest
    carries an error of ~sqrt(eps) |H| (atol 1e-3 on S and on the
    reconstruction U S V^T)."""
    rng = np.random.RandomState(2)
    H = rng.randn(500, 3, 3).astype(np.float32)
    H[:5, :, 2] = 0.0                            # rank-deficient cases
    U, S, V = geo.svd3x3(tt(H))
    Uj, Sj, Vj = jgeo.svd3x3(jnp.asarray(H))
    close(S, Sj, atol=1e-3)
    close(U, Uj, atol=1e-4)
    close(V, Vj, atol=1e-4)
    S_ref = torch.linalg.svdvals(tt(H).double()).float()
    close(S, S_ref.numpy(), atol=1e-3)
    close(U @ torch.diag_embed(S) @ V.transpose(-1, -2), H, atol=1e-3)
    A = H @ H.transpose(0, 2, 1)
    w, v = geo.symeig3x3(tt(A))
    wj, vj = jgeo.symeig3x3(jnp.asarray(A))
    close(w, wj, atol=1e-4)
    close(w, torch.linalg.eigvalsh(tt(A).double()).float().numpy(), atol=1e-4)
    close(v, vj, atol=1e-4)


def test_weighted_procrustes_matches_jax_and_recovers_pose():
    rng = np.random.RandomState(3)
    src = rng.randn(4, 50, 3).astype(np.float32)
    R = _random_rotations(rng, 4)
    t = rng.randn(4, 3).astype(np.float32)
    ref = src @ R.transpose(0, 2, 1) + t[:, None] + 0.01 * rng.randn(4, 50, 3).astype(np.float32)
    w = rng.rand(4, 50).astype(np.float32)
    Rg, tg = geo.weighted_procrustes(tt(src), tt(ref), tt(w), weight_thresh=0.1)
    Rj, tj = jgeo.weighted_procrustes(jnp.asarray(src), jnp.asarray(ref),
                                      jnp.asarray(w), weight_thresh=0.1)
    close(Rg, Rj)
    close(tg, tj)
    close(Rg, R, atol=1e-2)


# ----------------------------------------------------------------- embedding

def test_phase_tables_and_planar_diffs_match_jax():
    for d, scale in ((32, 1.0), (256, 5.0), (256, 180.0 / (15.0 * np.pi))):
        a, b = sinusoid_phase_tables(d, scale)
        ja, jb = jax_phase_tables(d, scale)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    p = np.random.RandomState(4).randn(2, 9, 3).astype(np.float32)
    ax, ay, az = pairwise_planar_diffs(tt(p))
    np.testing.assert_array_equal(ax.numpy(), p[:, None, :, 0] - p[:, :, None, 0])
    np.testing.assert_array_equal(az.numpy(), p[:, None, :, 2] - p[:, :, None, 2])


# -------------------------------------------------------------------- models

def test_vit_encoder_and_pixel_sampling_match_jax(nets):
    cfg, jnet, v, net = nets
    rng = np.random.RandomState(5)
    S = cfg.img_size
    rgb = rng.randn(3, S, S, 3).astype(np.float32)
    choose = rng.randint(0, S * S, (3, 50))
    with torch.no_grad():
        fmap, cls = net.feature_extraction(tt(rgb), full_res=False)
        fmap_full, _ = net.feature_extraction(tt(rgb), full_res=True)
        feats = net.extract_img_feats(tt(rgb), tt(choose))
    jfmap, jcls = _apply(jnet, v, lambda m, x: m.feature_extraction(x, full_res=False), rgb)
    jfull, _ = _apply(jnet, v, lambda m, x: m.feature_extraction(x, full_res=True), rgb)
    close(fmap, jfmap)
    close(cls, jcls)
    close(fmap_full, jfull)
    close(feats, _apply(jnet, v, "extract_img_feats", rgb, choose))
    # the fused sampler equals resize-then-gather of the full map
    flat = fmap_full.reshape(3, S * S, -1)
    gathered = torch.gather(flat, 1, tt(choose).long()[..., None].expand(-1, -1, flat.shape[-1]))
    close(sample_pixel_feats(fmap, tt(choose), (S, S)), gathered.numpy())


def test_geometric_structure_embedding_matches_jax(nets):
    cfg, jnet, v, net = nets
    rng = np.random.RandomState(6)
    pts = rng.randn(2, cfg.coarse_npoint, 3).astype(np.float32) * 0.3
    pts = np.concatenate([np.full((2, 1, 3), 100.0, np.float32), pts], axis=1)
    with torch.no_grad():
        got = net.geo_embedding(tt(pts))
    close(got, _apply(jnet, v, lambda m, p: m.geo_embedding(p), pts))


def test_coarse_matching_matches_jax(nets):
    cfg, jnet, v, net = nets
    rng = np.random.RandomState(7)
    B, N, C = 2, cfg.coarse_npoint, cfg.coarse.input_dim
    f1 = rng.randn(B, N, C).astype(np.float32)
    f2 = rng.randn(B, N, C).astype(np.float32)
    g1 = rng.randn(B, N + 1, N + 1, cfg.geo_embedding.hidden_dim).astype(np.float32)
    g2 = rng.randn(B, N + 1, N + 1, cfg.geo_embedding.hidden_dim).astype(np.float32)
    with torch.no_grad():
        got = net.coarse_point_matching(tt(f1), tt(g1), tt(f2), tt(g2), all_blocks=True)
        shared = net.coarse_point_matching(tt(f1), tt(g1), tt(f2[:1]), tt(g2[:1]))
    want = _apply(jnet, v, lambda m, *a: m.coarse_point_matching(*a, all_blocks=True),
                  f1, g1, f2, g2)
    assert len(got) == len(want) == cfg.coarse.nblock
    for g, w in zip(got, want):
        close(g, w, atol=3e-4)
    # a batch-1 template side (the onboarding cache) is shared by every item
    want1 = _apply(jnet, v, lambda m, *a: m.coarse_point_matching(*a),
                   f1, g1, np.repeat(f2[:1], B, 0), np.repeat(g2[:1], B, 0))
    close(shared[-1], want1[-1], atol=3e-4)


def test_positional_encoding_and_fine_matching_match_jax(nets):
    cfg, jnet, v, net = nets
    rng = np.random.RandomState(8)
    B, N, S = 2, cfg.fine_npoint, cfg.coarse_npoint
    f = cfg.fine
    pts = separated_cloud(rng, (B, N, 3), (f.pe_radius1, f.pe_radius2), scale=0.3)
    with torch.no_grad():
        pe = net.template_pe(tt(pts))
    close(pe, _apply(jnet, v, "template_pe", pts))

    C = f.hidden_dim
    args = (rng.randn(B, N, C).astype(np.float32), rng.randn(B, N, C).astype(np.float32),
            rng.randn(B, S + 1, S + 1, C).astype(np.float32),
            rng.randint(0, N, (B, S)).astype(np.int32),
            rng.randn(B, N, C).astype(np.float32), rng.randn(B, N, C).astype(np.float32),
            rng.randn(B, S + 1, S + 1, C).astype(np.float32),
            rng.randint(0, N, (B, S)).astype(np.int32))
    with torch.no_grad():
        got = net.fine_point_matching(*[tt(a) for a in args], all_blocks=True)
    want = _apply(jnet, v, lambda m, *a: m.fine_point_matching(*a, all_blocks=True), *args)
    assert len(got) == len(want) == f.nblock
    for g, w in zip(got, want):
        close(g, w, atol=3e-4)


# ------------------------------------------------------------------- solvers

def test_compute_fine_Rt_matches_jax():
    rng = np.random.RandomState(9)
    B, N1, N2 = 2, 60, 70
    atten = (rng.randn(B, N1 + 1, N2 + 1) * 3).astype(np.float32)
    pts1 = rng.randn(B, N1, 3).astype(np.float32) * 0.3
    pts2 = rng.randn(B, N2, 3).astype(np.float32) * 0.3
    model = rng.randn(B, 40, 3).astype(np.float32) * 0.3
    got = solvers.compute_fine_Rt(tt(atten), tt(pts1), tt(pts2), tt(model))
    want = jsolvers.compute_fine_Rt(jnp.asarray(atten), jnp.asarray(pts1),
                                    jnp.asarray(pts2), jnp.asarray(model))
    for g, w in zip(got, want):
        close(g, w)


def test_compute_coarse_Rt_recovers_a_known_pose_like_jax():
    """The samplers' random numbers cannot match across frameworks, so both
    must recover the same known pose from a sharp one-to-one attention."""
    rng = np.random.RandomState(10)
    B, N = 2, 24
    pts2 = rng.randn(B, N, 3).astype(np.float32) * 0.3
    R = _random_rotations(rng, B)
    t = rng.randn(B, 3).astype(np.float32) * 0.1
    pts1 = pts2 @ R.transpose(0, 2, 1) + t[:, None]
    atten = np.full((B, N + 1, N + 1), -5.0, np.float32)
    atten[:, np.arange(1, N + 1), np.arange(1, N + 1)] = 5.0
    model = pts2
    Rg, tg = solvers.compute_coarse_Rt(tt(atten), tt(pts1), tt(pts2), tt(model),
                                       600, 50, generator=torch.Generator().manual_seed(0))
    Rj, tj = jsolvers.compute_coarse_Rt(jax.random.PRNGKey(0), jnp.asarray(atten),
                                        jnp.asarray(pts1), jnp.asarray(pts2),
                                        jnp.asarray(model), 600, 50)
    for Rx, tx in ((Rg.numpy(), tg.numpy()), (np.asarray(Rj), np.asarray(tj))):
        np.testing.assert_allclose(Rx, R, atol=1e-3)
        np.testing.assert_allclose(tx, t, atol=1e-3)


def test_soft_assignment_and_cosine_similarity_match_jax():
    rng = np.random.RandomState(11)
    atten = rng.randn(2, 9, 12).astype(np.float32)
    for g, w in zip(solvers.soft_assignment(tt(atten)),
                    jsolvers.soft_assignment(jnp.asarray(atten))):
        close(g, w, atol=1e-6)
    from sam6d_tpu.models.coarse_matching import cosine_similarity_matrix as jcos
    a, b = rng.randn(2, 5, 8).astype(np.float32), rng.randn(2, 7, 8).astype(np.float32)
    close(cosine_similarity_matrix(tt(a), tt(b), 0.1), jcos(jnp.asarray(a), jnp.asarray(b), 0.1))


# ------------------------------------------------------------------- weights

def test_state_dict_round_trips_through_the_jax_converter():
    cfg = tiny_cfg()
    net = PEMNet(cfg)
    sd = random_pem_state_dict(net, seed=3)
    flax_vars = convert_pem_state_dict(
        {k: v.numpy() for k, v in sd.items()}, vit_depth=cfg.vit.depth,
        coarse_nblock=cfg.coarse.nblock, fine_nblock=cfg.fine.nblock)
    back = pem_state_dict_from_flax(flax_vars)
    assert set(back) == set(sd) == set(net.state_dict())
    for k in sd:
        assert back[k].shape == sd[k].shape, k
        assert torch.equal(back[k].to(sd[k].dtype), sd[k]), k


def test_load_reference_checkpoint(tmp_path):
    cfg = tiny_cfg()
    src = PEMNet(cfg)
    sd = random_pem_state_dict(src, seed=4)
    extra = {"feature_extraction.rgb_net.vit.head.weight": torch.zeros(2, 2)}
    path = tmp_path / "pem.pth"
    torch.save({"model": {**sd, **extra}}, path)
    net = PEMNet(cfg)
    assert load_reference_checkpoint(str(path), net) == sorted(extra)
    for k, t in net.state_dict().items():
        assert torch.equal(t, sd[k]), k
    torch.save({"model": {k: t for k, t in sd.items() if "geo_embedding" not in k}}, path)
    with pytest.raises(KeyError):
        load_reference_checkpoint(str(path), PEMNet(cfg))
