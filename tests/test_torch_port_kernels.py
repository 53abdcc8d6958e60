"""The port's kernels (FPS, two-scale ball query, fused attention off the qkv
projection) and the sampling ops around them. On the CPU the plain PyTorch
versions are held to the JAX XLA path and to the Pallas kernels in interpret
mode, with exact indices (the attention's plain version is held to JAX in
test_torch_port_ism_modules.py). The `cuda` tests hold each CUDA kernel to
its plain version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.kernels.ball_query import two_scale_ball_query_pallas
from sam6d_tpu.kernels.fps import farthest_point_sample_pallas
from sam6d_tpu.ops.ball_query import first_k_hits as jax_first_k_hits
from sam6d_tpu.ops.ball_query import group_points as jax_group_points
from sam6d_tpu.ops.ball_query import two_scale_ball_query as jax_two_scale_ball_query
from sam6d_tpu.ops import sampling as jsampling
from sam6d_torch.kernels import attention_qkv
from sam6d_torch.kernels import ball_query as bq
from sam6d_torch.kernels import fps
from sam6d_torch.ops import sampling
from sam6d_torch.ops.ball_query import group_points

from torch_port_common import separated_cloud


def _fps_case(rng, case):
    """(points (B, N, 3), valid mask or None, npoint)."""
    if case == "plain":
        return rng.randn(2, 100, 3).astype(np.float32), None, 16
    if case == "valid_mask":
        pts = rng.randn(2, 64, 3).astype(np.float32)
        pts[:, 40:] += 100.0
        mask = np.zeros((2, 64), bool)
        mask[0, :40] = True
        mask[1, 5:40] = True          # first valid index is not 0
        return pts, mask, 12
    if case == "padded_n":
        return rng.randn(1, 77, 3).astype(np.float32), None, 8
    # duplicates: sampling with replacement repeats points exactly, so
    # equal distances (ties) occur and must go to the lowest index
    base = rng.randn(30, 3).astype(np.float32)
    return base[rng.randint(0, 30, (3, 90))], None, 40


@pytest.mark.parametrize("case", ["plain", "valid_mask", "padded_n", "duplicates"])
def test_fps_plain_matches_jax_and_pallas(case):
    pts, mask, m = _fps_case(np.random.RandomState(1), case)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jsampling.farthest_point_sample(jnp.asarray(pts), m, jmask))
    pallas = np.asarray(farthest_point_sample_pallas(jnp.asarray(pts), m, jmask,
                                                     interpret=True))
    got = fps.farthest_point_sample(
        torch.from_numpy(pts), m, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if mask is not None:
        assert mask[np.arange(len(mask))[:, None], got.numpy()].all()


@pytest.mark.parametrize("shape,scales", [
    ((2, 80, 64), (0.2, 4, 0.4, 8)),      # distinct query / candidate sets
    ((2, 64, 64), (0.1, 8, 0.2, 16)),     # PE radii, queries = candidates
])
def test_ball_query_plain_matches_jax_and_pallas(shape, scales):
    B, N, M = shape
    r1, s1, r2, s2 = scales
    rng = np.random.RandomState(2)
    allp = separated_cloud(rng, (B, N + M if M != N else N, 3), (r1, r2))
    xyz = allp[:, :N]
    new_xyz = allp[:, N:] if M != N else xyz
    w1, w2 = jax_two_scale_ball_query(r1, s1, r2, s2, jnp.asarray(xyz),
                                      jnp.asarray(new_xyz))
    p1, p2 = two_scale_ball_query_pallas(jnp.asarray(xyz), jnp.asarray(new_xyz),
                                         r1, s1, r2, s2, block_m=32,
                                         interpret=True)
    g1, g2 = bq.two_scale_ball_query(torch.from_numpy(xyz),
                                     torch.from_numpy(new_xyz), r1, s1, r2, s2)
    for g, w, p in ((g1, w1, p1), (g2, w2, p2)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


def test_first_k_hits_and_group_points_match_jax():
    rng = np.random.RandomState(3)
    hit = rng.rand(3, 5, 40) < 0.15
    hit[0, 0] = False                     # no hit at all
    hit[1, 1] = True                      # more hits than slots
    np.testing.assert_array_equal(
        bq.first_k_hits(torch.from_numpy(hit), 8).numpy(),
        np.asarray(jax_first_k_hits(jnp.asarray(hit), 8)))
    feats = rng.randn(2, 30, 7).astype(np.float32)
    idx = rng.randint(0, 30, (2, 11, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_group_points(jnp.asarray(feats), jnp.asarray(idx))))


def test_multinomial_is_searchsorted_left_given_u():
    rng = np.random.RandomState(4)
    w = rng.rand(3, 500).astype(np.float32) ** 4
    w[:, 100:150] = 0.0                   # empty stretch: equal CDF values
    u = rng.rand(3, 2000).astype(np.float32)
    u[0, :5] = 0.0
    got = sampling.multinomial_from_weights(torch.from_numpy(w), 2000,
                                            u=torch.from_numpy(u)).numpy()
    cdf = sampling.normalized_cdf(torch.from_numpy(w)).numpy()
    want = np.stack([np.minimum(np.searchsorted(c, uu, side="left"), 499)
                     for c, uu in zip(cdf, u)])
    np.testing.assert_array_equal(got, want)


def test_multinomial_matches_jax_on_exact_cdf():
    """Integer weights make every cumulative sum exact, so both frameworks
    hold the same CDF; fed JAX's uniforms, the port picks the same indices."""
    rng = np.random.RandomState(5)
    w = rng.randint(0, 9, (2, 700)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsampling.multinomial_from_weights(key, jnp.asarray(w), 300))
    u = np.asarray(jax.random.uniform(key, (2, 300), dtype=jnp.float32))
    got = sampling.multinomial_from_weights(torch.from_numpy(w), 300,
                                            u=torch.from_numpy(u.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_multinomial_generator_is_deterministic():
    w = torch.rand(2, 50, generator=torch.Generator().manual_seed(0))
    a = sampling.multinomial_from_weights(w, 64, generator=torch.Generator().manual_seed(3))
    b = sampling.multinomial_from_weights(w, 64, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 64) and int(a.max()) < 50


def test_cuda_wrappers_refuse_cpu_tensors_and_count_only_launches():
    pts = torch.zeros(1, 8, 3)
    n_fps = fps.farthest_point_sample_cuda.launches
    n_bq = bq.two_scale_ball_query_cuda.launches
    with pytest.raises(ValueError):
        fps.farthest_point_sample_cuda(pts, 4)
    with pytest.raises(ValueError):
        bq.two_scale_ball_query_cuda(pts, pts, 0.1, 2, 0.2, 4)
    qkv = torch.zeros(1, 5, 3 * 64)
    n_att = attention_qkv.fused_attention_qkv_cuda.launches
    with pytest.raises(ValueError):
        attention_qkv.fused_attention_qkv_cuda(qkv, 1, 0.125)
    fps.farthest_point_sample(pts, 4)          # CPU: plain version
    bq.two_scale_ball_query(pts, pts, 0.1, 2, 0.2, 4)
    attention_qkv.fused_attention_qkv(qkv, 1, 0.125)
    assert fps.farthest_point_sample_cuda.launches == n_fps
    assert bq.two_scale_ball_query_cuda.launches == n_bq
    assert attention_qkv.fused_attention_qkv_cuda.launches == n_att


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "valid_mask", "padded_n", "duplicates"])
def test_fps_kernel_matches_plain_small(cuda_device, case):
    pts, mask, m = _fps_case(np.random.RandomState(1), case)
    p = torch.from_numpy(pts).to(cuda_device)
    vm = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    got = fps.farthest_point_sample_cuda(p, m, vm)
    want = fps.farthest_point_sample_plain(p, m, vm)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M", [(16, 2048, 196), (1, 2048, 196),
                                   (1, 210000, 2048), (2, 9000, 64)])
def test_fps_kernel_matches_plain_main_path_shapes(cuda_device, B, N, M):
    """Single-block path (N <= 8192) and multi-block path (larger N), with
    duplicated points as template sampling with replacement makes them."""
    rng = np.random.RandomState(6)
    base = rng.randn(max(N // 3, 1), 3).astype(np.float32)
    pts = torch.from_numpy(base[rng.randint(0, len(base), (B, N))]).to(cuda_device)
    mask = torch.from_numpy(rng.rand(B, N) < 0.9).to(cuda_device)
    for vm in (None, mask):
        assert torch.equal(fps.farthest_point_sample_cuda(pts, M, vm),
                           fps.farthest_point_sample_plain(pts, M, vm))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,scales", [
    (16, 2048, 2048, (0.1, 32, 0.2, 64)),
    (2, 300, 77, (0.2, 4, 0.4, 8)),
    (1, 50, 50, (0.01, 32, 0.02, 64)),    # mostly empty: tail rule
])
def test_ball_query_kernel_matches_plain(cuda_device, B, N, M, scales):
    r1, s1, r2, s2 = scales
    rng = np.random.RandomState(7)
    xyz = torch.from_numpy(rng.randn(B, N, 3).astype(np.float32) * 0.3).to(cuda_device)
    q = xyz[:, :M].contiguous()
    from sam6d_torch.ops.geometry import pairwise_sq_distance
    d2 = pairwise_sq_distance(q, xyz)
    for g, w, r in zip(bq.two_scale_ball_query_cuda(xyz, q, *scales),
                       bq.two_scale_ball_query_plain(xyz, q, *scales), (r1, r2)):
        near = ((d2 - float(np.float32(r * r))).abs() < 1e-6).any(dim=-1)
        assert not ((g != w).any(dim=-1) & ~near).any()


# fp32 scores and online softmax in another order than the plain matmul +
# softmax: the tolerance of the JAX package's own kernel test
ATTENTION_ATOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,hd", [
    (16, 257, 16, 64),      # DINOv2-L, one describe chunk
    (3, 257, 16, 64),       # ragged batch
    (2, 128, 4, 64),        # N a multiple of both tiles
    (2, 17, 4, 32),         # hd 32, N below one tile
])
def test_fused_attention_qkv_kernel_matches_plain(cuda_device, B, N, heads, hd):
    rng = np.random.RandomState(8)
    qkv = torch.from_numpy(rng.randn(B, N, 3 * heads * hd).astype(np.float32)).to(cuda_device)
    got = attention_qkv.fused_attention_qkv_cuda(qkv, heads, hd ** -0.5)
    want = attention_qkv.fused_attention_qkv_plain(qkv, heads, hd ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTENTION_ATOL


@pytest.mark.cuda
def test_fused_attention_qkv_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 9, 3 * 4 * 48, device=cuda_device)      # hd 48
    with pytest.raises(ValueError):
        attention_qkv.fused_attention_qkv_cuda(qkv, 4, 0.1)
    with pytest.raises(ValueError):
        attention_qkv.fused_attention_qkv_cuda(qkv.double(), 6, 0.1)
