"""The port's kernels (FPS, two-scale ball query, the fused attentions) and
the sampling ops around them, on the CPU: the plain PyTorch versions are
held to the JAX XLA path and to the Pallas kernels in interpret mode, with
exact indices (the qkv attention's plain version is held to JAX in
test_torch_port_ism_modules.py), and the CUDA wrappers refuse CPU tensors.
test_torch_cuda_kernels.py holds each CUDA kernel to its plain version on
the card."""
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
from sam6d_torch.kernels import attention, attention_qkv
from sam6d_torch.kernels import ball_query as bq
from sam6d_torch.kernels import fps
from sam6d_torch.ops import sampling
from sam6d_torch.ops.ball_query import group_points

from test_torch_cuda_kernels import (FPS_EDGE_CASES, _fps_case, _fps_edge_case,
                                     factored_state)
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import separated_cloud


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


@pytest.mark.parametrize("case", sorted(FPS_EDGE_CASES))
def test_fps_plain_matches_jax_and_pallas_at_kernel_path_edges(case):
    """The plain version against JAX's XLA loop and the Pallas kernel
    (interpret mode) on the clouds that probe the CUDA kernel's path edges
    (test_torch_cuda_kernels.py holds the kernel to the plain version on
    them)."""
    pts, mask, m = _fps_edge_case(np.random.RandomState(12), case)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jsampling.farthest_point_sample(jnp.asarray(pts), m, jmask))
    pallas = np.asarray(farthest_point_sample_pallas(jnp.asarray(pts), m, jmask,
                                                     interpret=True))
    got = fps.farthest_point_sample(
        torch.from_numpy(pts), m, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if case.startswith("all_invalid"):
        assert (got.numpy() == 0).all()
    if case == "first_valid_in_last_cluster_block":
        assert got[0, 0] == 19500 and (got.numpy() >= 19500).all()
    if case == "tie_across_cluster_blocks":
        assert got[0, 1:3].tolist() == [10, 4000]


@pytest.mark.parametrize("n,path", [
    (1, "block"), (2048, "block"), (4096, "block"), (4097, "cluster"),
    (210000, "cluster"), (229376, "cluster"), (229377, "multi")])
def test_fps_path_follows_n_alone(n, path):
    assert fps.fps_path(n) == path


@pytest.mark.parametrize("B,M,sms,path", [
    (16, 2048, 132, "lanes"), (1, 2048, 132, "warps"), (1, 4193, 132, "lanes"),
    (1, 4192, 132, "warps"), (2, 2112, 132, "lanes"), (2, 2080, 132, "warps"),
    (1, 1, 1, "lanes"), (12, 1000, 132, "lanes")])
def test_ball_query_path_follows_the_shape(B, M, sms, path):
    assert bq.ball_query_path(B, M, sms) == path


def _separated_queries(rng, B, N, M, radii, scale=0.3, margin=1e-5):
    """Candidates (B, N, 3) and other queries (B, M, 3) with no
    (query, candidate) pair within `margin` of any r^2: candidates in such a
    pair are drawn again until none is left."""
    r2 = np.float32(np.asarray(radii, np.float64) ** 2)
    xyz = (rng.randn(B, N, 3) * scale).astype(np.float32)
    q = (rng.randn(B, M, 3) * scale).astype(np.float32)
    while True:
        d2 = ((q.astype(np.float64)[:, :, None] - xyz[:, None]) ** 2).sum(-1)
        near = np.zeros((B, N), bool)
        for r in r2:
            near |= (np.abs(d2 - r) <= margin).any(axis=1)
        if not near.any():
            return xyz, q
        xyz[near] = (rng.randn(int(near.sum()), 3) * scale).astype(np.float32)


@pytest.mark.parametrize("B,N,M,scales", [
    (2, 5000, 96, (0.1, 32, 0.2, 64)),      # N over the kernel's staged chunks
    (1, 5000, 64, (0.02, 64, 0.04, 128)),   # quotas never fill
])
def test_ball_query_plain_matches_jax_and_pallas_on_other_queries(B, N, M, scales):
    """Queries that are not the candidates, at the CUDA kernel's staging
    edge (N > 1024) and with quotas that never fill."""
    r1, s1, r2, s2 = scales
    xyz, q = _separated_queries(np.random.RandomState(9), B, N, M, (r1, r2))
    w1, w2 = jax_two_scale_ball_query(r1, s1, r2, s2, jnp.asarray(xyz), jnp.asarray(q))
    p1, p2 = two_scale_ball_query_pallas(jnp.asarray(xyz), jnp.asarray(q),
                                         r1, s1, r2, s2, block_m=32, interpret=True)
    g1, g2 = bq.two_scale_ball_query(torch.from_numpy(xyz), torch.from_numpy(q),
                                     r1, s1, r2, s2)
    for g, w, p in ((g1, w1, p1), (g2, w2, p2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    if s1 == 64:   # never full: every row ends in its fill
        d2 = ((q[:, :, None].astype(np.float64) - xyz[:, None]) ** 2).sum(-1)
        assert ((d2 < np.float32(r2 * r2)).sum(-1) < s2).all()


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


# ------------------------------------------------------ SAM kernels (K1-K4)

from sam6d_torch.kernels import attention_relpos as relpos  # noqa: E402
from sam6d_torch.kernels import factored  # noqa: E402



def test_sam_cuda_wrappers_refuse_cpu_tensors_and_count_only_launches():
    rng = np.random.RandomState(9)
    st = factored_state(rng, 2, 64, 32, 128, (5, 2), (True, False), True)
    qkv = torch.zeros(1, 9, 3 * 32)
    rh, rw = torch.zeros(5, 8), torch.zeros(5, 8)
    counts = [f.launches for f in (relpos.flash_attention_relpos_cuda,
                                   factored.factored_ln_stats_cuda,
                                   factored.factored_t2i_attention_cuda,
                                   factored.factored_i2t_scores_cuda)]
    with pytest.raises(ValueError):
        relpos.flash_attention_relpos_cuda(qkv, rh, rw, (3, 3), 4)
    with pytest.raises(ValueError):
        factored.factored_ln_stats_cuda(st["blocks"], st["U"], st["S"], st["a"])
    with pytest.raises(ValueError):
        factored.factored_t2i_attention_cuda(st["q"], st["UK"], st["UV"], st["blocks"],
                                             st["a"], st["KS"], st["KC"], st["VS"], 8)
    with pytest.raises(ValueError):
        factored.factored_i2t_scores_cuda(st["q"], st["UK"], st["blocks"], st["a"],
                                          st["KS"], st["KC"], 8)
    relpos.flash_attention_relpos(qkv, rh, rw, (3, 3), 4)         # CPU: plain
    factored.factored_ln_stats(st["blocks"], st["U"], st["S"], st["a"])
    factored.factored_t2i_attention(st["q"], st["UK"], st["UV"], st["blocks"], st["a"],
                                    st["KS"], st["KC"], st["VS"], 8)
    factored.factored_i2t_scores(st["q"], st["UK"], st["blocks"], st["a"], st["KS"],
                                 st["KC"], 8)
    assert counts == [f.launches for f in (relpos.flash_attention_relpos_cuda,
                                           factored.factored_ln_stats_cuda,
                                           factored.factored_t2i_attention_cuda,
                                           factored.factored_i2t_scores_cuda)]


# ------------------------------------------------- head-major attention (K8, K9)

# fp32 scores and softmax summed in another order than the Pallas kernels:
# the JAX package's own kernel tolerance
ATTENTION_ATOL = 2e-5


def _qkv(rng, B, H, Nq, Nk, hd):
    return (rng.randn(B, H, Nq, hd).astype(np.float32) * 0.5,
            rng.randn(B, H, Nk, hd).astype(np.float32) * 0.5,
            rng.randn(B, H, Nk, hd).astype(np.float32))


@pytest.mark.parametrize("B,H,Nq,Nk,hd", [
    (2, 4, 61, 61, 32),         # the JAX kernel test's shape
    (2, 4, 61, 300, 32),        # cross-attention
    (1, 2, 20, 20, 80),         # hd 80
])
def test_fused_attention_plain_matches_pallas(B, H, Nq, Nk, hd):
    from sam6d_tpu.kernels.flash_attention import fused_attention as jax_fused
    q, k, v = _qkv(np.random.RandomState(16), B, H, Nq, Nk, hd)
    want = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                scale=hd ** -0.5, interpret=True))
    got = attention.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTENTION_ATOL, rtol=0)


def test_fused_attention_small_plain_matches_pallas():
    from sam6d_tpu.kernels.flash_attention import fused_attention_small as jax_small
    q, k, v = _qkv(np.random.RandomState(17), 2, 4, 57, 57, 64)
    want = np.asarray(jax_small(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                scale=64 ** -0.5, interpret=True))
    got = attention.fused_attention_small(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), 64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTENTION_ATOL, rtol=0)


def test_vit_attention_above_1024_tokens_matches_jax():
    """use_flash at N = 1025 (DINOv2 at img_size 448) goes to the K8 dispatch
    on the (B, H, N, hd) views of the projection; held to the JAX module's
    XLA path (use_flash off) on shared weights."""
    from sam6d_tpu.models.vit import Attention as JaxAttention
    from sam6d_torch.models.vit import Attention
    rng = np.random.RandomState(18)
    C, H, N = 32, 4, 1025
    x = rng.randn(2, N, C).astype(np.float32)
    net = Attention(C, H, use_flash=True)
    with torch.no_grad():
        for lin in (net.qkv, net.proj):
            lin.weight.copy_(torch.from_numpy(
                rng.randn(*lin.weight.shape).astype(np.float32) * C ** -0.5))
            lin.bias.copy_(torch.from_numpy(rng.randn(*lin.bias.shape).astype(np.float32) * 0.1))
        calls = []
        orig = attention.fused_attention_plain
        attention.fused_attention_plain = lambda *a: calls.append(a) or orig(*a)
        try:
            got = net(torch.from_numpy(x)).numpy()
        finally:
            attention.fused_attention_plain = orig
    assert len(calls) == 1 and calls[0][0].shape == (2, H, N, C // H)
    params = {name: {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                     "bias": jnp.asarray(lin.bias.detach().numpy())}
              for name, lin in (("qkv", net.qkv), ("proj", net.proj))}
    want = np.asarray(JaxAttention(C, H, use_flash=False).apply(
        {"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATTENTION_ATOL, rtol=0)


def test_attention_cuda_wrappers_refuse_cpu_tensors_and_count_only_launches():
    q = torch.zeros(1, 2, 9, 16)
    counts = (attention.fused_attention_cuda.launches,
              attention.fused_attention_small_cuda.launches)
    with pytest.raises(ValueError):
        attention.fused_attention_cuda(q, q, q, 0.25)
    with pytest.raises(ValueError):
        attention.fused_attention_small_cuda(q, q, q, 0.25)
    attention.fused_attention(q, q, q, 0.25)              # CPU: plain versions
    attention.fused_attention_small(q, q, q, 0.25)
    assert counts == (attention.fused_attention_cuda.launches,
                      attention.fused_attention_small_cuda.launches)


# ------------------------------------- three-pass TF32 (K1, K5 on the card)

def _tf32_rna(x):
    """cvt.rna.tf32.f32 in numpy: round to nearest, ties away from zero, to
    10 mantissa bits (the low 13 bits of the float32 cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return ((u & np.uint32(0x80000000)) | mag).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with tf32 operands: one pass (big*big) or three (small*big +
    big*small + big*big, small = rna(x - big)); products summed in float64,
    rounded to float32 once, so only the split's error is modelled."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    terms = [(ab, bb)]
    if passes == 3:
        a_s, b_s = _tf32_rna(a - ab), _tf32_rna(b - bb)
        terms = [(a_s, bb), (ab, b_s), (ab, bb)]
    return sum(x.astype(np.float64) @ y.astype(np.float64) for x, y in terms).astype(np.float32)


def _attention(q, k, v, scale, bias, matmul, tile=None):
    """The kernels' arithmetic: s = (q * scale) k^T + bias, an fp32 softmax,
    (p v) / sum p, the two products by `matmul`. With `tile`, p v is formed
    per tile of that many keys and the tiles' sums are added in float32, as
    the kernels add each tile's tensor-core sum to O on the fp32 units."""
    s = matmul(q * np.float32(scale), k.T) + bias
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    if tile is None:
        pv = matmul(p, v)
    else:
        pv = np.zeros((p.shape[0], v.shape[1]), s.dtype)
        for k0 in range(0, p.shape[1], tile):
            pv += matmul(p[:, k0:k0 + tile], v[k0:k0 + tile])
    return pv / p.sum(-1, keepdims=True)


def _online_attention(s, v, matmul, tile):
    """The fp32 entry of K1's online softmax over key tiles of `tile` keys,
    from its scores s (bias added): per tile the running max m, alpha =
    exp(m_old - m), p = exp(s - m), l = l alpha + sum p, and O = O alpha +
    (p v of the tile, by `matmul`, summed from zero), all in s's dtype."""
    f = s.dtype.type
    m = np.full(s.shape[0], -np.inf, s.dtype)
    l = np.zeros(s.shape[0], s.dtype)
    o = np.zeros((s.shape[0], v.shape[1]), s.dtype)
    for k0 in range(0, s.shape[1], tile):
        st = s[:, k0:k0 + tile]
        m_new = np.maximum(m, st.max(-1))
        alpha = np.exp(m - m_new).astype(s.dtype)
        p = np.exp(st - m_new[:, None]).astype(s.dtype)
        l = l * alpha + p.sum(-1, dtype=s.dtype)
        o = o * alpha[:, None] + matmul(p, v[k0:k0 + tile]).astype(s.dtype)
        m = m_new
    return o / np.maximum(l, f(1e-30))[:, None]


def _k1_global_online_tiles_are_fp32_accurate():
    """K1's fp32 entry at SAM's global grid (64 x 64 = 4096 keys, hd 80, 2
    heads) as the card runs it: S = (q * scale) K^T in three-pass TF32 plus
    the rel-pos bias, the online softmax over 40-key tiles, each tile's P V
    summed from zero in three-pass TF32 and added as O * alpha + O_tile in
    float32. The drift over 103 tiles stays within ATTENTION_ATOL of float64
    at rel-pos std 0.1 and x3, where one TF32 pass does not."""
    rng = np.random.RandomState(20)
    hd, (H, W), heads, tile = 80, (64, 64), 2, 40
    N = H * W
    qkv = rng.randn(1, N, 3 * heads * hd).astype(np.float32)
    q, k, v = qkv[0].reshape(N, 3, heads, hd).transpose(1, 2, 0, 3)
    for rel in (0.1, 0.3):
        rh, rw = (torch.from_numpy(rng.randn(2 * s - 1, hd).astype(np.float32) * np.float32(rel))
                  for s in (H, W))
        th, tw = (t.numpy()[0] for t in relpos.rel_pos_tables(
            torch.from_numpy(qkv), rh, rw, (H, W), heads))
        err = {"tf32x3": 0.0, "tf32": 0.0}
        for i in range(heads):
            bias = (th[i][:, :, None] + tw[i][:, None, :]).reshape(N, N)
            s64 = (q[i].astype(np.float64) * hd ** -0.5) @ k[i].T.astype(np.float64) + bias
            p64 = np.exp(s64 - s64.max(-1, keepdims=True))
            want = (p64 @ v[i].astype(np.float64)) / p64.sum(-1, keepdims=True)
            del s64, p64
            for name, passes in (("tf32x3", 3), ("tf32", 1)):
                def mm(a, b, passes=passes):
                    return _tf32_matmul(a, b, passes)
                s = mm(q[i] * np.float32(hd ** -0.5), k[i].T) + bias
                got = _online_attention(s, v[i], mm, tile)
                err[name] = max(err[name], float(np.abs(got - want).max()))
        # on this draw: 1.1e-6 and 2.1e-6 against 7.8e-4 and 1.2e-3
        assert err["tf32x3"] <= ATTENTION_ATOL, (rel, err)
        assert err["tf32"] > 10 * ATTENTION_ATOL, (rel, err)


@pytest.mark.parametrize("kernel", ["K1", "K5", "K8", "K1-global"])
def test_three_pass_tf32_attention_is_fp32_accurate(kernel):
    """Both products of K1, K5 and K8 run on the tensor cores as three-pass
    TF32. Emulated here per head: the attention lies within ATTENTION_ATOL
    of float64, as fp32 products do, while one TF32 pass does not. K8 at the
    448 describe's 1025 keys (no bias), with P V summed per 32-key tile and
    the tiles added in float32. At qkv x4 the fp32 attention itself is
    beyond ATTENTION_ATOL of float64, which is why the card's stress cases
    scale q and k by 2 (K5, K8) and the bias (K1) instead. K1-global: the
    online tiles of K1's fp32 entry at N = 4096
    (_k1_global_online_tiles_are_fp32_accurate)."""
    if kernel == "K1-global":
        _k1_global_online_tiles_are_fp32_accurate()
        return
    rng = np.random.RandomState(19)
    hd, (H, W) = {"K1": (80, (14, 14)), "K5": (64, (1, 257)), "K8": (64, (1, 1025))}[kernel]
    tile = 32 if kernel == "K8" else None
    N, heads = H * W, 2
    for mag in (1.0, 4.0):
        qkv = rng.randn(1, N, 3 * heads * hd).astype(np.float32) * np.float32(mag)
        if kernel == "K1":
            rh, rw = (torch.from_numpy(rng.randn(2 * s - 1, hd).astype(np.float32) * 0.3)
                      for s in (H, W))
            th, tw = (t.numpy()[0] for t in relpos.rel_pos_tables(
                torch.from_numpy(qkv), rh, rw, (H, W), heads))
            bias = [(th[i][:, :, None] + tw[i][:, None, :]).reshape(N, N) for i in range(heads)]
        else:
            bias = [np.zeros((N, N), np.float32)] * heads
        q, k, v = qkv[0].reshape(N, 3, heads, hd).transpose(1, 2, 0, 3)
        err = {}
        for name, mm in (("tf32x3", lambda a, b: _tf32_matmul(a, b, 3)),
                         ("tf32", lambda a, b: _tf32_matmul(a, b, 1)),
                         ("fp32", np.matmul)):
            err[name] = max(
                np.abs(_attention(q[i], k[i], v[i], hd ** -0.5, bias[i], mm, tile)
                       - _attention(q[i].astype(np.float64), k[i].astype(np.float64),
                                    v[i].astype(np.float64), hd ** -0.5,
                                    bias[i].astype(np.float64), np.matmul)).max()
                for i in range(heads))
        if mag == 1.0:
            assert err["tf32x3"] <= ATTENTION_ATOL and err["fp32"] <= ATTENTION_ATOL
            # over K8's 1025 keys one pass's rounding averages out further
            # (7.6x ATTENTION_ATOL on this draw), so its margin is 5x
            assert err["tf32"] > (5 if kernel == "K8" else 10) * ATTENTION_ATOL
        else:
            assert err["fp32"] > ATTENTION_ATOL


def test_library_name_follows_header_bytes(tmp_path):
    """The kernel library's name hashes the `.cuh` headers with the `.cu`
    sources, so editing a shared header alone rebuilds it."""
    import shutil
    from sam6d_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert _build.library_path(csrc) == _build.library_path()
    header = csrc / "tf32x3.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited = _build.library_path(csrc)
    assert edited != _build.library_path()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(csrc) not in (edited, _build.library_path())


def _ln_stats_emulated(P, U, S, a, mode, eps=1e-6):
    """K2's arithmetic for one prompt: x = P^T U (P (R, N) the scaled factor
    rows, U (R, C)), v = a S + x, then mu = E[v] and 1/sqrt(E[v^2] - mu^2 +
    eps) over the C channels. "tf32x3" / "tf32" form x as the kernel does:
    ranks zero-padded to 8, each k8 step's passes added to a float32 x (the
    tensor cores' accumulator); "fp32" a float32 matmul; "fp64" the
    reference, all in float64."""
    if mode == "fp64":
        x = P.astype(np.float64).T @ U.astype(np.float64)
        v = a.astype(np.float64)[:, None] * S + x
        mu = v.mean(-1)
        return mu, 1.0 / np.sqrt((v * v).mean(-1) - mu * mu + eps)
    if mode == "fp32":
        x = P.T @ U
    else:
        R = P.shape[0]
        Rp = -(-R // 8) * 8
        Pp = np.zeros((Rp, P.shape[1]), np.float32)
        Up = np.zeros((Rp, U.shape[1]), np.float32)
        Pp[:R], Up[:R] = P, U
        pb, ub = _tf32_rna(Pp), _tf32_rna(Up)
        terms = [(pb, ub)]
        if mode == "tf32x3":
            terms = [(_tf32_rna(Pp - pb), ub), (pb, _tf32_rna(Up - ub)), (pb, ub)]
        x = np.zeros((P.shape[1], U.shape[1]), np.float32)
        for k0 in range(0, Rp, 8):
            for pa, ua in terms:
                x = (x + pa[k0:k0 + 8].T.astype(np.float64)
                     @ ua[k0:k0 + 8].astype(np.float64)).astype(np.float32)
    v = (a.astype(np.float64)[:, None] * S + x).astype(np.float32)  # fmaf
    C = np.float32(U.shape[1])
    mu = v.sum(-1, dtype=np.float32) / C
    var = (v * v).sum(-1, dtype=np.float32) / C - mu * mu
    return mu, np.float32(1.0) / np.sqrt(var + np.float32(eps))


@pytest.mark.parametrize("ranks,scaled", [
    ((57,), (True,)),                     # layer 1's rank
    ((57, 2, 57), (True, False, False)),  # layer 2's rank, 116
])
def test_three_pass_tf32_ln_stats_is_fp32_accurate(ranks, scaled):
    """K2 forms each prompt's x tile as a three-pass TF32 product of the
    P_eff tile and U. Emulated here on the factored state's distributions:
    mu and 1/sigma lie within 1e-6 of float64, as with a float32 product,
    while one TF32 pass is at least 100x worse (~1e-4, FACTORED_ATOL's
    size, on mu); and the emulation agrees with factored_ln_stats_plain within the card's
    tolerances."""
    from test_torch_cuda_kernels import FACTORED_ATOL, LN_INV_RTOL
    st = factored_state(np.random.RandomState(20), 2, 320, 256, 128, ranks, scaled, True)
    P = factored.blocks_concat(st["blocks"]).numpy()
    U, S, a = st["U"].numpy(), st["S"].numpy(), st["a"].numpy()
    mu_p, inv_p = (t.numpy() for t in factored.factored_ln_stats_plain(
        st["blocks"], st["U"], st["S"], st["a"]))
    for i in range(len(P)):
        mu64, inv64 = _ln_stats_emulated(P[i], U[i], S, a[i], "fp64")
        err = {}
        for mode in ("tf32x3", "tf32", "fp32"):
            mu, inv = _ln_stats_emulated(P[i], U[i], S, a[i], mode)
            err[mode] = (np.abs(mu - mu64).max(), (np.abs(inv - inv64) / inv64).max())
        for mode in ("tf32x3", "fp32"):
            assert max(err[mode]) <= 1e-6, (mode, err[mode])
        assert err["tf32"][0] >= 100 * err["tf32x3"][0], err
        assert err["tf32"][1] >= 100 * err["tf32x3"][1], err
        mu, inv = _ln_stats_emulated(P[i], U[i], S, a[i], "tf32x3")
        assert np.abs(mu - mu_p[i]).max() <= FACTORED_ATOL
        assert (np.abs(inv - inv_p[i]) / inv_p[i]).max() <= LN_INV_RTOL


def _scores_emulated(k, U, P, a, S, C, mode):
    """One head's scores (N, T) of the factored operands as K3 and K4 sum
    them: k (T, hd) the head's tokens, U (R, hd), P (R, N) the scaled factor
    rows, a (N,) or None, S/C (N, hd): a (S k^T) + C k^T + P^T (U k^T).
    "tf32x3" / "tf32" as the kernels' tensor cores: the head-score term
    (a S + C) k^T (a S + C one fmaf) in two k8 steps of channels (4t + 2kk,
    4t + 2kk + 1), then the rank term P^T T1 (T1 = U k^T in float32) in k8
    steps of ranks zero-padded to 8, each step's passes added to a float32
    score (the tensor cores' accumulator); "fp32" float32 matmuls; "fp64"
    all in float64."""
    T = k.shape[0]
    N = S.shape[0]
    av = np.ones(N) if a is None else a.astype(np.float64)
    if mode == "fp64":
        k64 = k.astype(np.float64)
        s = av[:, None] * (S @ k64.T) + C @ k64.T
        if len(P):
            s = s + P.astype(np.float64).T @ (U.astype(np.float64) @ k64.T)
        return s
    if mode == "fp32":
        s = (a[:, None] if a is not None else np.float32(1)) * (S @ k.T) + C @ k.T
        return s + P.T @ (U @ k.T) if len(P) else s
    aq = (av[:, None] * S + C).astype(np.float32)
    t1 = (U.astype(np.float64) @ k.T).astype(np.float32) if len(P) \
        else np.zeros((0, T), np.float32)
    R = len(P)
    Rp = -(-R // 8) * 8
    Pp = np.zeros((Rp, P.shape[1] if R else N), np.float32)
    Tp = np.zeros((Rp, T), np.float32)
    Pp[:R], Tp[:R] = P, t1
    steps = [(aq[:, c], k[:, c].T) for c in
             ([0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15])]
    steps += [(Pp[r0:r0 + 8].T, Tp[r0:r0 + 8]) for r0 in range(0, Rp, 8)]
    s = np.zeros((N, T), np.float32)
    for x, y in steps:
        xb, yb = _tf32_rna(x), _tf32_rna(y)
        passes = [(xb, yb)]
        if mode == "tf32x3":
            passes = [(_tf32_rna(x - xb), yb), (xb, _tf32_rna(y - yb)), (xb, yb)]
        for u, v in passes:
            s = (s + u.astype(np.float64) @ v.astype(np.float64)).astype(np.float32)
    return s


def _i2t_emulated(kt, UQ, P, a, QS, QC, mode, heads=8):
    """K4's score tile and softmax for one prompt: kt (T, d) token keys, UQ
    (R, d), P (R, N) the scaled factor rows, a (N,) or None, QS/QC (N, d).
    Returns the probabilities (heads*T, N), row h*T + t: each head's scores
    as `_scores_emulated` sums them in `mode`, the softmax over the T tokens
    in float32 (float64 for "fp64")."""
    T, d = kt.shape
    hd = d // heads
    out = []
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = _scores_emulated(kt[:, sl], UQ[:, sl], P, a, QS[:, sl], QC[:, sl], mode)
        e = np.exp(s - s.max(-1, keepdims=True))
        if mode == "fp64":
            out.append((e / e.sum(-1, keepdims=True)).T)
        else:
            out.append((e * (np.float32(1) / e.sum(-1, keepdims=True))).T)
    return np.concatenate(out, axis=0)


@pytest.mark.parametrize("ranks,scaled,with_a", [
    ((), (), False),                   # layer 1's launch: rank 0, no a
    ((57, 2), (True, False), True),    # layer 2's launch: rank 59
])
def test_three_pass_tf32_i2t_scores_are_fp32_accurate(ranks, scaled, with_a):
    """K4 sums each head's scores on the tensor cores in three-pass TF32:
    the head-score term, then the rank term in k8 steps. Emulated here on
    the factored state's distributions, its probabilities lie within 1e-6 of
    float64, as with float32 products, while one TF32 pass is at least 100x
    worse (~1e-4 to 5e-4: FACTORED_ATOL's size); and they agree with
    factored_i2t_scores_plain within FACTORED_ATOL."""
    from test_torch_cuda_kernels import FACTORED_ATOL
    st = factored_state(np.random.RandomState(21), 2, 320, 256, 128, ranks, scaled, with_a)
    kt, UQ, QS, QC = (st[k].numpy() for k in ("q", "UK", "KS", "KC"))
    a = None if st["a"] is None else st["a"].numpy()
    P = factored.blocks_concat(st["blocks"]).numpy() if ranks else np.zeros((2, 0, 320))
    want = factored.factored_i2t_scores_plain(st["q"], st["UK"] if ranks else None,
                                              st["blocks"], st["a"], st["KS"], st["KC"],
                                              8).numpy()
    for i in range(2):
        ai = None if a is None else a[i]
        p64 = _i2t_emulated(kt[i], UQ[i], P[i], ai, QS, QC, "fp64")
        err = {m: np.abs(_i2t_emulated(kt[i], UQ[i], P[i], ai, QS, QC, m) - p64).max()
               for m in ("tf32x3", "tf32", "fp32")}
        assert err["tf32x3"] <= 1e-6 and err["fp32"] <= 1e-6, err
        assert err["tf32"] >= 100 * err["tf32x3"], err
        got = _i2t_emulated(kt[i], UQ[i], P[i], ai, QS, QC, "tf32x3")
        assert np.abs(got - want[i, :-1]).max() <= FACTORED_ATOL
        assert (want[i, -1] == 1).all()


def _t2i_emulated(q, UK, UV, P, a, KS, KC, VS, mode, heads=8, tile=64, chunks=8):
    """K3 for one prompt: q (T, d) pre-scaled queries, UK/UV (R, d), P (R, N)
    the scaled factor rows, a (N,), KS/KC/VS (N, d); returns the head-diagonal
    output (T, d). Each head's scores as `_scores_emulated` sums them in
    `mode`; then, in float32, K3's online softmax over its position chunks
    (`chunks` chunks of whole `tile`-position tiles, as the kernel cuts them):
    per tile the running max m, the rescale exp(m_old - m_new), the sum l,
    the value part p (a VS) and T2 = p P^T; then the merge of the chunks'
    partials, with one empty chunk (m = -inf) added, weighted 0:
    (sum w acc + (sum w T2) UV) / sum w l, w = exp(m - max m). "fp64": the
    exact softmax attention in float64."""
    T, d = q.shape
    hd, N, R = d // heads, KS.shape[0], len(P)
    f = np.float64 if mode == "fp64" else np.float32
    out = np.zeros((T, d), f)
    tiles = -(-N // tile)
    per = -(-tiles // chunks)
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = _scores_emulated(q[:, sl], UK[:, sl], P, a, KS[:, sl], KC[:, sl], mode)
        av = a.astype(f)[:, None] * VS[:, sl].astype(f)
        if mode == "fp64":
            e = np.exp(s - s.max(0))
            p = e / e.sum(0)
            out[:, sl] = p.T @ av + (p.T @ P.T.astype(f)) @ UV[:, sl].astype(f)
            continue
        parts = []
        for c0 in range(0, N, per * tile):
            m, l = np.full(T, -np.inf, f), np.zeros(T, f)
            acc, t2 = np.zeros((T, hd), f), np.zeros((T, R), f)
            for n0 in range(c0, min(N, c0 + per * tile), tile):
                st = s[n0:n0 + tile]
                mx = np.maximum(m, st.max(0))
                corr = np.exp(m - mx)
                e = np.exp(st - mx)
                l = l * corr + e.sum(0)
                acc = acc * corr[:, None] + e.T @ av[n0:n0 + tile]
                t2 = t2 * corr[:, None] + e.T @ P[:, n0:n0 + tile].T
                m = mx
            parts.append((m, l, acc, t2))
        parts.append((np.full(T, -np.inf, f), np.zeros(T, f), np.zeros((T, hd), f),
                      np.zeros((T, R), f)))
        M = np.max([m for m, _, _, _ in parts], axis=0)
        w = [np.where(m == -np.inf, f(0), np.exp(m - M)) for m, _, _, _ in parts]
        L = sum(wc * l for wc, (_, l, _, _) in zip(w, parts))
        o = sum(wc[:, None] * acc for wc, (_, _, acc, _) in zip(w, parts))
        o = o + sum(wc[:, None] * t2 for wc, (_, _, _, t2) in zip(w, parts)) @ UV[:, sl]
        out[:, sl] = o / L[:, None]
    return out


@pytest.mark.parametrize("ranks,scaled", [
    ((57, 2), (True, False)),                           # layer 2's launch: rank 59
    ((57, 2, 57, 2), (True, True, True, False)),        # the final attention: rank 118
])
def test_three_pass_tf32_t2i_attention_is_fp32_accurate(ranks, scaled):
    """K3 sums each head's scores on the tensor cores in three-pass TF32 and
    takes the softmax over positions online, per chunk of 64-position
    tiles, merging the chunks' partials. Emulated here at N = 1000 (8
    chunks of two tiles, the last one ragged): its output lies within 1e-6
    of float64 relative to the output's largest magnitude (~2e-6 absolute
    on outputs up to ~6), as with float32 products, while one TF32 pass is
    at least 100x worse; an empty chunk (m = -inf) weighs 0; and the
    emulation agrees with factored_t2i_attention_plain within
    FACTORED_ATOL."""
    from test_torch_cuda_kernels import FACTORED_ATOL
    st = factored_state(np.random.RandomState(22), 2, 1000, 256, 128, ranks, scaled, True)
    q, UK, UV, a, KS, KC, VS = (st[k].numpy() for k in ("q", "UK", "UV", "a", "KS", "KC", "VS"))
    P = factored.blocks_concat(st["blocks"]).numpy()
    want = factored.factored_t2i_attention_plain(st["q"], st["UK"], st["UV"], st["blocks"],
                                                 st["a"], st["KS"], st["KC"], st["VS"],
                                                 8).numpy()
    for i in range(2):
        args = (q[i], UK[i], UV[i], P[i], a[i], KS, KC, VS)
        ref = _t2i_emulated(*args, "fp64")
        scale = np.abs(ref).max()
        err = {m: np.abs(_t2i_emulated(*args, m) - ref).max() / scale
               for m in ("tf32x3", "tf32", "fp32")}
        assert err["tf32x3"] <= 1e-6 and err["fp32"] <= 1e-6, err
        assert err["tf32"] >= 100 * err["tf32x3"], err
        got = _t2i_emulated(*args, "tf32x3")
        assert np.isfinite(got).all()
        assert np.abs(got - want[i]).max() <= FACTORED_ATOL
