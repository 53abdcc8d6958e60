"""The port's CUDA kernels held to their plain PyTorch versions on the card
(every test is marked `cuda` and skips without a GPU): FPS, two-scale ball
query (also at the training shapes, on inputs that carry autograd
history), the fused attentions (K5 off the qkv projection, K8 and K9 on
head-major operands), SAM's rel-pos attention (K1) and the factored AMG
kernels (K2-K4), and the bf16 entries of K1, K5, K8, K9 and K2-K4 against
the plain versions of their bf16 contract. The file imports torch, numpy,
pytest and sam6d_torch only, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from sam6d_torch.kernels import attention, attention_qkv
from sam6d_torch.kernels import attention_relpos as relpos
from sam6d_torch.kernels import ball_query as bq
from sam6d_torch.kernels import factored, fps
from sam6d_torch.ops.geometry import pairwise_sq_distance

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


# Edges of the kernel's paths (csrc/fps.cu): the block path holds 8 points a
# thread at N = 2048 (256 threads); the cluster path splits N over 16 blocks
# of ceil(N / 16) points (1250 at N = 20000, so block 15 starts at 18750)
FPS_EDGE_CASES = {
    # name: (B, N, npoint, path the kernel takes)
    "ragged_block": (3, 2047, 100, "block"),
    "ragged_cluster": (2, 20001, 64, "cluster"),
    "all_invalid_block": (2, 1000, 8, "block"),
    "all_invalid_cluster": (1, 20000, 8, "cluster"),
    "first_valid_in_last_cluster_block": (1, 20000, 32, "cluster"),
    "tie_across_cluster_blocks": (1, 20000, 8, "cluster"),
    "block_capacity": (1, 4096, 32, "block"),
    "cluster_floor": (1, 4097, 32, "cluster"),
    "cluster_capacity": (1, 229376, 8, "cluster"),
    "multi_floor": (1, 229377, 8, "multi"),
}


def _fps_edge_case(rng, case):
    """(points (B, N, 3), valid mask or None, npoint) of FPS_EDGE_CASES."""
    B, N, m, _ = FPS_EDGE_CASES[case]
    pts = (rng.randn(B, N, 3) * 0.1).astype(np.float32)
    mask = None
    if case == "ragged_block":
        # duplicated points (ties) and a mask, on a ragged last thread
        pts = pts[:, rng.randint(0, N // 3, N)][0][None].repeat(B, 0)
        mask = rng.rand(B, N) < 0.9
    elif case.startswith("all_invalid"):
        mask = np.zeros((B, N), bool)
    elif case == "first_valid_in_last_cluster_block":
        mask = np.zeros((B, N), bool)
        mask[:, 19500:] = True
    elif case == "tie_across_cluster_blocks":
        # equal scores in blocks 0 and 15, then in blocks 3 and 8: the lower
        # index must win each tie
        pts[:, [10, 19990]] = 50.0
        pts[:, [4000, 11000]] = -5.0
    return pts, mask, m


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
    """Block path (N <= 4096) and cluster path (larger N, the onboarding
    cloud of 210 000 points among them), with duplicated points as template
    sampling with replacement makes them."""
    rng = np.random.RandomState(6)
    base = rng.randn(max(N // 3, 1), 3).astype(np.float32)
    pts = torch.from_numpy(base[rng.randint(0, len(base), (B, N))]).to(cuda_device)
    mask = torch.from_numpy(rng.rand(B, N) < 0.9).to(cuda_device)
    for vm in (None, mask):
        assert torch.equal(fps.farthest_point_sample_cuda(pts, M, vm),
                           fps.farthest_point_sample_plain(pts, M, vm))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FPS_EDGE_CASES))
def test_fps_kernel_matches_plain_at_path_edges(cuda_device, case):
    """Each path of the kernel at its edges, exact: a ragged last thread or
    cluster block, all-invalid clouds, the first valid index in the
    cluster's last block, ties across cluster blocks, and N at the block
    and cluster capacities and one past them."""
    pts, mask, m = _fps_edge_case(np.random.RandomState(12), case)
    assert fps.fps_path(pts.shape[1]) == FPS_EDGE_CASES[case][3]
    p = torch.from_numpy(pts).to(cuda_device)
    vm = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    got = fps.farthest_point_sample_cuda(p, m, vm)
    want = fps.farthest_point_sample_plain(p, m, vm)
    assert torch.equal(got, want)
    if case == "tie_across_cluster_blocks":
        assert got[0, 1:3].tolist() == [10, 4000]


@pytest.mark.cuda
def test_fps_step_probe_times_both_paths(cuda_device):
    """The step-synchronisation probe runs on both paths and the cluster's
    step (barrier + DSMEM read on top of the block's) is the slower."""
    block = fps.step_sync_us("block", 2048)
    cluster = fps.step_sync_us("cluster", 210000)
    assert 0 < block < cluster < 100


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,scales", [
    # paths as an H100 (132 SMs) takes them
    (2, 5000, 102, (0.1, 32, 0.2, 64)),     # warps, N over 4 staged chunks
    (12, 3000, 1000, (0.1, 32, 0.2, 64)),   # lanes, ragged last chunk, M % 32 != 0
    (2, 5000, 96, (0.02, 64, 0.04, 128)),   # warps, quotas never fill
    (8, 5000, 600, (0.02, 64, 0.04, 128)),  # lanes, quotas never fill: every chunk
    (4, 700, 1100, (0.2, 4, 0.4, 8)),       # lanes, quotas fill within a group
])
def test_ball_query_kernel_matches_plain_on_other_queries(cuda_device, B, N, M, scales):
    """Queries that are not the candidates, at the staging and block edges."""
    r1, s1, r2, s2 = scales
    rng = np.random.RandomState(8)
    xyz = torch.from_numpy(rng.randn(B, N, 3).astype(np.float32) * 0.3).to(cuda_device)
    q = torch.from_numpy(rng.randn(B, M, 3).astype(np.float32) * 0.3).to(cuda_device)
    d2 = pairwise_sq_distance(q, xyz)
    for g, w, r in zip(bq.two_scale_ball_query_cuda(xyz, q, *scales),
                       bq.two_scale_ball_query_plain(xyz, q, *scales), (r1, r2)):
        near = ((d2 - float(np.float32(r * r))).abs() < 1e-6).any(dim=-1)
        assert not ((g != w).any(dim=-1) & ~near).any()


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
    d2 = pairwise_sq_distance(q, xyz)
    for g, w, r in zip(bq.two_scale_ball_query_cuda(xyz, q, *scales),
                       bq.two_scale_ball_query_plain(xyz, q, *scales), (r1, r2)):
        near = ((d2 - float(np.float32(r * r))).abs() < 1e-6).any(dim=-1)
        assert not ((g != w).any(dim=-1) & ~near).any()


def _with_history(t):
    """`t` as a leaf that requires grad, then scaled by 1: a tensor carrying
    autograd history, as a training forward hands the kernels."""
    return t.clone().requires_grad_(True) * 1.0


@pytest.mark.cuda
def test_fps_cluster_path_at_the_training_shape_with_autograd_history(cuda_device):
    """PEM training onboards two 5000-point views a sample: 28 clouds of
    10 000 points -> 2048 on the cluster path (28 clusters of 16 blocks),
    with duplicates (views sampled with replacement), exact."""
    rng = np.random.RandomState(21)
    base = (rng.rand(28, 4000, 3).astype(np.float32) - 0.5) * 0.2
    pts = torch.from_numpy(np.stack([b[rng.randint(0, len(b), 10000)] for b in base]))
    pts = _with_history(pts.to(cuda_device))
    assert pts.grad_fn is not None and fps.fps_path(10000) == "cluster"
    assert fps.check_cluster_resident(10000) >= 1
    got = fps.farthest_point_sample_cuda(pts, 2048)
    assert torch.equal(got, fps.farthest_point_sample_plain(pts.detach(), 2048))
    assert not got.requires_grad


@pytest.mark.cuda
def test_ball_query_at_the_training_shape_with_autograd_history(cuda_device):
    """The training positional encodings: 28 clouds of 2048 points against
    themselves (the lanes path), inputs carrying autograd history."""
    rng = np.random.RandomState(22)
    xyz = torch.from_numpy(rng.randn(28, 2048, 3).astype(np.float32) * 0.3).to(cuda_device)
    q = _with_history(xyz)
    scales = (0.1, 32, 0.2, 64)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bq.ball_query_path(28, 2048, sms) == "lanes"
    d2 = pairwise_sq_distance(xyz, xyz)
    for g, w, r in zip(bq.two_scale_ball_query_cuda(q, q, *scales),
                       bq.two_scale_ball_query_plain(xyz, xyz, *scales), (0.1, 0.2)):
        near = ((d2 - float(np.float32(r * r))).abs() < 1e-6).any(dim=-1)
        assert not ((g != w).any(dim=-1) & ~near).any()


# fp32 scores and online softmax in another order than the plain matmul +
# softmax: the tolerance of the JAX package's own kernel test
ATTENTION_ATOL = 2e-5


def _qkv_on_card(rng, device, B, N, width, qk_scale=1.0, offset=0):
    """(B, N, width) float32 qkv on the card; q and k scaled by qk_scale (v
    as drawn); with `offset` > 0 the tensor starts `offset` floats into a
    larger buffer (16-byte aligned for a multiple of 4)."""
    x = rng.randn(B, N, width).astype(np.float32)
    x[..., :2 * width // 3] *= qk_scale
    buf = torch.zeros(offset + x.size, device=device)
    qkv = buf[offset:].view(B, N, width)
    qkv.copy_(torch.from_numpy(x))
    return qkv


# Stress cases: q and k x2 (K5) and rel-pos parameters x3 (K1) give scores
# of up to ~20, so that the online rescale and the masked tail meet a wide
# range of exponents. qkv x4 is not used: two fp32-accurate summation orders
# already differ by more than ATTENTION_ATOL there (see
# test_three_pass_tf32_attention_is_fp32_accurate), and neither is a bias
# near exp's overflow at 88, where one ulp of a score (1.5e-5 at 128) moves
# the output by about ATTENTION_ATOL.
@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,hd,qk_scale,offset", [
    pytest.param(16, 257, 16, 64, 1.0, 0, id="16-257-16-64"),   # DINOv2-L, one chunk
    pytest.param(3, 257, 16, 64, 1.0, 0, id="3-257-16-64"),     # ragged batch
    pytest.param(2, 128, 4, 64, 1.0, 0, id="2-128-4-64"),       # N a multiple of all tiles
    pytest.param(2, 17, 4, 32, 1.0, 0, id="2-17-4-32"),         # hd 32, N below one tile
    pytest.param(2, 48, 4, 32, 1.0, 0, id="2-48-4-32"),         # N = 16 k, half a key tile
    pytest.param(3, 1, 4, 64, 1.0, 0, id="3-1-4-64"),           # N = 1
    pytest.param(16, 257, 16, 64, 2.0, 0, id="16-257-16-64-large-scores"),
    pytest.param(2, 257, 4, 64, 1.0, 4, id="2-257-4-64-offset-16-bytes"),
])
def test_fused_attention_qkv_kernel_matches_plain(cuda_device, B, N, heads, hd, qk_scale,
                                                  offset):
    qkv = _qkv_on_card(np.random.RandomState(8), cuda_device, B, N, 3 * heads * hd,
                       qk_scale, offset)
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


def _head_major_operands(rng, device, B, H, Nq, Nk, hd, qk, offset):
    """q (B, H, Nq, hd), k and v (B, H, Nk, hd) from `rng`, q and k times
    `qk`; with `offset` > 0 each lies `offset` floats into its buffer (rows
    4-byte aligned only)."""
    out = []
    for n, scale in ((Nq, qk), (Nk, qk), (Nk, 1.0)):
        x = torch.from_numpy(rng.randn(B, H, n, hd).astype(np.float32) * np.float32(scale))
        buf = torch.zeros(offset + x.numel(), device=device)
        view = buf[offset:].view(B, H, n, hd)
        view.copy_(x)
        out.append(view)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Nq,Nk,hd,qk,offset", [
    pytest.param(16, 16, 1025, 1025, 64, 1.0, 0, id="16-16-1025-1025-64"),  # DINOv2-L at 448
    pytest.param(2, 4, 61, 300, 32, 1.0, 0, id="2-4-61-300-32"),   # cross-attention, ragged tiles
    pytest.param(2, 3, 130, 130, 80, 1.0, 0, id="2-3-130-130-80"),  # hd 80
    pytest.param(1, 2, 7, 5, 13, 1.0, 0, id="1-2-7-5-13"),    # hd not a multiple of 4, one tile
    pytest.param(1, 2, 70, 66, 128, 1.0, 0, id="1-2-70-66-128"),  # the largest hd
    pytest.param(2, 3, 1, 300, 64, 1.0, 0, id="2-3-1-300-64-one-query"),
    pytest.param(2, 3, 50, 1, 64, 1.0, 0, id="2-3-50-1-64-one-key"),
    pytest.param(1, 1, 1, 1, 32, 1.0, 0, id="1-1-1-1-32-one-query-one-key"),
    pytest.param(2, 2, 50, 20, 64, 1.0, 0, id="2-2-50-20-64-keys-below-a-tile"),
    pytest.param(1, 2, 129, 70, 64, 1.0, 0, id="1-2-129-70-64-a-row-past-a-block"),
    pytest.param(16, 16, 1025, 1025, 64, 2.0, 0, id="16-16-1025-1025-64-large-scores"),
    pytest.param(2, 3, 37, 45, 13, 1.0, 1, id="2-3-37-45-13-offset-4-bytes"),
    pytest.param(2, 2, 200, 150, 128, 1.0, 0, id="2-2-200-150-128"),
])
def test_fused_attention_kernel_matches_plain(cuda_device, B, H, Nq, Nk, hd, qk, offset):
    q, k, v = _head_major_operands(np.random.RandomState(14), cuda_device, B, H, Nq, Nk, hd,
                                   qk, offset)
    got = attention.fused_attention_cuda(q, k, v, hd ** -0.5)
    want = attention.fused_attention_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Nq, hd)
    assert float((got - want).abs().max()) <= ATTENTION_ATOL


@pytest.mark.cuda
def test_fused_attention_kernel_reads_qkv_views(cuda_device):
    """The (B, H, N, hd) views of a fused qkv projection, read through their
    strides, as models/vit.Attention passes them at N > 1024."""
    B, N, H, hd = 2, 1100, 4, 64
    qkv = torch.randn(B, N, 3 * H * hd, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    got = attention.fused_attention_cuda(q, k, v, hd ** -0.5)
    want = attention.fused_attention_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTENTION_ATOL
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,hd,qk", [
    pytest.param(16, 16, 257, 64, 1.0, id="16-16-257-64"),   # DINOv2-L class tokens
    pytest.param(3, 4, 31, 32, 1.0, id="3-4-31-32"),         # below one key tile
    pytest.param(2, 2, 65, 16, 1.0, id="2-2-65-16"),
    pytest.param(2, 3, 1, 64, 1.0, id="2-3-1-64-one-token"),
    pytest.param(1, 2, 129, 64, 1.0, id="1-2-129-64-a-row-past-a-block"),
    pytest.param(16, 16, 257, 64, 2.0, id="16-16-257-64-large-scores"),
])
def test_fused_attention_small_kernel_matches_plain(cuda_device, B, H, N, hd, qk):
    q, k, v = _head_major_operands(np.random.RandomState(15), cuda_device, B, H, N, N, hd,
                                   qk, 0)
    got = attention.fused_attention_small_cuda(q, k, v, hd ** -0.5)
    want = attention.fused_attention_small_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTENTION_ATOL


@pytest.mark.cuda
def test_fused_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 2, 9, 48, device=cuda_device)
    with pytest.raises(ValueError):
        attention.fused_attention_small_cuda(q, q, q, 0.1)          # hd 48
    with pytest.raises(ValueError):
        attention.fused_attention_cuda(q, q[:, :, :, :40], q, 0.1)  # hd differs
    big = torch.zeros(1, 1, 4, 160, device=cuda_device)
    with pytest.raises(ValueError):
        attention.fused_attention_cuda(big, big, big, 0.1)          # hd > 128
    with pytest.raises(ValueError):
        attention.fused_attention_cuda(q.double(), q.double(), q.double(), 0.1)


def factored_state(rng, B, N, C, d, ranks, scaled, with_a, device="cpu"):
    """Random scaled-block factor state as the iou-prefix pass carries it:
    blocks of raw rows in [0, 1) (softmax probabilities and LayerNorm rows),
    positive per-position scales, S, U (B, R, C), UK/UV-like (B, R, d)."""
    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)
    blocks = tuple((t(rng.rand(B, r, N)), t(rng.rand(B, N) + 0.5) if s else None)
                   for r, s in zip(ranks, scaled))
    R = sum(ranks)
    return dict(blocks=blocks, S=t(rng.randn(N, C)), U=t(rng.randn(B, R, C) * 0.3),
                UK=t(rng.randn(B, R, d) * 0.3), UV=t(rng.randn(B, R, d) * 0.3),
                a=t(rng.rand(B, N) + 0.5) if with_a else None,
                q=t(rng.randn(B, 7, d) * 0.25), KS=t(rng.randn(N, d) * 0.25),
                KC=t(rng.randn(N, d) * 0.25), VS=t(rng.randn(N, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,heads,hd,rel_scale,offset", [
    pytest.param(1, (64, 64), 16, 80, 1.0, 0, id="1-hw0-16-80"),     # ViT-H global block
    pytest.param(25, (14, 14), 16, 80, 1.0, 0, id="25-hw1-16-80"),   # ViT-H windowed, gw 14
    pytest.param(2, (5, 7), 2, 16, 1.0, 0, id="2-hw2-2-16"),         # ragged tiles, hd 16
    pytest.param(3, (9, 9), 4, 64, 1.0, 0, id="3-hw3-4-64"),
    pytest.param(2, (3, 4), 2, 32, 1.0, 0, id="2-3x4-2-32"),         # N below one warp tile
    pytest.param(25, (14, 14), 16, 80, 3.0, 0, id="25-14x14-16-80-large-bias"),
    pytest.param(1, (64, 64), 16, 80, 3.0, 0, id="1-64x64-16-80-large-bias"),
    pytest.param(2, (9, 9), 4, 64, 1.0, 4, id="2-9x9-4-64-offset-16-bytes"),
])
def test_flash_attention_relpos_kernel_matches_plain(cuda_device, B, hw, heads, hd, rel_scale,
                                                     offset):
    rng = np.random.RandomState(10)
    H, W = hw
    qkv = _qkv_on_card(rng, cuda_device, B, H * W, 3 * heads * hd, offset=offset)
    rh = torch.from_numpy(rng.randn(2 * H - 1, hd).astype(np.float32) * 0.1 * rel_scale
                          ).to(cuda_device)
    rw = torch.from_numpy(rng.randn(2 * W - 1, hd).astype(np.float32) * 0.1 * rel_scale
                          ).to(cuda_device)
    got = relpos.flash_attention_relpos_cuda(qkv, rh, rw, hw, heads)
    want = relpos.flash_attention_relpos_plain(qkv, rh, rw, hw, heads)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTENTION_ATOL


# the kernels sum over the C channels, the N positions and the R factor rows
# in another order than the plain versions (K2 forms x instead of the gram
# quadratic, so 1/sigma carries the cancellation of E[x^2] - mu^2)
FACTORED_ATOL, LN_INV_RTOL = 1e-4, 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,scaled,with_a,B,N,u_mag", [
    # layer 1 and layer 2 LayerNorm (the ids the two cases had before)
    pytest.param((57,), (False,), False, 16, 4096, 1.0, id="ranks0-scaled0-False"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 4096, 1.0,
                 id="ranks1-scaled1-True"),
    pytest.param((1,), (True,), True, 16, 4096, 1.0, id="rank1"),
    pytest.param((30, 2, 20, 9), (True, False, True, True), True, 16, 4096, 1.0,
                 id="four-blocks-mixed-scales"),
    pytest.param((5, 2, 3), (True, True, False), True, 16, 4096, 1.0, id="ranks-5+2+3"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 100, 1.0, id="ragged-N100"),
    pytest.param((57, 2, 57), (True, True, False), True, 128, 4096, 1.0,
                 id="main-path-B128-116"),
    # the tensor cores' truncating accumulation over the longest chain, at
    # four times the rank term's magnitude
    pytest.param((57, 2, 57), (True, True, False), True, 16, 4096, 4.0, id="stress-Ux4"),
])
def test_factored_ln_stats_kernel_matches_plain(cuda_device, ranks, scaled, with_a, B, N,
                                                u_mag):
    st = factored_state(np.random.RandomState(11), B, N, 256, 128, ranks, scaled,
                        with_a, cuda_device)
    U = st["U"] * u_mag
    mu, inv = factored.factored_ln_stats_cuda(st["blocks"], U, st["S"], st["a"])
    mu_p, inv_p = factored.factored_ln_stats_plain(st["blocks"], U, st["S"], st["a"])
    torch.cuda.synchronize()
    assert mu.shape == inv.shape == (B, N)
    assert float((mu - mu_p).abs().max()) <= FACTORED_ATOL
    assert float(((inv - inv_p).abs() / inv_p.abs()).max()) <= LN_INV_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,scaled,N,B,T,q_mag", [
    # the three cases (and ids) the test had before
    pytest.param((57, 2), (True, False), 4096, 16, 7, 1.0, id="ranks0-scaled0-4096"),
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 16, 7, 1.0,
                 id="ranks1-scaled1-4096"),                 # final attention
    pytest.param((5, 2), (True, False), 100, 16, 7, 1.0, id="ranks2-scaled2-100"),
    # the main path's two launches
    pytest.param((57, 2), (True, False), 4096, 128, 7, 1.0, id="main-path-B128-rank-59"),
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 128, 7, 1.0,
                 id="main-path-B128-rank-118"),
    # the kernel's limits of rank and tokens
    pytest.param((1,), (True,), 4096, 4, 7, 1.0, id="rank-1"),
    pytest.param((64, 64), (True, False), 4096, 4, 7, 1.0, id="rank-128"),
    pytest.param((57, 2), (True, False), 4096, 4, 1, 1.0, id="one-token"),
    pytest.param((57, 2), (True, False), 4096, 4, 8, 1.0, id="eight-tokens"),
    # rows not 16-byte aligned (4-byte staging), a ragged tile, fewer tiles
    # than position chunks
    pytest.param((17, 2), (True, False), 98, 4, 7, 1.0, id="n98-4-byte-staging"),
    # four times the scores: the chunks' maxima differ widely in the merge
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 16, 7, 4.0,
                 id="stress-scores-x4"),
])
def test_factored_t2i_attention_kernel_matches_plain(cuda_device, ranks, scaled, N, B, T,
                                                    q_mag):
    rng = np.random.RandomState(12)
    st = factored_state(rng, B, N, 256, 128, ranks, scaled, True, cuda_device)
    q = st["q"] if T == 7 else torch.from_numpy(
        rng.randn(B, T, 128).astype(np.float32) * 0.25).to(cuda_device)
    args = (q * q_mag, st["UK"], st["UV"], st["blocks"], st["a"], st["KS"], st["KC"],
            st["VS"], 8)
    got = factored.factored_t2i_attention_cuda(*args)
    want = factored.factored_t2i_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, T, 128)
    assert float((got - want).abs().max()) <= FACTORED_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,scaled,with_a,N", [
    ((), (), False, 4096),                            # layer 1 i2t
    ((57, 2), (True, False), True, 4096),             # layer 2 i2t
    ((5, 2), (True, False), True, 100),
])
def test_factored_i2t_scores_kernel_matches_plain(cuda_device, ranks, scaled, with_a, N):
    st = factored_state(np.random.RandomState(13), 16, N, 256, 128, ranks, scaled,
                        with_a, cuda_device)
    args = (st["q"], st["UK"] if ranks else None, st["blocks"], st["a"], st["KS"],
            st["KC"], 8)
    got = factored.factored_i2t_scores_cuda(*args)
    want = factored.factored_i2t_scores_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (16, 57, N)
    assert float((got - want).abs().max()) <= FACTORED_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,ranks,scaled,with_a,N,T", [
    pytest.param(128, (57, 2), (True, False), True, 4096, 7, id="main-path-rank-59"),
    pytest.param(4, (64, 64), (True, False), True, 4096, 7, id="rank-128"),
    pytest.param(4, (5, 16, 3, 9), (True, False, True, False), True, 1024, 7,
                 id="four-blocks-mixed-scales"),
    pytest.param(4, (57, 2), (True, False), True, 1024, 1, id="one-token"),
    pytest.param(4, (57, 2), (True, False), False, 1024, 8, id="eight-tokens"),
    pytest.param(4, (), (), False, 1024, 8, id="eight-tokens-rank-0"),
    pytest.param(4, (17, 2), (True, False), True, 98, 7, id="n98-4-byte-staging"),
])
def test_factored_i2t_scores_kernel_covers_ranks_tokens_and_edges(cuda_device, B, ranks,
                                                                   scaled, with_a, N, T):
    """K4's tensor-core kernel at the main path's launch, its largest rank,
    four scaled blocks, 1 and 8 tokens, and N = 98 (rows not 16-byte
    aligned: the 4-byte staging path and a ragged position tile)."""
    rng = np.random.RandomState(14)
    st = factored_state(rng, B, N, 256, 128, ranks, scaled, with_a, cuda_device)
    kt = torch.from_numpy(rng.randn(B, T, 128).astype(np.float32) * 0.25).to(cuda_device)
    args = (kt, st["UK"] if ranks else None, st["blocks"], st["a"], st["KS"], st["KC"], 8)
    got = factored.factored_i2t_scores_cuda(*args)
    want = factored.factored_i2t_scores_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, 8 * T + 1, N)
    assert float((got - want).abs().max()) <= FACTORED_ATOL


# ------------------------------------------- bf16 entries (K1, K5, K8, K9)

# the bf16 entries against the plain versions of their contract: the same
# bf16 roundings of p, summed in another order and over an online softmax,
# and the bf16 output's own rounding (the JAX package's tolerance for its
# bf16 kernels, tests/test_pallas_kernels.py)
BF16_ATOL = 8e-3


def _bf16_on_card(rng, device, shape, scale=1.0, offset=0):
    """A bf16 tensor of `shape` on the card, randn x scale; with `offset` > 0
    it starts `offset` elements into a larger buffer."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * np.float32(scale))
    buf = torch.zeros(offset + x.numel(), device=device, dtype=torch.bfloat16)
    view = buf[offset:].view(*shape)
    view.copy_(x)
    return view


def _bf16_close(got, want, atol=BF16_ATOL):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,hd,qk,offset", [
    pytest.param(16, 257, 16, 64, 1.0, 0, id="16-257-16-64"),   # DINOv2-L, one chunk
    pytest.param(3, 257, 16, 64, 1.0, 0, id="3-257-16-64"),
    pytest.param(2, 17, 4, 32, 1.0, 0, id="2-17-4-32"),
    pytest.param(3, 1, 4, 64, 1.0, 0, id="3-1-4-64"),
    pytest.param(2, 130, 4, 64, 1.0, 0, id="2-130-4-64-a-tile-and-a-row"),
    pytest.param(16, 257, 16, 64, 2.0, 0, id="16-257-16-64-large-scores"),
    pytest.param(2, 257, 4, 64, 1.0, 8, id="2-257-4-64-offset-16-bytes"),
    # tile edges of the wgmma core: 64-row and 64-key tiles, the ring's five
    # resident tiles at hd <= 64 (320 keys) and the streaming ring past them
    pytest.param(2, 63, 4, 64, 1.0, 0, id="2-63-4-64"),
    pytest.param(2, 65, 4, 32, 1.0, 0, id="2-65-4-32"),
    pytest.param(2, 196, 4, 64, 1.0, 0, id="2-196-4-64"),
    pytest.param(2, 320, 2, 64, 1.0, 0, id="2-320-2-64-ring-full"),
    pytest.param(2, 321, 2, 64, 1.0, 0, id="2-321-2-64-streaming"),
    pytest.param(1, 4096, 2, 64, 1.0, 0, id="1-4096-2-64-streaming"),
    pytest.param(1, 4096, 2, 32, 2.0, 8, id="1-4096-2-32-large-scores-offset"),
])
def test_fused_attention_qkv_bf16_entry_matches_plain(cuda_device, B, N, heads, hd, qk, offset):
    C = heads * hd
    qkv = _bf16_on_card(np.random.RandomState(21), cuda_device, (B, N, 3 * C), 1.0, offset)
    with torch.no_grad():
        qkv[..., :2 * C] *= 0.5 * qk
    got = attention_qkv.fused_attention_qkv_bf16_cuda(qkv, heads, hd ** -0.5)
    _bf16_close(got, attention_qkv.fused_attention_qkv_bf16_plain(qkv, heads, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Nq,Nk,hd,qk", [
    pytest.param(16, 16, 1025, 1025, 64, 1.0, id="16-16-1025-1025-64"),   # DINOv2-L at 448
    pytest.param(2, 4, 61, 300, 32, 1.0, id="2-4-61-300-32"),   # cross-attention
    pytest.param(2, 3, 130, 130, 80, 1.0, id="2-3-130-130-80"),
    pytest.param(1, 2, 33, 70, 40, 1.0, id="1-2-33-70-40-padded-hd"),
    pytest.param(1, 2, 70, 66, 128, 1.0, id="1-2-70-66-128"),
    pytest.param(2, 3, 1, 300, 64, 1.0, id="2-3-1-300-64-one-query"),
    pytest.param(2, 3, 50, 1, 64, 1.0, id="2-3-50-1-64-one-key"),
    pytest.param(1, 2, 129, 70, 64, 1.0, id="1-2-129-70-64-a-row-past-a-block"),
    pytest.param(16, 16, 1025, 1025, 64, 2.0, id="16-16-1025-1025-64-large-scores"),
])
def test_fused_attention_bf16_entry_matches_plain(cuda_device, B, H, Nq, Nk, hd, qk):
    rng = np.random.RandomState(22)
    q = _bf16_on_card(rng, cuda_device, (B, H, Nq, hd), 0.5 * qk)
    k = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd), 0.5 * qk)
    v = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd))
    got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
def test_fused_attention_bf16_entry_reads_qkv_views(cuda_device):
    """The (B, H, N, hd) views of a bf16 qkv projection, as
    models/vit.Attention passes them at N > 1024."""
    B, N, H, hd = 2, 1100, 4, 64
    qkv = _bf16_on_card(np.random.RandomState(23), cuda_device, (B, N, 3 * H * hd), 0.5)
    q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5))
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,hd,qk", [
    pytest.param(16, 16, 257, 64, 1.0, id="16-16-257-64"),
    pytest.param(3, 4, 31, 32, 1.0, id="3-4-31-32"),
    pytest.param(2, 2, 65, 16, 1.0, id="2-2-65-16"),
    pytest.param(16, 16, 257, 64, 2.0, id="16-16-257-64-large-scores"),
])
def test_fused_attention_small_bf16_entry_matches_plain(cuda_device, B, H, N, hd, qk):
    rng = np.random.RandomState(24)
    q, k = (_bf16_on_card(rng, cuda_device, (B, H, N, hd), 0.5 * qk) for _ in range(2))
    v = _bf16_on_card(rng, cuda_device, (B, H, N, hd))
    got = attention.fused_attention_small_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_small_bf16_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,heads,hd,rel_scale", [
    pytest.param(1, (64, 64), 16, 80, 1.0, id="1-64x64-16-80"),     # ViT-H global block
    pytest.param(25, (14, 14), 16, 80, 1.0, id="25-14x14-16-80"),   # ViT-H windowed
    pytest.param(2, (5, 7), 2, 16, 1.0, id="2-5x7-2-16"),
    pytest.param(3, (9, 9), 4, 64, 1.0, id="3-9x9-4-64"),
    pytest.param(2, (3, 4), 2, 32, 1.0, id="2-3x4-2-32"),
    pytest.param(25, (14, 14), 16, 80, 3.0, id="25-14x14-16-80-large-bias"),
    # tile edges of the wgmma core: N 1, 63, 65, 257; the ring's four
    # resident tiles at hd 80 (256 keys) and the streaming ring past them
    pytest.param(2, (1, 1), 2, 16, 1.0, id="2-1x1-2-16"),
    pytest.param(2, (7, 9), 2, 32, 1.0, id="2-7x9-2-32"),
    pytest.param(2, (5, 13), 2, 64, 1.0, id="2-5x13-2-64"),
    pytest.param(1, (1, 257), 2, 32, 1.0, id="1-1x257-2-32"),
    pytest.param(2, (16, 16), 2, 80, 1.0, id="2-16x16-2-80-ring-full"),
    pytest.param(2, (13, 20), 2, 80, 1.0, id="2-13x20-2-80-streaming"),
    pytest.param(1, (64, 64), 16, 80, 3.0, id="1-64x64-16-80-large-bias"),
])
def test_flash_attention_relpos_bf16_entry_matches_plain(cuda_device, B, hw, heads, hd,
                                                         rel_scale):
    rng = np.random.RandomState(25)
    H, W = hw
    C = heads * hd
    qkv = _bf16_on_card(rng, cuda_device, (B, H * W, 3 * C))
    with torch.no_grad():
        qkv[..., :2 * C] *= 0.5
    rh = _bf16_on_card(rng, cuda_device, (2 * H - 1, hd), 0.1 * rel_scale)
    rw = _bf16_on_card(rng, cuda_device, (2 * W - 1, hd), 0.1 * rel_scale)
    got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, hw, heads)
    _bf16_close(got, relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, hw, heads))


def _peaked_qkv(rng, B, N, heads, hd):
    """(B, N, 3 heads hd) float32 qkv in which every query's scores peak at
    one key (the query is twice that key, at a random place) and every V row
    carries its 64-key tile's own offset, (tile mod 64 - 31.5) / 36, plus a
    little noise: a row's output is about its peak key's tile offset, below
    1 in magnitude, where one ulp of the bf16 output is 2^-8."""
    k = rng.randn(B, N, heads, hd).astype(np.float32)
    q = 2 * k[:, rng.permutation(N)]
    tile = (np.arange(N) // 64 % 64 - 31.5) / 36
    v = (tile[None, :, None, None] + 0.01 * rng.randn(B, N, heads, hd)).astype(np.float32)
    return np.concatenate([q, k, v], axis=2).reshape(B, N, 3 * heads * hd)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,hw,heads,hd", [
    pytest.param("qkv", (1, 4096), 2, 64, id="k5-1x4096-2-64"),
    pytest.param("relpos", (64, 64), 2, 80, id="k1-64x64-2-80"),
    pytest.param("relpos", (13, 20), 2, 80, id="k1-13x20-2-80"),
])
def test_bf16_streaming_ring_reads_every_key_tile(cuda_device, entry, hw, heads, hd):
    """Past the resident ring the wgmma core streams K/V through two stages.
    With peaked scores and a V offset a tile, a stage read before its refill
    landed, or refilled before it was read, moves the rows whose peak key
    lies in it to another tile's offset, at least 1/36 away (three times the
    tolerance), where flat scores would move them by less than it."""
    H, W = hw
    qkv = torch.from_numpy(_peaked_qkv(np.random.RandomState(26), 1, H * W, heads, hd))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    if entry == "qkv":
        got = attention_qkv.fused_attention_qkv_bf16_cuda(qkv, heads, hd ** -0.5)
        want = attention_qkv.fused_attention_qkv_bf16_plain(qkv, heads, hd ** -0.5)
    else:
        rng = np.random.RandomState(27)
        rh = _bf16_on_card(rng, cuda_device, (2 * H - 1, hd), 0.1)
        rw = _bf16_on_card(rng, cuda_device, (2 * W - 1, hd), 0.1)
        got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, hw, heads)
        want = relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, hw, heads)
    _bf16_close(got, want)


@pytest.mark.cuda
def test_bf16_entries_refuse_what_they_do_not_take(cuda_device):
    """float32 operands, a head dim that is not a multiple of 8, rows that
    are not 16-byte aligned; and the dispatches never hand bf16 to a float32
    entry, nor float16 to either."""
    q = torch.zeros(1, 2, 9, 64, device=cuda_device)
    with pytest.raises(ValueError):
        attention.fused_attention_bf16_cuda(q, q, q, 0.1)
    with pytest.raises(ValueError):
        attention.fused_attention_small_bf16_cuda(q, q, q, 0.1)
    with pytest.raises(ValueError):
        attention_qkv.fused_attention_qkv_bf16_cuda(torch.zeros(1, 9, 3 * 64, device=cuda_device),
                                                    1, 0.1)
    odd = torch.zeros(1, 2, 9, 12, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.fused_attention_bf16_cuda(odd, odd, odd, 0.1)
    buf = torch.zeros(1 + 2 * 9 * 64, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 2, 9, 64)
    with pytest.raises(ValueError):
        attention.fused_attention_bf16_cuda(shifted, shifted, shifted, 0.1)
    with pytest.raises(ValueError):
        attention.fused_attention(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q.bfloat16(), q, 0.1)
    # a grid whose tables do not fit a block's shared memory beside the ring:
    # the C launch refuses it (cudaErrorInvalidValue)
    wide = torch.zeros(1, 1000, 3 * 16, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        relpos.flash_attention_relpos_bf16_cuda(
            wide, torch.zeros(1, 16, device=cuda_device, dtype=torch.bfloat16),
            torch.zeros(1999, 16, device=cuda_device, dtype=torch.bfloat16), (1, 1000), 1)
    with pytest.raises(ValueError):
        relpos.flash_attention_relpos_cuda(torch.zeros(1, 9, 96, device=cuda_device).bfloat16(),
                                           torch.zeros(5, 8, device=cuda_device).bfloat16(),
                                           torch.zeros(5, 8, device=cuda_device).bfloat16(),
                                           (3, 3), 4)



# --------------------------------------- bf16 entries of K2, K3 and K4

def _bf16_state(st):
    """factored_state's tensors rounded to bf16 (the blocks too)."""
    def b(x):
        return None if x is None else x.to(torch.bfloat16)
    out = {k: b(v) for k, v in st.items() if k != "blocks"}
    out["blocks"] = tuple((b(pd), b(s)) for pd, s in st["blocks"])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,scaled,with_a,B,N,u_mag", [
    pytest.param((57,), (False,), False, 16, 4096, 1.0, id="rank-57-unscaled"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 4096, 1.0, id="rank-116"),
    pytest.param((1,), (True,), True, 16, 4096, 1.0, id="rank1"),
    pytest.param((30, 2, 20, 9), (True, False, True, True), True, 16, 4096, 1.0,
                 id="four-blocks-mixed-scales"),
    pytest.param((5, 2, 3), (True, True, False), True, 16, 4096, 1.0, id="ranks-5+2+3"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 100, 1.0, id="ragged-N100"),
    pytest.param((57,), (False,), False, 128, 4096, 1.0, id="main-path-B128-57"),
    pytest.param((57, 2, 57), (True, True, False), True, 128, 4096, 1.0,
                 id="main-path-B128-116"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 4096, 4.0, id="stress-Ux4"),
])
def test_factored_ln_stats_bf16_entry_matches_plain(cuda_device, ranks, scaled, with_a, B,
                                                    N, u_mag):
    """The hi/lo split of the scaled rows and fp32 sums: mu within 1e-4 and
    1/sigma within rtol 1e-3 of the plain bf16 version, as the fp32 entry."""
    st = _bf16_state(factored_state(np.random.RandomState(11), B, N, 256, 128, ranks, scaled,
                                    with_a, cuda_device))
    U = (st["U"].float() * u_mag).to(torch.bfloat16)
    mu, inv = factored.factored_ln_stats_bf16_cuda(st["blocks"], U, st["S"], st["a"])
    mu_p, inv_p = factored.factored_ln_stats_bf16_plain(st["blocks"], U, st["S"], st["a"])
    torch.cuda.synchronize()
    assert mu.dtype == inv.dtype == torch.float32 and mu.shape == inv.shape == (B, N)
    assert float((mu - mu_p).abs().max()) <= FACTORED_ATOL
    assert float(((inv - inv_p).abs() / inv_p.abs()).max()) <= LN_INV_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,scaled,N,B,T,q_mag", [
    pytest.param((57, 2), (True, False), 4096, 16, 7, 1.0, id="rank-59"),
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 16, 7, 1.0, id="rank-118"),
    pytest.param((5, 2), (True, False), 100, 16, 7, 1.0, id="ranks-5+2-N100"),
    pytest.param((57, 2), (True, False), 4096, 128, 7, 1.0, id="main-path-B128-rank-59"),
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 128, 7, 1.0,
                 id="main-path-B128-rank-118"),
    pytest.param((1,), (True,), 4096, 4, 7, 1.0, id="rank-1"),
    pytest.param((64, 64), (True, False), 4096, 4, 7, 1.0, id="rank-128"),
    pytest.param((57, 2), (True, False), 4096, 4, 1, 1.0, id="one-token"),
    pytest.param((57, 2), (True, False), 4096, 4, 8, 1.0, id="eight-tokens"),
    pytest.param((17, 2), (True, False), 98, 4, 7, 1.0, id="n98-2-byte-staging"),
    # four times the scores: a sharp softmax over the N positions, whose
    # chunks' maxima differ widely
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 16, 7, 4.0,
                 id="stress-scores-x4"),
])
def test_factored_t2i_attention_bf16_entry_matches_plain(cuda_device, ranks, scaled, N, B,
                                                         T, q_mag):
    rng = np.random.RandomState(12)
    st = _bf16_state(factored_state(rng, B, N, 256, 128, ranks, scaled, True, cuda_device))
    q = st["q"] if T == 7 else torch.from_numpy(
        rng.randn(B, T, 128).astype(np.float32) * 0.25).to(cuda_device).to(torch.bfloat16)
    args = ((q.float() * q_mag).to(torch.bfloat16), st["UK"], st["UV"], st["blocks"], st["a"],
            st["KS"], st["KC"], st["VS"], 8)
    got = factored.factored_t2i_attention_bf16_cuda(*args)
    want = factored.factored_t2i_attention_bf16_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape == (B, T, 128)
    # K3's outputs pass 2 (T2 U_V), where one ulp of the bf16 output, whose
    # rounding the fp32 sums' order can flip, is 2^-7 |out| > 8e-3: held to
    # 8e-3 relative to max(1, |out|), the error 8e-3 is in [1, 2)
    d = (got.float() - want.float()).abs()
    assert float((d / want.float().abs().clamp(min=1.0)).max()) <= BF16_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,ranks,scaled,with_a,N,T", [
    pytest.param(16, (), (), False, 4096, 7, id="layer-1-rank-0"),
    pytest.param(16, (57, 2), (True, False), True, 4096, 7, id="layer-2-rank-59"),
    pytest.param(16, (5, 2), (True, False), True, 100, 7, id="ranks-5+2-N100"),
    pytest.param(128, (57, 2), (True, False), True, 4096, 7, id="main-path-rank-59"),
    pytest.param(128, (), (), False, 4096, 7, id="main-path-rank-0"),
    pytest.param(4, (64, 64), (True, False), True, 4096, 7, id="rank-128"),
    pytest.param(4, (5, 16, 3, 9), (True, False, True, False), True, 1024, 7,
                 id="four-blocks-mixed-scales"),
    pytest.param(4, (57, 2), (True, False), True, 1024, 1, id="one-token"),
    pytest.param(4, (57, 2), (True, False), False, 1024, 8, id="eight-tokens"),
    pytest.param(4, (17, 2), (True, False), True, 98, 7, id="n98-2-byte-staging"),
])
def test_factored_i2t_scores_bf16_entry_matches_plain(cuda_device, B, ranks, scaled, with_a,
                                                      N, T):
    rng = np.random.RandomState(14)
    st = _bf16_state(factored_state(rng, B, N, 256, 128, ranks, scaled, with_a, cuda_device))
    kt = torch.from_numpy(rng.randn(B, T, 128).astype(np.float32) * 0.25).to(cuda_device)
    args = (kt.to(torch.bfloat16), st["UK"] if ranks else None, st["blocks"], st["a"],
            st["KS"], st["KC"], 8)
    got = factored.factored_i2t_scores_bf16_cuda(*args)
    assert got.shape == (B, 8 * T + 1, N)
    _bf16_close(got, factored.factored_i2t_scores_bf16_plain(*args))


@pytest.mark.cuda
def test_factored_bf16_entries_refuse_what_they_do_not_take(cuda_device):
    """float32 operands, a rank past the kernels' 128, rows that are not
    16-byte aligned; the dispatches route by the one dtype and refuse mixed
    or float16 operands."""
    st = factored_state(np.random.RandomState(15), 2, 64, 256, 128, (9, 2), (True, False),
                        True, cuda_device)
    b16 = _bf16_state(st)
    with pytest.raises(ValueError):
        factored.factored_ln_stats_bf16_cuda(st["blocks"], st["U"], st["S"], st["a"])
    with pytest.raises(ValueError):
        factored.factored_i2t_scores_bf16_cuda(st["q"], st["UK"], st["blocks"], st["a"],
                                               st["KS"], st["KC"], 8)
    big = ((torch.zeros(2, 129, 64, device=cuda_device, dtype=torch.bfloat16), None),)
    uk = torch.zeros(2, 129, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        factored.factored_t2i_attention_bf16_cuda(b16["q"], uk, uk, big, b16["a"], b16["KS"],
                                                  b16["KC"], b16["VS"], 8)
    buf = torch.zeros(1 + 64 * 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        factored.factored_i2t_scores_bf16_cuda(b16["q"], b16["UK"], b16["blocks"], b16["a"],
                                               buf[1:].view(64, 128), b16["KC"], 8)
    with pytest.raises(ValueError):
        factored.factored_i2t_scores(b16["q"], st["UK"], b16["blocks"], b16["a"], b16["KS"],
                                     b16["KC"], 8)
    with pytest.raises(ValueError):
        factored.factored_ln_stats(tuple((p.half(), s) for p, s in st["blocks"]), st["U"],
                                   st["S"], st["a"])
    counts = (factored.factored_i2t_scores_cuda.launches,
              factored.factored_i2t_scores_bf16_cuda.launches)
    factored.factored_i2t_scores(b16["q"], b16["UK"], b16["blocks"], b16["a"], b16["KS"],
                                 b16["KC"], 8)
    assert (factored.factored_i2t_scores_cuda.launches,
            factored.factored_i2t_scores_bf16_cuda.launches) == (counts[0], counts[1] + 1)


# --------------------------------------------- the torch.ops.sam6d operators

def _op_cuda_case(name, dtype, device):
    """(public dispatch, the `*_cuda` entry of `dtype`, args) at small
    kernel-legal shapes on the card."""
    rng = np.random.RandomState(sum(map(ord, name)))
    sfx = "_bf16_cuda" if dtype == torch.bfloat16 else "_cuda"

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)

    if name == "farthest_point_sample":
        return fps.farthest_point_sample, fps.farthest_point_sample_cuda, (t(2, 300, 3), 16,
                                                                           None)
    if name == "two_scale_ball_query":
        return (bq.two_scale_ball_query, bq.two_scale_ball_query_cuda,
                (t(2, 256, 3), t(2, 64, 3), 0.5, 8, 1.0, 16))
    if name == "fused_attention_qkv":
        return (attention_qkv.fused_attention_qkv, getattr(attention_qkv, name + sfx),
                (t(2, 33, 3 * 128), 2, 0.125))
    if name in ("fused_attention", "fused_attention_small"):
        q, k, v = t(2, 33, 3, 2, 64).permute(2, 0, 3, 1, 4)   # views of a qkv projection
        return getattr(attention, name), getattr(attention, name + sfx), (q, k, v, 0.125)
    if name == "flash_attention_relpos":
        return (relpos.flash_attention_relpos, getattr(relpos, name + sfx),
                (t(2, 12, 3 * 32), t(5, 16) * 0.1, t(7, 16) * 0.1, (3, 4), 2))
    st = factored_state(rng, 2, 64, 256, 128, (5, 2), (True, False), True, device)
    if dtype == torch.bfloat16:
        st = _bf16_state(st)
    fns = (getattr(factored, name), getattr(factored, name + sfx))
    if name == "factored_ln_stats":
        return (*fns, (st["blocks"], st["U"], st["S"], st["a"]))
    if name == "factored_t2i_attention":
        return (*fns, (st["q"], st["UK"], st["UV"], st["blocks"], st["a"], st["KS"], st["KC"],
                       st["VS"], 8))
    return (*fns, (st["q"], st["UK"], st["blocks"], st["a"], st["KS"], st["KC"], 8))


SAM6D_OPS = ("farthest_point_sample", "two_scale_ball_query", "fused_attention_qkv",
             "fused_attention", "fused_attention_small", "flash_attention_relpos",
             "factored_ln_stats", "factored_t2i_attention", "factored_i2t_scores")
OP_CUDA_CASES = [(n, torch.float32) for n in SAM6D_OPS] + [
    (n, torch.bfloat16) for n in SAM6D_OPS[2:]]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", OP_CUDA_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in OP_CUDA_CASES])
def test_sam6d_op_on_the_card_is_its_kernel(cuda_device, name, dtype):
    """Each dispatch is `torch.ops.sam6d.<name>`: on CUDA tensors it launches
    the `*_cuda` entry of the operands' dtype once and returns what the
    entry returns, and the operator's fake implementation gives the eager
    outputs' shapes, dtypes and strides (K8's (B, H, Nq, hd) view of a
    (B, Nq, H, hd) tensor)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map_only
    public, entry, args = _op_cuda_case(name, dtype, cuda_device)
    want = entry(*args)
    n = entry.launches
    got = public(*args)
    torch.cuda.synchronize()
    assert entry.launches == n + 1
    flat = (lambda o: list(o) if isinstance(o, (tuple, list)) else [o])
    for g, w in zip(flat(got), flat(want)):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = flat(public(*tree_map_only(torch.Tensor, mode.from_tensor, args)))
    for f, g in zip(fake, flat(got)):
        assert (tuple(f.shape), f.dtype, f.stride()) == (tuple(g.shape), g.dtype, g.stride())
