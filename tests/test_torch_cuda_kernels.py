"""The port's CUDA kernels held to their plain PyTorch versions on the card
(every test is marked `cuda` and skips without a GPU): FPS, two-scale ball
query (also at the training shapes, on inputs that carry autograd
history), the fused attentions (K5 off the qkv projection, K8 and K9 on
head-major operands), SAM's rel-pos attention (K1) and the factored AMG
kernels (K2-K4), and the bf16 entries of K1, K5, K8, K9 and K2-K4 against
the plain versions of their bf16 contract (K1's windowed launch also at
each last-tile size, with peaked scores, and its table stage bit for bit);
the NMS fixed-point kernel, the
describe sized on the device by CUDA-graph conditional nodes, and
`MultiObjectStream.submit_frame` returning before any result exists. The
file imports torch, numpy, pytest and sam6d_torch only (and the numpy NMS
problems of tests/torch_port_nms_cases.py), so it runs where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from sam6d_torch.kernels import attention, attention_qkv
from sam6d_torch.kernels import attention_relpos as relpos
from sam6d_torch.kernels import ball_query as bq
from sam6d_torch.kernels import factored, fps, nms
from sam6d_torch.kernels._build import load_library
from sam6d_torch.ops import masks
from sam6d_torch.ops.geometry import pairwise_sq_distance

from torch_port_nms_cases import NMS_CASES, nms_case

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
    # the split K/V planes (40-key tiles): 15 keys leave a partial 8-key
    # step in the permuted V^T, hd 32 and 64 at a 16-byte offset on grids
    # whose last tile is 1 and 30 keys, and 44 keys a last tile of 4
    pytest.param(2, (3, 5), 2, 16, 1.0, 0, id="2-3x5-2-16-partial-8-key-step"),
    pytest.param(2, (9, 9), 4, 32, 1.0, 4, id="2-9x9-4-32-offset-16-bytes"),
    pytest.param(3, (7, 10), 2, 64, 1.0, 4, id="3-7x10-2-64-offset-16-bytes"),
    pytest.param(2, (4, 11), 4, 80, 3.0, 0, id="2-4x11-4-80-last-tile-4-keys"),
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


@pytest.mark.cuda
def test_flash_attention_relpos_windowed_peaked_scores(cuda_device):
    """SAM's windowed shape with every query peaked at one key and a V offset
    a 64-key tile (_peaked_qkv): four rows peak inside the last 4 keys of
    the windows (the fp32 entry's last tile: 36 keys and 4 of padding), and a
    key read from a wrong slot of the permuted V^T, or a tile from a wrong
    ring buffer, moves a row by 1/36 or more."""
    rng = np.random.RandomState(32)
    qkv = torch.from_numpy(_peaked_qkv(rng, 25, 196, 16, 80)).to(cuda_device)
    rh, rw = (torch.from_numpy(rng.randn(27, 80).astype(np.float32) * 0.1).to(cuda_device)
              for _ in range(2))
    got = relpos.flash_attention_relpos_cuda(qkv, rh, rw, (14, 14), 16)
    want = relpos.flash_attention_relpos_plain(qkv, rh, rw, (14, 14), 16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTENTION_ATOL


def _tf32_split(x):
    """(big, small) of the kernels' split: rna to 10 mantissa bits, twice."""
    def rna(v):
        u = v.view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)
    big = rna(x)
    return big, rna(x - big)


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,heads,hd", [
    pytest.param(25, (14, 14), 16, 80, id="25x14x14-16-80"),
    pytest.param(1, (64, 64), 16, 80, id="1x64x64-16-80"),
    pytest.param(2, (3, 5), 2, 16, id="2x3x5-2-16"),
    pytest.param(3, (7, 10), 2, 64, id="3x7x10-2-64"),
])
def test_flash_attention_relpos_split_kv_planes(cuda_device, B, hw, heads, hd):
    """The fp32 entry's pre-pass, read back from its workspace: K times the
    softmax scale, V and the rel-pos rows as big/small planes, the big ones
    tf32 values, big + small within 2^-21 |x| of the fp32 value (and equal
    to the split's own halves), keys and rel-pos rows past the end zero, and
    V^T holding each 8-key step's keys in VT_KEY_ORDER; the key tile as the
    C entry gives it."""
    rng = np.random.RandomState(33)
    H, W = hw
    N = H * W
    qkv = _qkv_on_card(rng, cuda_device, B, N, 3 * heads * hd)
    rh, rw = (torch.from_numpy(rng.randn(2 * g - 1, hd).astype(np.float32) * 0.1).to(cuda_device)
              for g in hw)
    planes = relpos.split_kv_cuda(qkv, rh, rw, hw, heads)
    bk = load_library().sam6d_flash_attention_relpos_key_tile()
    n8 = planes["k_big"].shape[2]            # N rounded up to the key tile
    assert n8 % bk == 0 and N <= n8 < N + bk
    k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)[1:]   # (B, heads, N, hd)
    order = torch.tensor(relpos.VT_KEY_ORDER, device=cuda_device)
    perm = torch.arange(n8, device=cuda_device) // 8 * 8 + order.repeat(n8 // 8)

    def padded(x, rows):
        out = torch.zeros(*x.shape[:-2], rows, x.shape[-1], device=cuda_device)
        out[..., :x.shape[-2], :] = x
        return out

    vt = padded(v, n8)[:, :, perm]          # V's keys in the stored order
    for x, name in ((padded(k * np.float32(hd ** -0.5), n8), "k"), (vt, "vt"),
                    (padded(rh, planes["rh_big"].shape[0]), "rh"),
                    (padded(rw, planes["rw_big"].shape[0]), "rw")):
        big, small = planes[name + "_big"], planes[name + "_small"]
        if name == "vt":
            big, small = big.transpose(-1, -2), small.transpose(-1, -2)
        want_big, want_small = _tf32_split(x)
        assert torch.equal(big, want_big) and torch.equal(small, want_small), name
        assert bool(((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all()), name
        assert not bool((big.view(torch.int32) & 0x1FFF).any()), name
    # the pad: keys past N in every plane (x above is zero there)
    real = perm < N
    assert not bool(planes["vt_big"][..., ~real].any() or planes["k_big"][:, :, N:].any())


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
    # tile edges of the wgmma core: 64-row and 64-key tiles, the last tile
    # of at most 8 keys, the ring's five resident tiles at hd <= 64 (320
    # keys) and the streaming ring past them; cross-attention with either
    # side under a tile
    *(pytest.param(1, 2, n, n, 64, 1.0, id=f"1-2-{n}-{n}-64")
      for n in (1, 8, 9, 63, 64, 65, 320, 321, 1025)),
    pytest.param(1, 3, 7, 1025, 64, 1.0, id="1-3-7-1025-64-cross"),
    pytest.param(1, 3, 1025, 9, 64, 1.0, id="1-3-1025-9-64-cross"),
    pytest.param(2, 2, 9, 8, 64, 1.0, id="2-2-9-8-64-cross"),
    pytest.param(2, 2, 8, 65, 32, 1.0, id="2-2-8-65-32-cross"),
    # head dims padded by TMA's zero columns (8 -> 16, 24 -> 32) and the
    # two-part tiles (80: 64 + 16 channels, 128: 64 + 64), resident and
    # streaming (hd 80 and 128 hold 256 keys)
    *(pytest.param(2, 2, n, n, hd, 1.0, id=f"2-2-{n}-{n}-{hd}")
      for hd in (8, 24, 80, 128) for n in (65, 257, 321)),
    pytest.param(1, 2, 1025, 1025, 128, 2.0, id="1-2-1025-1025-128-large-scores"),
    pytest.param(2, 2, 9, 300, 8, 2.0, id="2-2-9-300-8-large-scores"),
])
def test_fused_attention_bf16_entry_matches_plain(cuda_device, B, H, Nq, Nk, hd, qk):
    rng = np.random.RandomState(22)
    q = _bf16_on_card(rng, cuda_device, (B, H, Nq, hd), 0.5 * qk)
    k = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd), 0.5 * qk)
    v = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd))
    got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,hd,offset", [
    pytest.param(2, 1100, 4, 64, 0, id="2-1100-4-64"),
    pytest.param(16, 1025, 16, 64, 0, id="16-1025-16-64"),   # the describe at 448
    pytest.param(2, 1025, 4, 64, 8, id="2-1025-4-64-offset-16-bytes"),
    pytest.param(2, 300, 3, 128, 8, id="2-300-3-128-offset-16-bytes"),
    pytest.param(2, 70, 2, 24, 0, id="2-70-2-24"),
])
def test_fused_attention_bf16_entry_reads_qkv_views(cuda_device, B, N, H, hd, offset):
    """The (B, H, N, hd) views of a bf16 qkv projection, as
    models/vit.Attention passes them at N > 1024 (every stride a multiple of
    16 bytes, non-monotonic: the head's below the row's), also 16 bytes
    into a buffer."""
    qkv = _bf16_on_card(np.random.RandomState(23), cuda_device, (B, N, 3 * H * hd), 0.5,
                        offset)
    q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5))
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q-4-bytes-into-a-buffer", "q-rows-of-hd-plus-2"])
def test_fused_attention_bf16_entry_reads_4_byte_aligned_q(cuda_device, case):
    """K8's contract takes q rows aligned to 4 bytes only (k and v to 16):
    q 4 bytes into its buffer, or q rows 2 elements longer than hd, so no
    row but the first is 16-byte aligned."""
    B, H, Nq, Nk, hd = 2, 3, 130, 200, 64
    rng = np.random.RandomState(28)
    if case == "q-4-bytes-into-a-buffer":
        q = _bf16_on_card(rng, cuda_device, (B, H, Nq, hd), 0.5, offset=2)
    else:
        q = _bf16_on_card(rng, cuda_device, (B, H, Nq, hd + 2), 0.5)[..., :hd]
    assert q.data_ptr() % 16 or q.stride(2) % 8
    k = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd), 0.5)
    v = _bf16_on_card(rng, cuda_device, (B, H, Nk, hd))
    got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
    _bf16_close(got, attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,hd,qk", [
    pytest.param(16, 16, 257, 64, 1.0, id="16-16-257-64"),
    pytest.param(3, 4, 31, 32, 1.0, id="3-4-31-32"),
    pytest.param(2, 2, 65, 16, 1.0, id="2-2-65-16"),
    pytest.param(16, 16, 257, 64, 2.0, id="16-16-257-64-large-scores"),
    pytest.param(4, 16, 257, 32, 1.0, id="4-16-257-32"),
    pytest.param(4, 16, 257, 16, 1.0, id="4-16-257-16"),
    pytest.param(2, 2, 321, 64, 1.0, id="2-2-321-64-streaming"),
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
    pytest.param("head-major", (1, 1025), 16, 64, id="k8-1x1025-16-64"),
])
def test_bf16_streaming_ring_reads_every_key_tile(cuda_device, entry, hw, heads, hd):
    """Past the resident ring the wgmma core streams K/V through two stages
    (K5 and K1 off one qkv matrix, K8 through a tensor map of each view).
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
    elif entry == "head-major":   # K8 on the qkv's (B, H, N, hd) views
        q, k, v = qkv.view(1, H * W, 3, heads, hd).permute(2, 0, 3, 1, 4)
        got = attention.fused_attention_bf16_cuda(q, k, v, hd ** -0.5)
        want = attention.fused_attention_bf16_plain(q, k, v, hd ** -0.5)
    else:
        rng = np.random.RandomState(27)
        rh = _bf16_on_card(rng, cuda_device, (2 * H - 1, hd), 0.1)
        rw = _bf16_on_card(rng, cuda_device, (2 * W - 1, hd), 0.1)
        got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, hw, heads)
        want = relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, hw, heads)
    _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,hd", [
    pytest.param(hw, hd, id=f"{hw[0]}x{hw[1]}-last-{last}-hd{hd}")
    for hw, last in (((3, 43), 1), ((14, 14), 4), ((8, 25), 8), ((3, 67), 9),
                     ((13, 16), 16), ((16, 16), 64))
    for hd in (80, 64)
])
def test_flash_attention_relpos_bf16_windowed_last_tiles(cuda_device, hw, hd):
    """The windowed launch (keys resident in the ring) on grids whose last
    key tile holds 1, 4, 8, 9, 16 and 64 keys: m64n8 or m64n16 on a 16-key
    ring stage up to 16 keys, a full stage past them. These grids keep their
    tables in shared memory (the windowed launch), and every entry stays
    within atol 8e-3 of the plain version."""
    rng = np.random.RandomState(29)
    H, W = hw
    heads = 2
    C = heads * hd
    assert not relpos.bf16_tables_in_global(2, hw, heads, hd)
    qkv = _bf16_on_card(rng, cuda_device, (2, H * W, 3 * C))
    with torch.no_grad():
        qkv[..., :2 * C] *= 0.5
    rh = _bf16_on_card(rng, cuda_device, (2 * H - 1, hd), 0.1)
    rw = _bf16_on_card(rng, cuda_device, (2 * W - 1, hd), 0.1)
    got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, hw, heads)
    _bf16_close(got, relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, hw, heads))


@pytest.mark.cuda
def test_flash_attention_relpos_bf16_windowed_peaked_scores(cuda_device):
    """SAM's windowed shape (25 windows of 14 x 14, 16 heads of 80) with
    every query peaked at one key and a V offset a 64-key tile: the peak
    keys form a permutation, so four rows peak inside the 4-key last tile
    and rows 192-195 (the tail row tile, warp 0 live) peak elsewhere. A key
    tile or a tail row read wrong moves those rows by 1/36 or more."""
    rng = np.random.RandomState(30)
    qkv = torch.from_numpy(_peaked_qkv(rng, 25, 196, 16, 80)).to(cuda_device, torch.bfloat16)
    rh = _bf16_on_card(rng, cuda_device, (27, 80), 0.1)
    rw = _bf16_on_card(rng, cuda_device, (27, 80), 0.1)
    got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, (14, 14), 16)
    _bf16_close(got, relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, (14, 14), 16))


@pytest.mark.cuda
@pytest.mark.parametrize("rel_scale", [1.0, 3.0], ids=["rel-x1", "rel-x3"])
def test_flash_attention_relpos_bf16_window_tables_equal_plain(cuda_device, rel_scale):
    """The windowed launch's table stage, run alone, equals
    bf16_rel_pos_tables bit for bit at SAM's windowed shape: each entry's
    two FMA chains in the same order, rounded to bf16 once."""
    rng = np.random.RandomState(31)
    qkv = _bf16_on_card(rng, cuda_device, (25, 196, 3 * 1280))
    rh = _bf16_on_card(rng, cuda_device, (27, 80), 0.1 * rel_scale)
    rw = _bf16_on_card(rng, cuda_device, (27, 80), 0.1 * rel_scale)
    got = relpos.window_tables_bf16_cuda(qkv, rh, rw, (14, 14), 16)
    want = relpos.bf16_rel_pos_tables(qkv, rh, rw, (14, 14), 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    with pytest.raises(ValueError):
        relpos.flash_attention_relpos_cuda(torch.zeros(1, 9, 96, device=cuda_device).bfloat16(),
                                           torch.zeros(5, 8, device=cuda_device).bfloat16(),
                                           torch.zeros(5, 8, device=cuda_device).bfloat16(),
                                           (3, 3), 4)


@pytest.mark.cuda
def test_fused_attention_bf16_launch_refuses_what_tma_cannot_map(cuda_device):
    """The C launch of K8's bf16 entry keeps the wrapper's refusals itself
    (cudaErrorInvalidValue, 1): k or v rows off 16 bytes, q rows off 4
    bytes, an hd off the contract; its shared-memory entry sizes the
    resident ring and the streaming stages, and refuses such an hd."""
    from sam6d_torch.kernels._build import load_library
    lib = load_library()
    buf = torch.zeros(8 + 2 * 3 * 70 * 64, device=cuda_device, dtype=torch.bfloat16)
    good = buf[:2 * 3 * 70 * 64].view(2, 3, 70, 64)
    off_k = buf[4:4 + good.numel()].view(2, 3, 70, 64)   # 8 bytes in
    off_q = buf[1:1 + good.numel()].view(2, 3, 70, 64)   # 2 bytes in
    out = torch.empty_like(good)

    def launch(q, k, v, hd=64):
        st = [attention._strides(t) for t in (q, k, v, out)]
        return lib.sam6d_fused_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st, 2, 3, 70, 70, hd,
            0.125, torch.cuda.current_stream().cuda_stream)

    assert launch(good, good, good) == 0
    assert launch(good, off_k, good) == 1
    assert launch(good, good, off_k) == 1
    assert launch(off_q, good, good) == 1
    assert launch(good, good, good, hd=60) == 1
    torch.cuda.synchronize()
    smem = [lib.sam6d_fused_attention_bf16_smem(70, nk, hd)
            for nk, hd in ((257, 64), (1025, 64), (256, 128), (257, 128))]
    # K, V tiles and two barriers a stage, then two q tiles; past the
    # resident ring two stages stream
    stage64, stage128 = 2 * 64 * 64 * 2 + 16, 2 * 64 * 128 * 2 + 16
    assert smem == [5 * stage64 + 2 * 64 * 64 * 2, 2 * stage64 + 2 * 64 * 64 * 2,
                    4 * stage128 + 2 * 64 * 128 * 2, 2 * stage128 + 2 * 64 * 128 * 2]
    assert lib.sam6d_fused_attention_bf16_smem(70, 257, 60) == -1



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
    # edges of the wgmma design: one prompt (8 blocks), a 128-rank U, one
    # partial position tile, and ranks whose U does not fit shared memory
    # beside the ring (it streams with the P_eff rows), with further scaled
    # blocks split into hi + lo, also where the threads write P_eff
    pytest.param((57, 2, 57), (True, True, False), True, 1, 4096, 1.0, id="one-prompt"),
    pytest.param((64, 64), (True, False), True, 16, 4096, 1.0, id="rank-128"),
    pytest.param((57, 2, 57), (True, True, False), True, 16, 40, 1.0,
                 id="n40-one-partial-tile"),
    pytest.param((200, 2, 100), (True, True, False), True, 4, 1024, 1.0,
                 id="streamed-U-rank-302"),
    pytest.param((300,), (True,), True, 4, 100, 1.0, id="streamed-U-ragged-N100"),
    # layer 2's blocks as the iou pass carries them: only the first scaled
    pytest.param((57, 2, 57), (True, False, False), True, 128, 4096, 1.0,
                 id="main-path-scales-B128-116"),
])
def test_factored_ln_stats_bf16_entry_matches_plain(cuda_device, ranks, scaled, with_a, B,
                                                    N, u_mag):
    """Each scaled block's product scaled after it (a further scaled
    block's rows split into hi + lo) and fp32 sums: mu within 1e-4 and
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
    # edges of the 64-row layout: one partial position tile, one prompt,
    # four blocks whose rank steps end mid-step, all 64 rows live
    pytest.param((57, 2), (True, False), 40, 4, 7, 1.0, id="n40-one-partial-tile"),
    pytest.param((57, 2, 57, 2), (True, True, True, False), 4096, 1, 7, 1.0, id="one-prompt"),
    pytest.param((5, 16, 3, 9), (True, False, True, False), 1024, 4, 7, 1.0,
                 id="four-blocks-mixed-scales"),
    pytest.param((64, 64), (True, False), 4096, 4, 8, 1.0, id="eight-tokens-rank-128"),
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
    # edges of the 64-row layout, as K3's: one partial position tile, one
    # prompt, all 64 rows live at rank 128
    pytest.param(4, (57, 2), (True, False), True, 40, 7, id="n40-one-partial-tile"),
    pytest.param(1, (57, 2), (True, False), True, 4096, 7, id="one-prompt"),
    pytest.param(4, (64, 64), (True, False), True, 4096, 8, id="eight-tokens-rank-128"),
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,heads,hd,in_global", [
    pytest.param(1, (1, 1000), 1, 16, True, id="1-1x1000-1-16"),
    pytest.param(1, (8, 512), 2, 64, False, id="1-8x512-2-64"),
    pytest.param(2, (8, 1024), 2, 64, True, id="2-8x1024-2-64"),
    pytest.param(1, (2, 700), 2, 80, True, id="1-2x700-2-80"),
])
def test_flash_attention_relpos_bf16_tables_in_global_memory(cuda_device, B, hw, heads, hd,
                                                             in_global):
    """Grids whose rel-pos tables do not fit a block's shared memory beside
    the ring (1 x 1000 at hd 16 wants 257 KB of tables) take the second
    instantiation: a pre-pass forms the tables in the plain version's FMA
    order into global memory and the attention reads them from there. 8 x
    512 at hd 64 fits (187 168 B) and keeps the shared tables. Both within
    atol 8e-3 of the plain version."""
    rng = np.random.RandomState(28)
    H, W = hw
    C = heads * hd
    assert relpos.bf16_tables_in_global(B, hw, heads, hd) == in_global
    qkv = _bf16_on_card(rng, cuda_device, (B, H * W, 3 * C))
    with torch.no_grad():
        qkv[..., :2 * C] *= 0.5
    rh = _bf16_on_card(rng, cuda_device, (2 * H - 1, hd), 0.1)
    rw = _bf16_on_card(rng, cuda_device, (2 * W - 1, hd), 0.1)
    got = relpos.flash_attention_relpos_bf16_cuda(qkv, rh, rw, hw, heads)
    _bf16_close(got, relpos.flash_attention_relpos_bf16_plain(qkv, rh, rw, hw, heads))


def _nms_problem(case, device):
    boxes, scores, valid, groups, rounds = nms_case(case)
    b = torch.from_numpy(boxes).to(device)
    same = torch.from_numpy(groups[:, None] == groups[None, :]).to(device)
    overlap = masks.nms_overlap(masks.box_iou(b, b), torch.from_numpy(scores).to(device),
                                torch.from_numpy(valid).to(device), same, 0.5)
    return overlap, torch.from_numpy(valid).to(device), rounds


@pytest.mark.cuda
@pytest.mark.parametrize("case", NMS_CASES + ["single", "isolated_128"])
def test_nms_fixed_point_kernel_equals_plain(cuda_device, case):
    """One launch of the fixed-point kernel keeps exactly the plain loop's
    set in as many rounds (N = 3072 packs O into a workspace, N <= 1280 into
    shared memory)."""
    overlap, valid, rounds_want = _nms_problem(case, cuda_device)
    before = nms.nms_fixed_point_cuda.launches
    keep, rounds = nms.nms_fixed_point_cuda(overlap, valid)
    assert nms.nms_fixed_point_cuda.launches == before + 1
    want_keep, want_rounds = nms.nms_fixed_point_plain(overlap, valid)
    assert torch.equal(keep, want_keep) and int(rounds) == int(want_rounds)
    if rounds_want is not None:
        assert int(rounds) == rounds_want


def _tiny_dinov2_pipeline(device, segmentor=None, dtype=torch.float32):
    """ISM at a tiny DINOv2 the kernels take (C = 64, 2 heads of hd 32, 2
    blocks, 224 crops of 257 tokens, chunks of 16), seeded random weights."""
    from sam6d_torch.core.config import DINOv2Config, ISMConfig, ISMMatchingConfig
    from sam6d_torch.pipelines.ism import ISMPipeline
    cfg = ISMConfig(dinov2=DINOv2Config(embed_dim=64, depth=2, num_heads=2),
                    matching=ISMMatchingConfig(confidence_thresh=-1.0,
                                               pointcloud_sample_num=256))
    return ISMPipeline(cfg, seed=0, device=device, segmentor=segmentor, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_graph_describe_equals_the_eager_loop(cuda_device, dtype):
    """The describe graph (an IF node a chunk) with a device n_needed runs
    ceil(n / 16) chunk bodies, as the eager loop with a host n: the same
    descriptors (within 1e-5: the bodies replay the eager calls' kernels),
    the rows past the prefix exactly zero, and K5 launched depth x chunks
    times by the count settled from the graph's device counter."""
    from sam6d_torch.kernels.graphs import settle_graph_launches
    pipe = _tiny_dinov2_pipeline(cuda_device, dtype=dtype)
    imgs = torch.from_numpy(np.random.RandomState(3).rand(40, 224, 224, 3).astype(np.float32))
    imgs = imgs.to(cuda_device)
    k5 = (attention_qkv.fused_attention_qkv_bf16_cuda if dtype == torch.bfloat16
          else attention_qkv.fused_attention_qkv_cuda)
    with torch.inference_mode():
        graph = pipe.describe_graph(3)
        assert graph.node_types.get("kernel", 0) > 0
        for n in (0, 1, 16, 17, 40):
            settle_graph_launches()
            before = k5.launches
            cls, patch = pipe._dino_forward_chunked(
                imgs, torch.tensor(n, dtype=torch.int32, device=cuda_device))
            settle_graph_launches()
            chunks = -(-n // 16)
            assert k5.launches - before == pipe.cfg.dinov2.depth * chunks
            want_cls, want_patch = pipe._dino_forward_chunked(imgs, n)
            assert float((cls.float() - want_cls.float()).abs().max()) <= 1e-5
            assert float((patch.float() - want_patch.float()).abs().max()) <= 1e-5
            assert not cls[16 * chunks:].any() and not patch[16 * chunks:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_segmentor_frame_graph_equals_the_eager_amg(cuda_device, tmp_path, dtype):
    """generate_masks_device on the card replays the encoder and the AMG
    tail as one captured graph: its masks, boxes and valid flags equal the
    eager call's on the same frame, its IoUs within 1e-5, and each replay
    counts K1-K4 and the NMS kernel as the eager call launches them."""
    stream, frames = _tiny_card_stream(tmp_path, dtype)
    seg = stream.ism.segmentor
    rgb = frames[0][0]
    counted = [relpos.flash_attention_relpos_cuda, relpos.flash_attention_relpos_bf16_cuda,
               nms.nms_fixed_point_cuda, factored.factored_ln_stats_cuda,
               factored.factored_ln_stats_bf16_cuda]
    for _ in range(2):   # the first call builds the graph
        before = [fn.launches for fn in counted]
        got = seg.generate_masks_device(rgb)
        graph_launches = [fn.launches - b for fn, b in zip(counted, before)]
    resized, _, (hs, ws), (h_in, w_in) = seg.preprocess_frame_u8(rgb)
    Ry, Rx, pts = seg.frame_constants(hs, ws, h_in, w_in)
    before = [fn.launches for fn in counted]
    with torch.inference_mode():
        want = seg._propose_impl(seg._encode_u8(torch.as_tensor(resized, device=cuda_device)),
                                 pts, Ry, Rx)
    assert graph_launches == [fn.launches - b for fn, b in zip(counted, before)]
    for k, w in zip(("masks", "boxes", "valid"), want):
        assert torch.equal(got[k], w), k
    assert float((got["iou_preds"] - want[3]).abs().max()) <= 1e-5


# ~0.5 s of the card's clock (1.98 GHz boost): longer than submit_frame's
# host time at these widths
SLEEP_CYCLES = 1_000_000_000


def _tiny_card_stream(tmp_path, dtype):
    """MultiObjectStream on the card at tiny widths the kernels take: SAM
    with a C = 64 encoder of 2 blocks (hd 16) and the full-width decoder
    (K2-K4 take C = 256), an 8 x 8 prompt grid, capacity 32; the tiny
    DINOv2; a small PEM; two box objects rendered on the card; three
    random 480 x 640 frames."""
    from sam6d_torch.core.config import (GeoEmbeddingConfig, PEMConfig,
                                         PointMatchingConfig, SAMConfig, ViTConfig)
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import box_ply
    from sam6d_torch.pipelines.pem import PEMPipeline
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    from sam6d_torch.pipelines.streaming import MultiObjectStream
    from sam6d_torch.render.templates import render_templates
    seg = SAMSegmentor(SAMConfig(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
                                 encoder_global_attn_indexes=(1,), points_per_side=8,
                                 points_per_batch=64, pred_iou_thresh=-10.0,
                                 stability_score_thresh=0.0, max_proposals=32,
                                 amg_nms_topk=192), seed=0, device="cuda", dtype=dtype)
    ism = _tiny_dinov2_pipeline("cuda", segmentor=seg, dtype=dtype)
    pem_cfg = PEMConfig(
        coarse_npoint=24, fine_npoint=96,
        vit=ViTConfig(patch_size=16, embed_dim=64, depth=4, num_heads=4, img_size=64,
                      out_dim=32),
        geo_embedding=GeoEmbeddingConfig(hidden_dim=32),
        coarse=PointMatchingConfig(nblock=2, input_dim=32, hidden_dim=32, out_dim=32,
                                   nproposal1=120, nproposal2=30),
        fine=PointMatchingConfig(nblock=2, input_dim=32, hidden_dim=32, out_dim=32,
                                 pe_nsample1=8, pe_nsample2=16),
        img_size=64, n_sample_model_point=64, n_sample_observed_point=96,
        n_sample_template_point=200, n_template_view=2)
    pem = PEMPipeline(pem_cfg, seed=0, device="cuda")
    stream = MultiObjectStream(ism, pem, det_score_thresh=-1.0)
    rng = np.random.RandomState(0)
    for i, half in enumerate(((40.0, 30.0, 20.0), (25.0, 25.0, 35.0))):
        cad = str(tmp_path / f"obj{i}.ply")
        box_ply(cad, half)
        mesh = load_ply(cad)
        tdir = render_templates(mesh, str(tmp_path / f"obj{i}"), device="cuda")
        stream.onboard_object(i + 1, tdir, mesh.sample(64, rng) / 1000.0,
                              ism_points=mesh.sample(256, rng) / 1000.0)
    K = np.array([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1]], np.float32)
    frames = [((rng.rand(480, 640, 3) * 255).astype(np.uint8),
               (rng.rand(480, 640) * 400 + 400).astype(np.float32), K, 1.0)
              for _ in range(3)]
    return stream, frames


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_submit_frame_waits_on_nothing(cuda_device, tmp_path, dtype):
    """After finish_onboarding, submit_frame raises nothing under
    torch.cuda.set_sync_debug_mode("error") (no synchronizing call) and
    returns while a ~0.5 s torch.cuda._sleep queued before it is still
    running; the frames then complete with poses."""
    stream, frames = _tiny_card_stream(tmp_path, dtype)
    stream.finish_onboarding()
    for item in frames:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        after_sleep = torch.cuda.Event()
        after_sleep.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stream.submit_frame(*item)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not after_sleep.query(), "submit_frame waited for the card"
        res = stream.complete_frame()
        assert res["detections"] and len(res["poses"]) == len(res["detections"])
        for p in res["poses"]:
            R = np.asarray(p["R"])
            assert np.allclose(R @ R.T, np.eye(3), atol=1e-3) and np.isfinite(p["t"]).all()
