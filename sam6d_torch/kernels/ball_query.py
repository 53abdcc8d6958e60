"""Two-scale ball query: the CUDA kernel (`csrc/ball_query.cu`), its plain
PyTorch version, and the device dispatch.

Replaces `sam6d_tpu/kernels/ball_query.py::two_scale_ball_query_pallas` (XLA
twin: `sam6d_tpu/ops/ball_query.py::two_scale_ball_query`), the neighbour
search of the fine positional encoding: for each query the first s1 indices
within r1 and the first s2 within r2, in index order, empty slots repeating
the first hit (0 if none).

What bounds it on the card: the plain version materialises the (B, M, N)
distance matrix and an index tensor of the same size and runs a top-k over
both (16 x 2048 x 2048 per frame: ~0.5 GB of memory traffic per scale). The
kernel forms no matrix. `ball_query_path` picks one of two paths from the
shape: "lanes" (the frame's 16 clouds) stages a cloud's candidates in
shared memory once (1024 at a time) for a warp of 32 queries, one a lane,
which tests 32 staged candidates at a time into hit masks and writes the
hits to its query's next slots in index order; "warps" (one cloud at
onboarding, too few queries for that to fill the card) walks the
candidates with one warp a query, turning ballot/popc prefix counts into
slot positions. Both stop when every quota is full, so the work scales
with neighbourhood density, not N.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check, load_library
from ..ops.geometry import pairwise_sq_distance


def first_k_hits(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """hit (..., N) bool -> (..., nsample) int32: indices of the first
    `nsample` set entries in index order; empty slots get N."""
    N = hit.shape[-1]
    ar = torch.arange(N, dtype=torch.int32, device=hit.device)
    key = torch.where(hit, ar, torch.tensor(N, dtype=torch.int32,
                                            device=hit.device))
    k = min(nsample, N)
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        idx = torch.cat([idx, idx.new_full((*idx.shape[:-1], nsample - k), N)],
                        dim=-1)
    return idx


def _fill_tail(idx: torch.Tensor, n: int) -> torch.Tensor:
    valid = idx < n
    first = torch.where(valid[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
    return torch.where(valid, idx, first).to(torch.int32)


def two_scale_ball_query_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                               r1: float, s1: int, r2: float, s2: int):
    """xyz (B, N, 3) candidates, new_xyz (B, M, 3) queries ->
    (idx1 (B, M, s1), idx2 (B, M, s2)) int32."""
    d2 = pairwise_sq_distance(new_xyz.detach(), xyz.detach())
    N = xyz.shape[1]
    return (_fill_tail(first_k_hits(d2 < r1 * r1, s1), N),
            _fill_tail(first_k_hits(d2 < r2 * r2, s2), N))


def ball_query_path(B: int, M: int, sms: int) -> str:
    """The kernel path for B clouds of M queries on a card of `sms`
    multiprocessors: "lanes" (a block of 32 queries, one a lane, on staged
    candidates) when that gives every multiprocessor a block, else "warps"
    (one warp a query)."""
    return "lanes" if B * -(-M // 32) >= sms else "warps"


def two_scale_ball_query_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor,
                              r1: float, s1: int, r2: float, s2: int):
    """The CUDA kernel: same contract as two_scale_ball_query_plain."""
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 \
                or t.shape[2] != 3:
            raise ValueError(f"{name} must be a (B, *, 3) float32 CUDA tensor, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if s1 < 1 or s2 < 1:
        raise ValueError(f"sample counts must be positive: {s1}, {s2}")
    lib = load_library()
    dev = xyz.device
    # indices carry no gradient: the kernel reads the values only
    xt = xyz.detach().permute(0, 2, 1).contiguous()       # (B, 3, N)
    qt = new_xyz.detach().permute(0, 2, 1).contiguous()   # (B, 3, M)
    out1 = torch.empty((B, M, s1), dtype=torch.int32, device=dev)
    out2 = torch.empty((B, M, s2), dtype=torch.int32, device=dev)
    # radii squared in float32, as the plain version's comparison sees them
    r1sq = float(np.float32(r1 * r1))
    r2sq = float(np.float32(r2 * r2))
    path = ball_query_path(B, M, torch.cuda.get_device_properties(dev).multi_processor_count)
    err = lib.sam6d_two_scale_ball_query(
        xt.data_ptr(), qt.data_ptr(), B, N, M, r1sq, s1, r2sq, s2, int(path == "lanes"),
        out1.data_ptr(), out2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    two_scale_ball_query_cuda.launches += 1
    check(err, "two_scale_ball_query_cuda")
    return out1, out2


two_scale_ball_query_cuda.launches = 0


def two_scale_ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor,
                         r1: float, s1: int, r2: float, s2: int):
    """`torch.ops.sam6d.two_scale_ball_query` (kernels/ops.py): a CUDA
    tensor goes to the kernel, a CPU tensor to the plain version."""
    return torch.ops.sam6d.two_scale_ball_query(xyz, new_xyz, r1, s1, r2, s2)
