"""Farthest-point sampling: the CUDA kernel (`csrc/fps.cu`), its plain
PyTorch version, and the device dispatch.

Replaces `sam6d_tpu/kernels/fps.py::farthest_point_sample_pallas` (and the
XLA loop `sam6d_tpu/ops/sampling.py::farthest_point_sample`, which the JAX
package runs on every path).

What bounds it on the card: M-1 strictly dependent steps, each a sweep over
N points plus an argmax. Written as torch ops that is ~8 launches per step,
so the plain version is launch-bound (195 steps per frame, 2047 at
onboarding). The kernel keeps each cloud's points, running min-distance and
valid flags in one block's shared memory and runs all steps in one launch
(N <= FPS_SINGLE_BLOCK_MAX_N: the per-frame 16 x 2048 -> 196 and trunk
shapes). The onboarding cloud (42 views x 5000 = 210 000 points -> 2048) is
too large for one SM to sweep 2047 times quickly, so it takes a multi-block
path: one launch per step over ~100 blocks, each reducing the previous
step's per-block partials itself (no atomics, no grid barrier) — see the
header of `csrc/fps.cu`.

Semantics shared by both versions: start at the first valid index, invalid
points score -1 and are never picked, ties go to the lowest index (like
`argmax`), distance = dx*dx + dy*dy + dz*dz in that order.
"""
from __future__ import annotations

import torch

from ._build import check, load_library

FPS_SINGLE_BLOCK_MAX_N = 8192   # 17 bytes of shared memory per point
FPS_MULTI_BLOCK_CHUNK = 2048    # points per block in the multi-block path


def farthest_point_sample_plain(points: torch.Tensor, npoint: int,
                                valid_mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """points (B, N, 3) float32, valid_mask (B, N) bool -> (B, npoint) int32."""
    B, N, _ = points.shape
    dev = points.device
    valid = (torch.ones((B, N), dtype=torch.bool, device=dev)
             if valid_mask is None else valid_mask.to(torch.bool))
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    last = valid.to(torch.int32).argmax(dim=1)
    rows = torch.arange(B, device=dev)
    mindist = torch.full((B, N), 1e10, dtype=points.dtype, device=dev)
    neg = torch.tensor(-1.0, dtype=points.dtype, device=dev)
    idx = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    idx[:, 0] = last
    for i in range(1, npoint):
        dx = px - px[rows, last][:, None]
        dy = py - py[rows, last][:, None]
        dz = pz - pz[rows, last][:, None]
        mindist = torch.minimum(mindist, dx * dx + dy * dy + dz * dz)
        last = torch.where(valid, mindist, neg).argmax(dim=1)
        idx[:, i] = last
    return idx


def farthest_point_sample_cuda(points: torch.Tensor, npoint: int,
                               valid_mask: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The CUDA kernel: same contract as farthest_point_sample_plain."""
    if not points.is_cuda:
        raise ValueError("farthest_point_sample_cuda takes a CUDA tensor")
    if points.dtype != torch.float32 or points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (B, N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    B, N, _ = points.shape
    if N == 0 or npoint < 1:
        raise ValueError(f"bad FPS shape: N={N}, npoint={npoint}")
    if valid_mask is not None and (tuple(valid_mask.shape) != (B, N)
                                   or valid_mask.device != points.device):
        raise ValueError("valid_mask must be (B, N) on the points' device")
    lib = load_library()
    dev = points.device
    planar = points.permute(0, 2, 1).contiguous()          # (B, 3, N)
    valid = (torch.ones((B, N), dtype=torch.uint8, device=dev)
             if valid_mask is None
             else valid_mask.to(torch.uint8).contiguous())
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if N <= FPS_SINGLE_BLOCK_MAX_N:
        err = lib.sam6d_fps_single_block(planar.data_ptr(), valid.data_ptr(),
                                         B, N, npoint, out.data_ptr(), stream)
    else:
        nblk = -(-N // FPS_MULTI_BLOCK_CHUNK)
        mindist = torch.full((B, N), 1e10, dtype=torch.float32, device=dev)
        part_v = torch.empty((2, B, nblk), dtype=torch.float32, device=dev)
        part_i = torch.empty((2, B, nblk), dtype=torch.int32, device=dev)
        err = lib.sam6d_fps_multi_block(
            planar.data_ptr(), valid.data_ptr(), B, N, npoint,
            FPS_MULTI_BLOCK_CHUNK, mindist.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), out.data_ptr(), stream)
    farthest_point_sample_cuda.launches += 1
    check(err, "farthest_point_sample_cuda")
    return out


farthest_point_sample_cuda.launches = 0


def farthest_point_sample(points: torch.Tensor, npoint: int,
                          valid_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if points.device.type == "cuda":
        return farthest_point_sample_cuda(points, npoint, valid_mask)
    if points.device.type == "cpu":
        return farthest_point_sample_plain(points, npoint, valid_mask)
    raise ValueError(f"no FPS for device {points.device}")
