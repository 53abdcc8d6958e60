"""Farthest-point sampling: the CUDA kernel (`csrc/fps.cu`), its plain
PyTorch version, and the device dispatch.

Replaces `sam6d_tpu/kernels/fps.py::farthest_point_sample_pallas` (and the
XLA loop `sam6d_tpu/ops/sampling.py::farthest_point_sample`, which the JAX
package runs on every path).

What bounds it on the card: M strictly dependent steps, each a sweep over
N points plus an argmax. Written as torch ops that is ~8 launches per step,
so the plain version is launch-bound (195 steps per frame, 2047 at
onboarding). The kernel runs all steps in one launch, and a step is one
sweep, a warp reduction of packed (score, index) keys and one barrier, plus
on the cluster path a wait for the other blocks' winners (`csrc/fps.cu`'s
header). `fps_path` picks the path from N alone:

* ``"block"`` (N <= FPS_BLOCK_MAX_N: the per-frame 16 x 2048 -> 196 and
  trunk shapes): one block a cloud, points in registers;
* ``"cluster"`` (N <= FPS_CLUSTER_MAX_N: the onboarding cloud, 42 views x
  5000 = 210 000 points -> 2048): one 16-block thread block cluster a
  cloud, which agrees on each pick through distributed shared memory;
* ``"multi"`` (larger N): one launch per step over many blocks.

Semantics shared by every version: start at the first valid index, invalid
points score -1 and are never picked, ties go to the lowest index (like
`argmax`), distance = dx*dx + dy*dy + dz*dz in that order.
"""
from __future__ import annotations

import ctypes
import statistics

import torch

from ._build import check, load_library

# as in csrc/fps.cu: 256 threads x 16 points a thread; 16 blocks x 896
# threads x 16 points a thread
FPS_BLOCK_MAX_N = 256 * 16
FPS_CLUSTER_BLOCKS = 16
FPS_CLUSTER_MAX_N = FPS_CLUSTER_BLOCKS * 896 * 16
FPS_MULTI_BLOCK_CHUNK = 2048    # points per block in the multi-block path


def fps_path(n: int) -> str:
    """The kernel path for clouds of `n` points: "block", "cluster" or
    "multi"."""
    if n <= FPS_BLOCK_MAX_N:
        return "block"
    if n <= FPS_CLUSTER_MAX_N:
        return "cluster"
    return "multi"


def farthest_point_sample_plain(points: torch.Tensor, npoint: int,
                                valid_mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """points (B, N, 3) float32, valid_mask (B, N) bool -> (B, npoint) int32."""
    points = points.detach()
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
    # indices carry no gradient: the kernel reads the values only
    planar = points.detach().permute(0, 2, 1).contiguous()  # (B, 3, N)
    valid = (torch.ones((B, N), dtype=torch.uint8, device=dev)
             if valid_mask is None
             else valid_mask.to(torch.uint8).contiguous())
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    path = fps_path(N)
    if path == "block":
        err = lib.sam6d_fps_block(planar.data_ptr(), valid.data_ptr(), B, N,
                                  npoint, out.data_ptr(), stream)
    elif path == "cluster":
        check_cluster_resident(N)
        err = lib.sam6d_fps_cluster(planar.data_ptr(), valid.data_ptr(), B, N,
                                    npoint, out.data_ptr(), stream)
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

_resident_clusters: dict[int, int] = {}


def check_cluster_resident(n: int) -> int:
    """How many 16-block clusters of the cluster path's shape for `n` points
    the card holds at once (cudaOccupancyMaxActiveClusters, queried once a
    cloud size); raises, with the shape, if not even one fits."""
    if n not in _resident_clusters:
        clusters, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        check(load_library().sam6d_fps_cluster_occupancy(
            n, ctypes.byref(clusters), ctypes.byref(threads), ctypes.byref(smem)),
            "cudaOccupancyMaxActiveClusters")
        if clusters.value < 1:
            raise RuntimeError(
                f"FPS cluster path for N={n}: a cluster of {FPS_CLUSTER_BLOCKS} "
                f"blocks of {threads.value} threads and {smem.value} bytes of "
                f"shared memory a block cannot be resident "
                f"(cudaOccupancyMaxActiveClusters = {clusters.value})")
        _resident_clusters[n] = clusters.value
    return _resident_clusters[n]


def step_sync_us(path: str, n: int, steps: tuple[int, int] = (256, 2304),
                 reps: int = 5) -> float:
    """The least latency of one FPS step's synchronisation on the card, in
    µs, with no sweep: `path` "block" times the block path's redux pair,
    barrier and redux pair over its 256 threads; "cluster" adds, at the
    cluster path's shape for `n` points, the winner sent to the 16 blocks'
    mailboxes through distributed shared memory, the mbarrier wait and the
    16-slot reduction. The median over `reps` of the difference between two
    chained runs of `steps`, over their difference, so the launch cancels.
    Counts no launch of `farthest_point_sample_cuda`."""
    if path not in ("block", "cluster"):
        raise ValueError(f"no step probe for path {path!r}")
    lib = load_library()
    scratch = torch.empty(FPS_CLUSTER_BLOCKS, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_ms(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        check(lib.sam6d_fps_latency(int(path == "cluster"), n, k,
                                    scratch.data_ptr(), stream), "sam6d_fps_latency")
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    run_ms(steps[0])
    per_step = [(run_ms(steps[1]) - run_ms(steps[0])) / (steps[1] - steps[0])
                for _ in range(reps)]
    return 1e3 * statistics.median(per_step)


def farthest_point_sample(points: torch.Tensor, npoint: int,
                          valid_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """`torch.ops.sam6d.farthest_point_sample` (kernels/ops.py): a CUDA
    tensor goes to the kernel, a CPU tensor to the plain version."""
    return torch.ops.sam6d.farthest_point_sample(points, npoint, valid_mask)
