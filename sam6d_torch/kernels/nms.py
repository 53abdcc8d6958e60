"""Greedy NMS to its fixed point: the CUDA kernel (`csrc/nms.cu`), its plain
PyTorch version, and the device dispatch.

Replaces no Pallas kernel. The JAX package runs its NMS as an XLA
`lax.while_loop` (`sam6d_tpu/ops/masks.py:143` `nms_masked`), on the device
with no host read; the plain version's loop reads its undecided flag on the
host once a round, so on the card the kernel runs every round in one launch
and the frame chain (the AMG's box NMS, ISM's per-object NMS, FastSAM's)
waits on nothing.

What bounds it on the card: the (N, N) matrix is read once (9.4 MB at the
AMG's N = 3072: 2.8 us of HBM); the rounds form a chain, each needing the
one before, so they run in one block and take one SM's latency and L2
bandwidth (`csrc/nms.cu`'s header).

Semantics shared by both versions: `overlap` (N, N) bool, overlap[i, j] set
where j ranks above i and the two overlap in one group
(`ops/masks.nms_overlap`); invalid slots start suppressed; each round keeps
every undecided candidate with no higher-ranked overlapping candidate kept
or undecided and suppresses every one with a higher-ranked overlapping
candidate kept; the loop stops when none is undecided. Returns (keep (N,)
bool, rounds () int32), on the device of `overlap`.
"""
from __future__ import annotations

import torch

from ._build import check, load_library


def nms_fixed_point_plain(overlap: torch.Tensor, valid: torch.Tensor):
    """The fixed point as torch ops: each round's two reductions as one
    (N, N) @ (N, 2) product (0/1 terms summed in fp32, only the sign read);
    the undecided test is read on the host once a round."""
    O = overlap.to(torch.float32)
    kept = torch.zeros(overlap.shape[0], dtype=torch.bool, device=overlap.device)
    # invalid slots start suppressed: never kept, never blocking
    supp = ~valid.to(torch.bool)
    rounds = 0
    while bool((~kept & ~supp).any()):
        und = ~kept & ~supp
        R = O @ torch.stack([(~supp).to(torch.float32), kept.to(torch.float32)], dim=1)
        kept, supp = kept | (und & ~(R[:, 0] > 0)), supp | (und & (R[:, 1] > 0))
        rounds += 1
    return kept, torch.tensor(rounds, dtype=torch.int32, device=overlap.device)


def nms_fixed_point_cuda(overlap: torch.Tensor, valid: torch.Tensor):
    """The CUDA kernel: same contract as nms_fixed_point_plain, one launch,
    no host read."""
    name = "nms_fixed_point_cuda"
    if not (overlap.is_cuda and valid.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    N = valid.shape[0] if valid.dim() == 1 else -1
    if (overlap.dtype != torch.bool or valid.dtype != torch.bool
            or tuple(overlap.shape) != (N, N) or N < 1):
        raise ValueError(f"{name}: overlap must be (N, N) bool and valid (N,) bool, got "
                         f"{tuple(overlap.shape)} {overlap.dtype}, {tuple(valid.shape)} "
                         f"{valid.dtype}")
    overlap, valid = overlap.contiguous(), valid.contiguous()
    lib = load_library()
    ws_bytes = lib.sam6d_nms_workspace_bytes(N)
    workspace = (torch.empty(ws_bytes // 4, dtype=torch.int32, device=overlap.device)
                 if ws_bytes else None)
    keep = torch.empty(N, dtype=torch.bool, device=overlap.device)
    rounds = torch.empty((), dtype=torch.int32, device=overlap.device)
    stream = torch.cuda.current_stream(overlap.device).cuda_stream
    err = lib.sam6d_nms_fixed_point(overlap.data_ptr(), valid.data_ptr(),
                                    None if workspace is None else workspace.data_ptr(),
                                    N, keep.data_ptr(), rounds.data_ptr(), stream)
    nms_fixed_point_cuda.launches += 1
    check(err, name)
    return keep, rounds


nms_fixed_point_cuda.launches = 0


def nms_fixed_point(overlap: torch.Tensor, valid: torch.Tensor):
    """`torch.ops.sam6d.nms_fixed_point` (kernels/ops.py): CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    return torch.ops.sam6d.nms_fixed_point(overlap, valid)
