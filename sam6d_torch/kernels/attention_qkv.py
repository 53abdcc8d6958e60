"""Multi-head attention off a fused qkv projection: the CUDA kernel
(`csrc/attention_qkv.cu`), its plain PyTorch version, and the device
dispatch.

Replaces `sam6d_tpu/kernels/flash_attention.py::fused_attention_qkv`, which
runs in every DINOv2-L attention of the ISM describe (24 per 16-crop chunk).

What bounds it on the card: at B=16, N=257, 16 heads of hd 64 one call is
4.33 GFLOP on 67.4 MB, compute-bound on the fp32 FMA units (TF32 off). The
kernel reads q, k and v straight from the strided (B, N, 3C) tensor, so no
(B, H, N, hd) copy and no (B, H, N, N) score tensor reaches memory; see the
header of `csrc/attention_qkv.cu`.

Semantics shared by both versions: qkv is laid out [q | k | v] on the
channel axis with heads contiguous (hd = C // heads); scores and softmax in
fp32; the output (B, N, C) holds each head at its channel offset.
"""
from __future__ import annotations

import torch

from ._build import check, load_library

KERNEL_HEAD_DIMS = (32, 64)


def _split_heads(qkv: torch.Tensor, heads: int):
    """(B, N, 3C) -> q, k, v as strided (B, H, N, hd) views (no copy)."""
    B, N, C3 = qkv.shape
    hd = C3 // 3 // heads
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    return q, k, v


def fused_attention_qkv_plain(qkv: torch.Tensor, heads: int,
                              scale: float) -> torch.Tensor:
    """qkv (B, N, 3C) float32 -> (B, N, C): explicit matmul + softmax, the
    arithmetic of the port's ViT attention."""
    B, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    attn = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    return (attn @ v).transpose(1, 2).reshape(B, N, C3 // 3)


def fused_attention_qkv_cuda(qkv: torch.Tensor, heads: int,
                             scale: float) -> torch.Tensor:
    """The CUDA kernel: same contract as fused_attention_qkv_plain."""
    if not qkv.is_cuda:
        raise ValueError("fused_attention_qkv_cuda takes a CUDA tensor")
    if qkv.dtype != torch.float32 or qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C) float32, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    B, N, C3 = qkv.shape
    if C3 % (3 * heads) or C3 // (3 * heads) not in KERNEL_HEAD_DIMS:
        raise ValueError(f"qkv width {C3} with {heads} heads: the kernel takes "
                         f"head dims {KERNEL_HEAD_DIMS}")
    if not (0 < B <= 65535 and 0 < N and heads <= 65535):
        raise ValueError(f"qkv {tuple(qkv.shape)} with {heads} heads is empty "
                         f"or exceeds the launch grid (B, heads <= 65535)")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    lib = load_library()
    out = torch.empty((B, N, C3 // 3), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.sam6d_fused_attention_qkv(qkv.data_ptr(), out.data_ptr(), B, N,
                                        heads, C3 // 3 // heads, float(scale),
                                        stream)
    fused_attention_qkv_cuda.launches += 1
    check(err, "fused_attention_qkv_cuda")
    return out


fused_attention_qkv_cuda.launches = 0


def fused_attention_qkv(qkv: torch.Tensor, heads: int,
                        scale: float) -> torch.Tensor:
    """A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if qkv.device.type == "cuda":
        return fused_attention_qkv_cuda(qkv, heads, scale)
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, heads, scale)
    raise ValueError(f"no fused_attention_qkv for device {qkv.device}")
