"""Multi-head attention off a fused qkv projection: the CUDA kernel
(`csrc/attention_qkv.cu`), its plain PyTorch version, and the device
dispatch.

Replaces `sam6d_tpu/kernels/flash_attention.py::fused_attention_qkv`, which
runs in every DINOv2-L attention of the ISM describe (24 per 16-crop chunk).

What bounds it on the card: at B=16, N=257, 16 heads of hd 64 one call is
4.33 GFLOP on 67.4 MB, bound by operations: 65 us on the fp32 FMA units, 26
us on the tensor cores in three-pass TF32 (fp32 accuracy at 495/3 TFLOP/s),
which is how the kernel runs its products. It reads q, k and v straight
from the strided (B, N, 3C) tensor, so no (B, H, N, hd) copy and no
(B, H, N, N) score tensor reaches memory; see the header of
`csrc/attention_qkv.cu` and the core in `csrc/tf32x3.cuh`.

Semantics shared by every version: qkv is laid out [q | k | v] on the
channel axis with heads contiguous (hd = C // heads); scores and softmax in
fp32; the output (B, N, C) holds each head at its channel offset. A
bfloat16 qkv takes the bf16 entry (`csrc/attention_qkv.cu` on the core of
`csrc/bf16_wgmma.cuh`: `wgmma` for both products, K/V tiles by TMA) or, on
the CPU, its plain version: _qkv_kernel's bf16 contract
(`attention.bf16_attention_plain`), bf16 out.
"""
from __future__ import annotations

import torch

from ._build import check, load_library
from .attention import bf16_attention_plain

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


def fused_attention_qkv_bf16_plain(qkv: torch.Tensor, heads: int,
                                   scale: float) -> torch.Tensor:
    """bf16 qkv (B, N, 3C) -> bf16 (B, N, C): the bf16 contract with the fp32
    product scaled, as _qkv_kernel does."""
    B, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    out = bf16_attention_plain(q, k, v, scale, prescale=False)
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def fused_attention_qkv_bf16_cuda(qkv: torch.Tensor, heads: int,
                                  scale: float) -> torch.Tensor:
    """The bf16 entry: same contract as fused_attention_qkv_bf16_plain."""
    name = "fused_attention_qkv_bf16_cuda"
    if not qkv.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C) bfloat16, got "
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
    out = torch.empty((B, N, C3 // 3), dtype=torch.bfloat16, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.sam6d_fused_attention_qkv_bf16(qkv.data_ptr(), out.data_ptr(), B, N,
                                             heads, C3 // 3 // heads, float(scale),
                                             stream)
    fused_attention_qkv_bf16_cuda.launches += 1
    check(err, name)
    return out


fused_attention_qkv_bf16_cuda.launches = 0


def fused_attention_qkv(qkv: torch.Tensor, heads: int,
                        scale: float) -> torch.Tensor:
    """`torch.ops.sam6d.fused_attention_qkv` (kernels/ops.py): a CUDA tensor
    goes to the kernel of its dtype (float32 or bfloat16), a CPU tensor to
    the plain version of that dtype."""
    return torch.ops.sam6d.fused_attention_qkv(qkv, heads, scale)
