"""SAM ViTDet attention with the decomposed relative-position bias: the CUDA
kernel (`csrc/attention_relpos.cu`), its plain PyTorch version, and the
device dispatch.

Replaces `sam6d_tpu/kernels/flash_attention.py::flash_attention_relpos`
(through `_fused_attention`), which runs in every attention of the SAM
image encoder: 28 windowed blocks (25 windows of 14x14 tokens) and 4 global
blocks (64x64 tokens) per frame, 16 heads of hd 80.

    out = softmax(q k^T / sqrt(hd) + rel_h_q[n, row(m)] + rel_w_q[n, col(m)]) v

with rel_h_q[n, kh] = q[n] . rel_pos_h[row(n) - kh + H - 1] (unscaled q),
rel_w_q likewise over columns (reference add_decomposed_rel_pos,
image_encoder.py:325-361). The plain version computes the thin tables
rel_h_q (N x H) and rel_w_q (N x W) with two small einsums, as the TPU
wrapper does; the kernel forms its rows of them itself and adds the bias to
its score fragments, so neither the tables nor the N x N scores reach
memory.

What bounds it on the card: a global block is 4 * 16 * 4096^2 * 80 = 85.9
GFLOP on 84 MB, bound by operations: 1.28 ms on the fp32 FMA units (67
TFLOP/s), 0.52 ms on the tensor cores in three-pass TF32 (495/3 TFLOP/s),
which is how the kernel runs its products at fp32 accuracy. A windowed
block (25 windows of 196 tokens) is 4.9 GFLOP on 100 MB.

Semantics shared by every version: qkv (B, N, 3C) laid out [q | k | v] with
heads contiguous (hd = C // heads), N = H * W row-major; scores and softmax
in fp32; every token attends to every token of its window, the zero pad
tokens of the windowed blocks included, as the reference does; the output
(B, N, C) holds each head at its channel offset.

A bfloat16 qkv with bfloat16 rel-pos tables (the weights' dtype) takes the
bf16 entry (`csrc/attention_relpos.cu` on the core of `csrc/bf16_wgmma.cuh`:
`wgmma` for both products, K/V tiles by TMA; a grid whose tables do not fit
a block's shared memory beside the ring is refused) or, on the
CPU, its plain version: the tables formed in fp32 from the bf16 q and
rel-pos rows and rounded to bf16, as the TPU wrapper casts them before its
kernel (flash_attention.py:337-372), each entry summed in the kernel's
order (`bf16_rel_pos_tables`); q enters the product as
bf16(q * bf16(scale)); then the bf16 contract of
`attention.bf16_attention_plain`, bf16 out.
"""
from __future__ import annotations

import torch

from ._build import check, load_library
from .attention import bf16_attention_plain, bf16_scale

KERNEL_HEAD_DIMS = (16, 32, 64, 80)


def rel_pos_tables(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                   rel_pos_w: torch.Tensor, hw, heads: int):
    """(rel_h_q (B, heads, N, H), rel_w_q (B, heads, N, W)), contiguous
    float32: the decomposed bias terms of every query, from the unscaled q
    third of `qkv` (reference get_rel_pos for q_size == k_size, as the JAX
    package's _rel_pos_bias)."""
    B, N, C3 = qkv.shape
    H, W = hw
    C = C3 // 3
    hd = C // heads
    dev = qkv.device
    idx_h = (torch.arange(H, device=dev)[:, None] - torch.arange(H, device=dev)[None, :]
             + (H - 1))
    idx_w = (torch.arange(W, device=dev)[:, None] - torch.arange(W, device=dev)[None, :]
             + (W - 1))
    Rh = rel_pos_h[idx_h]                                   # (H, H, hd)
    Rw = rel_pos_w[idx_w]                                   # (W, W, hd)
    q = qkv[..., :C].reshape(B, H, W, heads, hd)
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", q, Rh).reshape(B, heads, N, H)
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", q, Rw).reshape(B, heads, N, W)
    return rel_h.contiguous(), rel_w.contiguous()


def bf16_rel_pos_tables(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                        rel_pos_w: torch.Tensor, hw, heads: int):
    """The bf16 entry's tables (rel_h_q (B, heads, N, H), rel_w_q (B, heads,
    N, W)) as float32 holding bf16 values, from bf16 qkv and rel-pos rows,
    each entry summed as the kernel sums it: the exact fp32 products of the
    even channels in one running fp32 sum and of the odd ones in another,
    channel by channel, the two sums added and rounded to bf16 once. (An
    einsum sums in another order, and where an entry is large an order may
    round it one bf16 ulp the other way: 2^-5 at |4..8|.)"""
    B, N, C3 = qkv.shape
    H, W = hw
    C = C3 // 3
    hd = C // heads
    f = torch.float32
    dev = qkv.device
    idx_h = (torch.arange(H, device=dev)[:, None] - torch.arange(H, device=dev)[None, :]
             + (H - 1))
    idx_w = (torch.arange(W, device=dev)[:, None] - torch.arange(W, device=dev)[None, :]
             + (W - 1))
    Rh = rel_pos_h.to(f)[idx_h]                             # (H, H, hd)
    Rw = rel_pos_w.to(f)[idx_w]                             # (W, W, hd)
    q = qkv[..., :C].to(f).reshape(B, H, W, heads, hd).permute(0, 3, 1, 2, 4)
    sums_h = [torch.zeros(B, heads, H, W, H, dtype=f, device=dev) for _ in range(2)]
    sums_w = [torch.zeros(B, heads, H, W, W, dtype=f, device=dev) for _ in range(2)]
    for d in range(hd):
        qd = q[..., d, None]                                # (B, heads, H, W, 1)
        sums_h[d % 2] = sums_h[d % 2] + qd * Rh[:, None, :, d]
        sums_w[d % 2] = sums_w[d % 2] + qd * Rw[None, :, :, d]
    return tuple((a + b).to(torch.bfloat16).to(f).reshape(B, heads, N, -1)
                 for a, b in (sums_h, sums_w))


def flash_attention_relpos_plain(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                                 rel_pos_w: torch.Tensor, hw,
                                 heads: int) -> torch.Tensor:
    """qkv (B, N, 3C) float32 -> (B, N, C): scores and bias materialized,
    the arithmetic of the JAX package's `attend` (models/sam.py:197-207)."""
    B, N, C3 = qkv.shape
    H, W = hw
    hd = C3 // 3 // heads
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = rel_pos_tables(qkv, rel_pos_h, rel_pos_w, hw, heads)
    bias = (rel_h.view(B, heads, N, H, 1) + rel_w.view(B, heads, N, 1, W))
    attn = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias.reshape(B, heads, N, N)
    out = torch.softmax(attn, dim=-1) @ v
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def flash_attention_relpos_cuda(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                                rel_pos_w: torch.Tensor, hw,
                                heads: int) -> torch.Tensor:
    """The CUDA kernel: same contract as flash_attention_relpos_plain. The
    kernel forms the rel-pos tables of its rows itself, from rel_pos_h and
    rel_pos_w."""
    if not qkv.is_cuda:
        raise ValueError("flash_attention_relpos_cuda takes a CUDA tensor")
    if qkv.dtype != torch.float32 or qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C) float32, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    B, N, C3 = qkv.shape
    H, W = hw
    if C3 % (3 * heads) or C3 // (3 * heads) not in KERNEL_HEAD_DIMS:
        raise ValueError(f"qkv width {C3} with {heads} heads: the kernel takes "
                         f"head dims {KERNEL_HEAD_DIMS}")
    hd = C3 // 3 // heads
    if N != H * W or not (0 < B <= 65535 and heads <= 65535):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not hold a {H}x{W} grid, "
                         f"or exceeds the launch grid")
    if tuple(rel_pos_h.shape) != (2 * H - 1, hd) or tuple(rel_pos_w.shape) != (2 * W - 1, hd):
        raise ValueError("rel_pos tables must be (2H-1, hd) and (2W-1, hd)")
    rel_pos_h = rel_pos_h.to(qkv.device, torch.float32).contiguous()
    rel_pos_w = rel_pos_w.to(qkv.device, torch.float32).contiguous()
    if not qkv.is_contiguous() or any(t.data_ptr() % 16 for t in (qkv, rel_pos_h, rel_pos_w)):
        raise ValueError("qkv must be contiguous, and qkv and the rel_pos tables "
                         "16-byte aligned")
    lib = load_library()
    out = torch.empty((B, N, C3 // 3), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.sam6d_flash_attention_relpos(
        qkv.data_ptr(), rel_pos_h.data_ptr(), rel_pos_w.data_ptr(), out.data_ptr(),
        B, N, heads, hd, H, W, float(hd ** -0.5), stream)
    flash_attention_relpos_cuda.launches += 1
    check(err, "flash_attention_relpos_cuda")
    return out


flash_attention_relpos_cuda.launches = 0


def flash_attention_relpos_bf16_plain(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                                      rel_pos_w: torch.Tensor, hw,
                                      heads: int) -> torch.Tensor:
    """bf16 qkv (B, N, 3C) and bf16 rel-pos tables -> bf16 (B, N, C): the
    bf16 entry's contract (the module docstring)."""
    B, N, C3 = qkv.shape
    H, W = hw
    hd = C3 // 3 // heads
    f = torch.float32
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = bf16_rel_pos_tables(qkv, rel_pos_h, rel_pos_w, hw, heads)
    bias = (rel_h.view(B, heads, N, H, 1) + rel_w.view(B, heads, N, 1, W))
    out = bf16_attention_plain(q, k, v, hd ** -0.5, prescale=True,
                               bias=bias.reshape(B, heads, N, N))
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def flash_attention_relpos_bf16_cuda(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                                     rel_pos_w: torch.Tensor, hw,
                                     heads: int) -> torch.Tensor:
    """The bf16 entry: same contract as flash_attention_relpos_bf16_plain."""
    name = "flash_attention_relpos_bf16_cuda"
    if not (qkv.is_cuda and rel_pos_h.is_cuda and rel_pos_w.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in (qkv, rel_pos_h, rel_pos_w)) or qkv.dim() != 3:
        raise ValueError(f"{name}: qkv (B, N, 3C) and the rel-pos tables must be bfloat16, "
                         f"got {tuple(qkv.shape)} {qkv.dtype}, {rel_pos_h.dtype}, "
                         f"{rel_pos_w.dtype}")
    B, N, C3 = qkv.shape
    H, W = hw
    if C3 % (3 * heads) or C3 // (3 * heads) not in KERNEL_HEAD_DIMS:
        raise ValueError(f"qkv width {C3} with {heads} heads: the kernel takes "
                         f"head dims {KERNEL_HEAD_DIMS}")
    hd = C3 // 3 // heads
    if N != H * W or not (0 < B <= 65535 and heads <= 65535):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not hold a {H}x{W} grid, "
                         f"or exceeds the launch grid")
    if tuple(rel_pos_h.shape) != (2 * H - 1, hd) or tuple(rel_pos_w.shape) != (2 * W - 1, hd):
        raise ValueError("rel_pos tables must be (2H-1, hd) and (2W-1, hd)")
    rel_pos_h, rel_pos_w = rel_pos_h.contiguous(), rel_pos_w.contiguous()
    if not qkv.is_contiguous() or any(t.data_ptr() % 16 for t in (qkv, rel_pos_h, rel_pos_w)):
        raise ValueError("qkv must be contiguous, and qkv and the rel_pos tables "
                         "16-byte aligned")
    lib = load_library()
    out = torch.empty((B, N, C3 // 3), dtype=torch.bfloat16, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.sam6d_flash_attention_relpos_bf16(
        qkv.data_ptr(), rel_pos_h.data_ptr(), rel_pos_w.data_ptr(), out.data_ptr(),
        B, N, heads, hd, H, W, bf16_scale(hd ** -0.5), stream)
    flash_attention_relpos_bf16_cuda.launches += 1
    check(err, name)
    return out


flash_attention_relpos_bf16_cuda.launches = 0


def flash_attention_relpos(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, hw,
                           heads: int) -> torch.Tensor:
    """`torch.ops.sam6d.flash_attention_relpos` (kernels/ops.py): a CUDA
    tensor goes to the kernel of its dtype (float32 or bfloat16; the rel-pos
    tables in the same dtype), a CPU tensor to the plain version of that
    dtype."""
    return torch.ops.sam6d.flash_attention_relpos(qkv, rel_pos_h, rel_pos_w,
                                                  list(hw), heads)
