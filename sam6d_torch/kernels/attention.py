"""Softmax attention on head-major (B, H, N, hd) operands: the two C entries
of `csrc/attention.cu` (one kernel on the three-pass TF32 core of
`csrc/tf32x3.cuh`), their plain PyTorch versions, and the device dispatches.

- `fused_attention` (K8) replaces
  `sam6d_tpu/kernels/flash_attention.py::fused_attention`: any Nq and Nk
  (self- or cross-attention), hd up to 128. `models/vit.Attention` sends
  every `use_flash` attention with N > 1024 to it, as the JAX package does;
  the ISM describe at `DINOv2Config(img_size=448)` (1025 tokens) runs it in
  each of its 24 blocks.
- `fused_attention_small` (K9) replaces
  `sam6d_tpu/kernels/flash_attention.py::fused_attention_small`: short
  self-attention sequences, hd 16, 32 or 64. Neither package calls it on a
  path; it is held to its plain version all the same.

Semantics shared by every version: out = softmax(q k^T * scale) v with the
scores and softmax in fp32; q (B, H, Nq, hd), k and v (B, H, Nk, hd); the
output (B, H, Nq, hd). The kernels read q, k and v through their strides
(the head dim must be contiguous), so the (B, H, N, hd) views of a fused
qkv projection need no copy. K8 returns a (B, H, Nq, hd) view of a (B, Nq,
H, hd) tensor, so `out.transpose(1, 2).reshape(B, Nq, H * hd)` is free.

What bounds them on the card: 4*B*H*Nq*Nk*hd operations, run as
fp32-accurate three-pass TF32 on the tensor cores; see the header of
`csrc/attention.cu`.

Each dispatch takes float32 or bfloat16 operands, all of one dtype, and
refuses any other: float32 goes to the fp32 entry, bfloat16 to the bf16
entry (`*_bf16_cuda`, one-pass bf16 `mma.sync` with fp32 accumulation;
K1's and K5's on `wgmma`, `csrc/bf16_wgmma.cuh`) or,
on the CPU, to the plain version of the bf16 contract
(`bf16_attention_plain`): the JAX package's bf16 kernels, with fp32
scores and softmax, p rounded to bf16 before P V, l summed from that
rounded p, and a bf16 output. No entry gives way to another.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, load_library

MAX_HEAD_DIM = 128
SMALL_HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def operand_dtype(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of `tensors`, float32 or bfloat16; raises on mixed
    dtypes and on any other."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 operands of one dtype, "
                         f"got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def bf16_scale(scale: float) -> float:
    """`scale` rounded to bf16: the constant the JAX kernels that scale q
    before the product (K1, K8) multiply by."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def bf16_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, prescale: bool,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 contract of the JAX kernels on bf16 (..., Nq, hd) x (...,
    Nk, hd) operands, in explicit fp32 arithmetic: scores in fp32 (with
    `prescale`, q enters as bf16(q * bf16(scale)), as in _fused_kernel;
    otherwise the fp32 product is scaled, as in _small_kernel and
    _qkv_kernel), plus an optional fp32 `bias`; p = exp(s - max) rounded to
    bf16; l the fp32 sum of the rounded p; (p V) / max(l, 1e-30) rounded to
    bf16."""
    f = torch.float32
    if prescale:
        qs = (q.to(f) * bf16_scale(scale)).to(torch.bfloat16).to(f)
        s = qs @ k.to(f).transpose(-1, -2)
    else:
        s = (q.to(f) @ k.to(f).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16).to(f)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ v.to(f)) / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """(B, H, Nq, hd) x (B, H, Nk, hd) -> (B, H, Nq, hd): explicit matmul +
    softmax + matmul in fp32."""
    attn = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    return attn @ v


def _check_operands(name, q, k, v, dtype=torch.float32):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if any(t.dtype != dtype or t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be (B, H, N, hd) {dtype}")
    B, H, Nq, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != hd:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not agree")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if not (0 < B <= 65535 and 0 < H <= 65535 and Nq > 0 and k.shape[2] > 0):
        raise ValueError(f"{name}: empty operands or a grid past 65535 blocks")
    return B, H, Nq, k.shape[2], hd


def fused_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The K8 kernel: same contract as fused_attention_plain."""
    B, H, Nq, Nk, hd = _check_operands("fused_attention_cuda", q, k, v)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"fused_attention_cuda takes hd <= {MAX_HEAD_DIM}, got {hd}")
    lib = load_library()
    out = torch.empty((B, Nq, H, hd), dtype=torch.float32, device=q.device)
    out_h = out.permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sam6d_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q),
        _strides(k), _strides(v), _strides(out_h), B, H, Nq, Nk, hd,
        float(scale), stream)
    fused_attention_cuda.launches += 1
    check(err, "fused_attention_cuda")
    return out_h


fused_attention_cuda.launches = 0


def _check_bf16_rows(name, q, k, v, hd):
    """The bf16 entries' layout: hd a multiple of 8, k and v rows 16-byte
    aligned (cp.async), q rows 4-byte aligned."""
    if hd % 8:
        raise ValueError(f"{name} takes hd a multiple of 8, got {hd}")
    if (any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (k, v))
            or q.data_ptr() % 4 or any(s % 2 for s in q.stride()[:3])):
        raise ValueError(f"{name} needs 16-byte aligned k and v rows and 4-byte "
                         f"aligned q rows")


def fused_attention_bf16_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """The plain version of K8's bf16 entry: bf16_attention_plain with q
    scaled before the product (_fused_kernel's q_aug)."""
    return bf16_attention_plain(q, k, v, scale, prescale=True)


def fused_attention_bf16_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """K8's bf16 entry: same contract as fused_attention_bf16_plain; bf16
    (B, H, Nq, hd) out, a view of a (B, Nq, H, hd) tensor."""
    name = "fused_attention_bf16_cuda"
    B, H, Nq, Nk, hd = _check_operands(name, q, k, v, torch.bfloat16)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name} takes hd <= {MAX_HEAD_DIM}, got {hd}")
    _check_bf16_rows(name, q, k, v, hd)
    lib = load_library()
    out = torch.empty((B, Nq, H, hd), dtype=torch.bfloat16, device=q.device)
    out_h = out.permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sam6d_fused_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q),
        _strides(k), _strides(v), _strides(out_h), B, H, Nq, Nk, hd,
        bf16_scale(scale), stream)
    fused_attention_bf16_cuda.launches += 1
    check(err, name)
    return out_h


fused_attention_bf16_cuda.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """`torch.ops.sam6d.fused_attention` (kernels/ops.py): a CUDA tensor
    goes to the K8 kernel of its dtype (float32 or bfloat16), a CPU tensor
    to the plain version of that dtype. The strided q, k, v views pass
    through as they are."""
    return torch.ops.sam6d.fused_attention(q, k, v, scale)


def fused_attention_small_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """The plain version of K9: fused_attention_plain on N x N."""
    return fused_attention_plain(q, k, v, scale)


def fused_attention_small_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """The K9 kernel: self-attention (Nq == Nk), hd 16, 32 or 64; returns a
    contiguous (B, H, N, hd) tensor."""
    B, H, N, Nk, hd = _check_operands("fused_attention_small_cuda", q, k, v)
    if Nk != N or hd not in SMALL_HEAD_DIMS:
        raise ValueError(f"fused_attention_small_cuda takes Nq == Nk and hd in "
                         f"{SMALL_HEAD_DIMS}, got {N}, {Nk}, {hd}")
    if any(t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("fused_attention_small_cuda needs 16-byte aligned rows")
    lib = load_library()
    out = torch.empty((B, H, N, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sam6d_fused_attention_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q),
        _strides(k), _strides(v), B, H, N, hd, float(scale), stream)
    fused_attention_small_cuda.launches += 1
    check(err, "fused_attention_small_cuda")
    return out


fused_attention_small_cuda.launches = 0


def fused_attention_small_bf16_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     scale: float) -> torch.Tensor:
    """The plain version of K9's bf16 entry: bf16_attention_plain with the
    fp32 product scaled (_small_kernel)."""
    return bf16_attention_plain(q, k, v, scale, prescale=False)


def fused_attention_small_bf16_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    scale: float) -> torch.Tensor:
    """K9's bf16 entry: self-attention (Nq == Nk), hd 16, 32 or 64; returns a
    contiguous bf16 (B, H, N, hd) tensor."""
    name = "fused_attention_small_bf16_cuda"
    B, H, N, Nk, hd = _check_operands(name, q, k, v, torch.bfloat16)
    if Nk != N or hd not in SMALL_HEAD_DIMS:
        raise ValueError(f"{name} takes Nq == Nk and hd in {SMALL_HEAD_DIMS}, got "
                         f"{N}, {Nk}, {hd}")
    _check_bf16_rows(name, q, k, v, hd)
    lib = load_library()
    out = torch.empty((B, H, N, hd), dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sam6d_fused_attention_small_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q),
        _strides(k), _strides(v), B, H, N, hd, float(scale), stream)
    fused_attention_small_bf16_cuda.launches += 1
    check(err, name)
    return out


fused_attention_small_bf16_cuda.launches = 0


def fused_attention_small(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """`torch.ops.sam6d.fused_attention_small` (kernels/ops.py): a CUDA
    tensor goes to the K9 kernel of its dtype (float32 or bfloat16), a CPU
    tensor to the plain version of that dtype."""
    return torch.ops.sam6d.fused_attention_small(q, k, v, scale)
