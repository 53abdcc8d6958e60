"""The three kernels of the SAM AMG's exact iou-prefix pass: the CUDA
kernels (`csrc/factored.cu`), their plain PyTorch versions, and the device
dispatch.

Replace `sam6d_tpu/kernels/factored_t2i.py`: `factored_ln_stats` (K2),
`factored_t2i_attention` (K3) and `factored_i2t_scores` (K4). In that pass
(`models/sam.TwoWayTransformer.factored`) each prompt's image side is
carried as

    x[b] = a[b] * S + P_eff[b]^T @ U[b]

with S (N, C) shared by the prompts, a (B, N) per-position scalars and
P_eff a tuple of SCALED BLOCKS: (Pd (B, R_i, N) raw factor rows, s (B, N)
per-position scale or None), whose concatenation along R, each block times
its scale, is P_eff. At depth 2 the pass calls each kernel twice per
128-prompt chunk (ranks 57 -> 116 for K2, 59 -> 118 for K3, 0 -> 59 for
K4), 16 times per frame at 1024 prompts.

The plain versions are the JAX package's XLA branches (models/sam.py
:797-830, :866-885, :913-935) in float32; K3's returns only the
head-diagonal output blocks the caller keeps. The kernels are held to them;
no single PyTorch call computes any of the three functions. What bounds
each kernel and how it is laid out is in the header of `csrc/factored.cu`.

bfloat16 operands take the bf16 entries (`csrc/factored_bf16.cu`, on
Hopper's `wgmma`) or, on the CPU, the `*_bf16_plain` versions: the bf16
contract of the Pallas kernels, the form the JAX package runs them in
(bf16 operands, the kernels' fp32 islands and their casts). Each dispatch
routes by the operands' one dtype; float16 or mixed dtypes are refused.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, load_library

MAX_BLOCKS = 4
MAX_RANK = 128            # K3/K4 keep the low-rank factor in shared memory
KERNEL_HEADS, KERNEL_HEAD_DIM, MAX_TOKENS = 8, 16, 8
LN_KERNEL_CHANNELS = (256,)


def blocks_concat(blocks) -> torch.Tensor:
    """P_eff (B, R, N) from the scaled blocks."""
    parts = [pd if s is None else pd * s[:, None, :] for pd, s in blocks]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def heads_block(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H*hd) -> block-diagonal (B, H*T, H*hd): row (h, t) holds token
    t's head-h channels, zeros elsewhere (`_heads_block_q`)."""
    B, T, d = x.shape
    eye = torch.eye(heads, dtype=x.dtype, device=x.device)
    return torch.einsum("bnhc,hg->bhngc", x.reshape(B, T, heads, d // heads),
                        eye).reshape(B, heads * T, d)


def heads_diag(res: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, H*T, H*hd) -> (B, T, H*hd): the head-diagonal blocks
    (`_heads_diag_out`)."""
    B, HT, d = res.shape
    T = HT // heads
    eye = torch.eye(heads, dtype=res.dtype, device=res.device)
    out = torch.einsum("bhngc,hg->bnhc", res.reshape(B, heads, T, heads, d // heads), eye)
    return out.reshape(B, T, d)


# ------------------------------------------------------------ plain versions


def _ln_stats_from_moments(blocks, Uc, S, mS, qS, a, eps):
    """The LN statistics from the factors, given the channel means mS, qS of
    S and S * S."""
    C = S.shape[-1]
    mU = Uc.mean(dim=-1)

    def scl(x, s):
        return x if s is None else x * s

    offs = [0]
    for pd, _ in blocks:
        offs.append(offs[-1] + pd.shape[1])
    mu_d = 0.0
    cross = 0.0
    for i, (pd, s) in enumerate(blocks):
        o0, o1 = offs[i], offs[i + 1]
        mu_d = mu_d + scl(torch.einsum("brn,br->bn", pd, mU[:, o0:o1]), s)
        G2 = torch.einsum("nc,brc->brn", S, Uc[:, o0:o1])
        cross = cross + scl((pd * G2).sum(dim=1), s)
    mu = (mS[None] if a is None else a * mS[None]) + mu_d
    cross = cross / C
    gram = torch.einsum("brc,bsc->brs", Uc, Uc) / C
    d2 = 0.0
    for i, (pd_i, s_i) in enumerate(blocks):
        W = 0.0
        for j, (pd_j, s_j) in enumerate(blocks):
            g_ij = gram[:, offs[i]:offs[i + 1], offs[j]:offs[j + 1]]
            W = W + scl(torch.einsum("brt,btn->brn", g_ij, pd_j),
                        None if s_j is None else s_j[:, None, :])
        d2 = d2 + scl((pd_i * W).sum(dim=1), s_i)
    aa = 1.0 if a is None else a * a
    a1 = 1.0 if a is None else a
    e2 = aa * qS[None] + 2.0 * a1 * cross + d2
    return mu, torch.rsqrt(e2 - mu * mu + eps)


def factored_ln_stats_plain(blocks, Uc, S, a, eps: float = 1e-6):
    """(mu (B, N), 1/sigma (B, N)) over the channels of x, the fast-variance
    form of flax LayerNorm, from the factors only (gram, mean(U) and the
    S-cross terms; the XLA branch of `_ln_factored`)."""
    return _ln_stats_from_moments(blocks, Uc, S, S.mean(dim=-1), (S * S).mean(dim=-1), a,
                                  eps)


def factored_t2i_attention_plain(qp, UK, UV, blocks, a, KS, KC, VS,
                                 heads: int) -> torch.Tensor:
    """Token->image attention of the pre-scaled queries qp (B, T, d) over the
    factored keys a*KS + KC + P_eff^T UK and values a*VS + P_eff^T UV,
    per head; returns the head-diagonal blocks (B, T, d), without the
    value bias (the caller adds it: softmax rows sum to one)."""
    B, T, d = qp.shape
    N = KS.shape[0]
    qb = heads_block(qp, heads)
    P = blocks_concat(blocks)
    s = torch.einsum("btd,nd->btn", qb, KS) * a[:, None, :]
    s = s + qb @ KC.T
    s = s + torch.einsum("btr,brn->btn", torch.einsum("btd,brd->btr", qb, UK), P)
    p = torch.softmax(s.reshape(B, heads, T, N), dim=-1).reshape(B, heads * T, N)
    res = torch.einsum("btn,nd->btd", p * a[:, None, :], VS)
    res = res + torch.einsum("btr,brd->btd", torch.einsum("btn,brn->btr", p, P), UV)
    return heads_diag(res, heads)


def factored_i2t_scores_plain(kt, UQ, blocks, a, QS, QC,
                              heads: int) -> torch.Tensor:
    """Image<-token attention probabilities of the token keys kt (B, T, d)
    at every image position, softmax over each head's T tokens, as the next
    raw factor block (B, H*T + 1, N) whose last row is ones (it pairs with
    the out-proj bias row of U)."""
    B, T, d = kt.shape
    N = QS.shape[0]
    eye = torch.eye(heads, dtype=kt.dtype, device=kt.device)
    kb = torch.einsum("bnhc,hg->bgchn", kt.reshape(B, T, heads, d // heads),
                      eye).reshape(B, d, heads * T)
    s = torch.einsum("nd,bdk->bkn", QS, kb)
    if a is not None:
        s = s * a[:, None, :]
    s = s + torch.einsum("nd,bdk->bkn", QC, kb)
    if blocks:
        UQkb = torch.einsum("brd,bdk->brk", UQ, kb)
        off = 0
        for pd, sc in blocks:
            r = pd.shape[1]
            term = torch.einsum("brn,brk->bkn", pd, UQkb[:, off:off + r])
            s = s + (term if sc is None else term * sc[:, None, :])
            off += r
    p3 = torch.softmax(s.reshape(B, heads, T, N), dim=2).reshape(B, heads * T, N)
    return torch.cat([p3, torch.ones((B, 1, N), dtype=p3.dtype, device=p3.device)], dim=1)


# ------------------------------------------------------- plain bf16 versions
#
# The bf16 contract of the Pallas kernels (sam6d_tpu/kernels/
# factored_t2i.py) in explicit fp32 arithmetic on the upcast bf16 operands:
# every product of two bf16 values is exact in fp32 and sums in fp32, and
# the results are rounded to bf16 exactly where the kernels cast.

_F32, _BF16 = torch.float32, torch.bfloat16


def _up(x):
    return None if x is None else x.to(_F32)


def _rnd(x):
    """x rounded to bf16, held in fp32."""
    return x.to(_BF16).to(_F32)


def ln_moments(S):
    """(mS, qS): the channel means of S and of S * S in S's dtype, with fp32
    accumulation, as the JAX package forms them before its LN-stats kernel
    (`jnp.mean(S, -1)`, `jnp.mean(S * S, -1)`, models/sam.py:791-792)."""
    return S.to(_F32).mean(dim=-1).to(S.dtype), (S * S).to(_F32).mean(dim=-1).to(S.dtype)


def factored_ln_stats_bf16_plain(blocks, Uc, S, a, eps: float = 1e-6):
    """_ln_stats_kernel on bf16 operands: fp32 arithmetic on their values,
    with mS, qS rounded to bf16 (`ln_moments`); fp32 (mu, 1/sigma) out."""
    mS, qS = (m.to(_F32) for m in ln_moments(S))
    blocks32 = tuple((pd.to(_F32), _up(s)) for pd, s in blocks)
    return _ln_stats_from_moments(blocks32, Uc.to(_F32), S.to(_F32), mS, qS, _up(a), eps)


def factored_t2i_attention_bf16_plain(qp, UK, UV, blocks, a, KS, KC, VS,
                                      heads: int) -> torch.Tensor:
    """_t2i_kernel on bf16 operands: t1 = bf16(qb UK^T); fp32 scores, each
    block's fp32 product times its scale; the fp32 softmax over the N
    positions; bf16(p a) VS + bf16(concat_i bf16(p s_i) Pd_i^T) UV, rounded
    to bf16; the head-diagonal blocks (B, T, d)."""
    qb = heads_block(qp.to(_F32), heads)
    a32 = a.to(_F32)[:, None, :]
    t1 = _rnd(qb @ UK.to(_F32).transpose(1, 2))
    s = (qb @ KS.to(_F32).T) * a32 + qb @ KC.to(_F32).T
    off = 0
    for pd, sc in blocks:
        r = pd.shape[1]
        term = t1[:, :, off:off + r] @ pd.to(_F32)
        s = s + (term if sc is None else term * sc.to(_F32)[:, None, :])
        off += r
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = _rnd(p * a32) @ VS.to(_F32)
    t2 = torch.cat([_rnd(p if sc is None else p * sc.to(_F32)[:, None, :])
                    @ pd.to(_F32).transpose(1, 2) for pd, sc in blocks], dim=2)
    out = out + _rnd(t2) @ UV.to(_F32)
    return heads_diag(out, heads).to(_BF16)


def factored_i2t_scores_bf16_plain(kt, UQ, blocks, a, QS, QC, heads: int) -> torch.Tensor:
    """_i2t_kernel on bf16 operands: fp32 scores (k QS^T) a + k QC^T +
    sum_i (bf16(UQ_i k^T)^T Pd_i) s_i; the fp32 softmax over each head's T
    tokens rounded to bf16; a last row of ones: (B, H*T + 1, N) bf16."""
    B, T, d = kt.shape
    N = QS.shape[0]
    kb = heads_block(kt.to(_F32), heads)                     # (B, HT, d)
    s = kb @ QS.to(_F32).T
    if a is not None:
        s = s * a.to(_F32)[:, None, :]
    s = s + kb @ QC.to(_F32).T
    off = 0
    for pd, sc in blocks:
        r = pd.shape[1]
        t_i = _rnd(UQ[:, off:off + r].to(_F32) @ kb.transpose(1, 2))   # (B, R_i, HT)
        term = t_i.transpose(1, 2) @ pd.to(_F32)
        s = s + (term if sc is None else term * sc.to(_F32)[:, None, :])
        off += r
    s3 = s.reshape(B, heads, T, N)
    e = torch.exp(s3 - s3.amax(dim=2, keepdim=True))
    p3 = (e / e.sum(dim=2, keepdim=True)).reshape(B, heads * T, N)
    ones = torch.ones((B, 1, N), dtype=_BF16, device=kt.device)
    return torch.cat([p3.to(_BF16), ones], dim=1)


# ------------------------------------------------------------- CUDA kernels


def _operand(name, t, dtype, shape=None):
    if not t.is_cuda or t.dtype != dtype:
        raise ValueError(f"{name} must be a CUDA {str(dtype)[6:]} tensor, got {t.device} "
                         f"{t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return t.data_ptr()


def _f32(name, t, shape=None):
    return _operand(name, t, torch.float32, shape)


def _b16(name, t, shape=None):
    return _operand(name, t, torch.bfloat16, shape)


def _block_args(blocks, B, N, ptr=_f32):
    """(pointer array, scale-pointer array, rank array, count, total rank)
    of the scaled-block descriptors."""
    if len(blocks) > MAX_BLOCKS:
        raise ValueError(f"{len(blocks)} factor blocks: the kernels take {MAX_BLOCKS}")
    pd_p, s_p, ranks = [], [], []
    for i, (pd, s) in enumerate(blocks):
        if pd.dim() != 3 or pd.shape[0] != B or pd.shape[2] != N:
            raise ValueError(f"block {i} must be (B={B}, R, N={N}), got {tuple(pd.shape)}")
        pd_p.append(ptr(f"block {i}", pd))
        s_p.append(None if s is None else ptr(f"scale {i}", s, (B, N)))
        ranks.append(pd.shape[1])
    pad = MAX_BLOCKS - len(blocks)
    return ((ctypes.c_void_p * MAX_BLOCKS)(*(pd_p + [None] * pad)),
            (ctypes.c_void_p * MAX_BLOCKS)(*(s_p + [None] * pad)),
            (ctypes.c_int * MAX_BLOCKS)(*(ranks + [0] * pad)),
            len(blocks), sum(ranks))


def _check_heads(name, x, heads):
    B, T, d = x.shape
    if heads != KERNEL_HEADS or d != KERNEL_HEADS * KERNEL_HEAD_DIM or not 0 < T <= MAX_TOKENS:
        raise ValueError(f"{name} {tuple(x.shape)} with {heads} heads: the kernel "
                         f"takes {KERNEL_HEADS} heads of {KERNEL_HEAD_DIM} and "
                         f"at most {MAX_TOKENS} tokens")


def factored_ln_stats_cuda(blocks, Uc, S, a, eps: float = 1e-6):
    """The CUDA kernel: same contract as factored_ln_stats_plain."""
    N, C = S.shape
    B = Uc.shape[0]
    if C not in LN_KERNEL_CHANNELS:
        raise ValueError(f"{C} channels: the kernel takes {LN_KERNEL_CHANNELS}")
    pd, sc, ranks, nb, R = _block_args(blocks, B, N)
    if nb == 0:
        raise ValueError("factored_ln_stats takes at least one factor block")
    args = (_f32("Uc", Uc, (B, R, C)), _f32("S", S),
            None if a is None else _f32("a", a, (B, N)))
    out = torch.empty((B, 2, N), dtype=torch.float32, device=S.device)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    err = load_library().sam6d_factored_ln_stats(
        pd, sc, ranks, nb, *args, out.data_ptr(), B, N, C, R, float(eps), stream)
    factored_ln_stats_cuda.launches += 1
    check(err, "factored_ln_stats_cuda")
    # contiguous (B, N) rows: they become the next blocks' scales
    return out[:, 0].contiguous(), out[:, 1].contiguous()


def factored_t2i_attention_cuda(qp, UK, UV, blocks, a, KS, KC, VS,
                                heads: int) -> torch.Tensor:
    """The CUDA kernel: same contract as factored_t2i_attention_plain."""
    _check_heads("qp", qp, heads)
    B, T, d = qp.shape
    N = KS.shape[0]
    pd, sc, ranks, nb, R = _block_args(blocks, B, N)
    if not 0 < R <= MAX_RANK:
        raise ValueError(f"total rank {R}: the kernel takes 1..{MAX_RANK}")
    args = (_f32("qp", qp), _f32("UK", UK, (B, R, d)), _f32("UV", UV, (B, R, d)))
    tail = (_f32("a", a, (B, N)), _f32("KS", KS, (N, d)), _f32("KC", KC, (N, d)),
            _f32("VS", VS, (N, d)))
    lib = load_library()
    # the partials of the position chunks, merged by the second launch
    ws = torch.empty(B * lib.sam6d_factored_t2i_workspace(N, R), dtype=torch.float32,
                     device=qp.device)
    out = torch.empty((B, T, d), dtype=torch.float32, device=qp.device)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    err = lib.sam6d_factored_t2i_attention(
        *args, pd, sc, ranks, nb, *tail, ws.data_ptr(), out.data_ptr(), B, T, N, R, stream)
    factored_t2i_attention_cuda.launches += 1
    check(err, "factored_t2i_attention_cuda")
    return out


def factored_i2t_scores_cuda(kt, UQ, blocks, a, QS, QC, heads: int) -> torch.Tensor:
    """The CUDA kernel: same contract as factored_i2t_scores_plain."""
    _check_heads("kt", kt, heads)
    B, T, d = kt.shape
    N = QS.shape[0]
    pd, sc, ranks, nb, R = _block_args(blocks, B, N)
    if R > MAX_RANK:
        raise ValueError(f"total rank {R}: the kernel takes at most {MAX_RANK}")
    uq = None if R == 0 else _f32("UQ", UQ, (B, R, d))
    args = (None if a is None else _f32("a", a, (B, N)), _f32("QS", QS, (N, d)),
            _f32("QC", QC, (N, d)))
    out = torch.empty((B, heads * T + 1, N), dtype=torch.float32, device=kt.device)
    stream = torch.cuda.current_stream(kt.device).cuda_stream
    err = load_library().sam6d_factored_i2t_scores(
        _f32("kt", kt), uq, pd, sc, ranks, nb, *args, out.data_ptr(), B, T, N, R,
        stream)
    factored_i2t_scores_cuda.launches += 1
    check(err, "factored_i2t_scores_cuda")
    return out


def factored_ln_stats_bf16_cuda(blocks, Uc, S, a, eps: float = 1e-6):
    """The bf16 entry: same contract as factored_ln_stats_bf16_plain (mS and
    qS from `ln_moments`, as the plain version takes them)."""
    name = "factored_ln_stats_bf16_cuda"
    N, C = S.shape
    B = Uc.shape[0]
    if C not in LN_KERNEL_CHANNELS:
        raise ValueError(f"{C} channels: the kernel takes {LN_KERNEL_CHANNELS}")
    pd, sc, ranks, nb, R = _block_args(blocks, B, N, _b16)
    if nb == 0 or R == 0:
        raise ValueError("factored_ln_stats takes at least one factor row")
    mS, qS = ln_moments(S)   # held until the launch: the kernel reads them
    args = (_b16("Uc", Uc, (B, R, C)), _b16("S", S), _b16("mS", mS), _b16("qS", qS),
            None if a is None else _b16("a", a, (B, N)))
    out = torch.empty((B, 2, N), dtype=torch.float32, device=S.device)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    err = load_library().sam6d_factored_ln_stats_bf16(
        pd, sc, ranks, nb, *args, out.data_ptr(), B, N, C, R, float(eps), stream)
    factored_ln_stats_bf16_cuda.launches += 1
    check(err, name)
    return out[:, 0].contiguous(), out[:, 1].contiguous()


def factored_t2i_attention_bf16_cuda(qp, UK, UV, blocks, a, KS, KC, VS,
                                     heads: int) -> torch.Tensor:
    """The bf16 entry: same contract as factored_t2i_attention_bf16_plain."""
    name = "factored_t2i_attention_bf16_cuda"
    _check_heads("qp", qp, heads)
    B, T, d = qp.shape
    N = KS.shape[0]
    pd, sc, ranks, nb, R = _block_args(blocks, B, N, _b16)
    if not 0 < R <= MAX_RANK:
        raise ValueError(f"total rank {R}: the kernel takes 1..{MAX_RANK}")
    args = (_b16("qp", qp), _b16("UK", UK, (B, R, d)), _b16("UV", UV, (B, R, d)))
    tail = (_b16("a", a, (B, N)), _b16("KS", KS, (N, d)), _b16("KC", KC, (N, d)),
            _b16("VS", VS, (N, d)))
    lib = load_library()
    # the position chunks' softmax statistics and partials
    ws = torch.empty(B * lib.sam6d_factored_t2i_bf16_workspace(ranks, nb, N),
                     dtype=torch.float32, device=qp.device)
    out = torch.empty((B, T, d), dtype=torch.bfloat16, device=qp.device)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    err = lib.sam6d_factored_t2i_attention_bf16(
        *args, pd, sc, ranks, nb, *tail, ws.data_ptr(), out.data_ptr(), B, T, N, R, stream)
    factored_t2i_attention_bf16_cuda.launches += 1
    check(err, name)
    return out


def factored_i2t_scores_bf16_cuda(kt, UQ, blocks, a, QS, QC, heads: int) -> torch.Tensor:
    """The bf16 entry: same contract as factored_i2t_scores_bf16_plain."""
    name = "factored_i2t_scores_bf16_cuda"
    _check_heads("kt", kt, heads)
    B, T, d = kt.shape
    N = QS.shape[0]
    pd, sc, ranks, nb, R = _block_args(blocks, B, N, _b16)
    if R > MAX_RANK:
        raise ValueError(f"total rank {R}: the kernel takes at most {MAX_RANK}")
    uq = None if R == 0 else _b16("UQ", UQ, (B, R, d))
    args = (None if a is None else _b16("a", a, (B, N)), _b16("QS", QS, (N, d)),
            _b16("QC", QC, (N, d)))
    out = torch.empty((B, heads * T + 1, N), dtype=torch.bfloat16, device=kt.device)
    stream = torch.cuda.current_stream(kt.device).cuda_stream
    err = load_library().sam6d_factored_i2t_scores_bf16(
        _b16("kt", kt), uq, pd, sc, ranks, nb, *args, out.data_ptr(), B, T, N, R, stream)
    factored_i2t_scores_bf16_cuda.launches += 1
    check(err, name)
    return out


factored_ln_stats_cuda.launches = 0
factored_t2i_attention_cuda.launches = 0
factored_i2t_scores_cuda.launches = 0
factored_ln_stats_bf16_cuda.launches = 0
factored_t2i_attention_bf16_cuda.launches = 0
factored_i2t_scores_bf16_cuda.launches = 0


# ----------------------------------------------------------------- dispatch
#
# Each public function is its `torch.ops.sam6d` operator (kernels/ops.py),
# which takes the scaled blocks as two lists: a CUDA tensor goes to the
# kernel of the operands' one dtype, a CPU tensor to the plain version of
# that dtype.


def _split_blocks(blocks):
    return [pd for pd, _ in blocks], [s for _, s in blocks]


def factored_ln_stats(blocks, Uc, S, a, eps: float = 1e-6):
    """`torch.ops.sam6d.factored_ln_stats`: (mu, 1/sigma), each (B, N)."""
    return tuple(torch.ops.sam6d.factored_ln_stats(*_split_blocks(blocks), Uc, S, a, eps))


def factored_t2i_attention(qp, UK, UV, blocks, a, KS, KC, VS, heads: int):
    """`torch.ops.sam6d.factored_t2i_attention`."""
    return torch.ops.sam6d.factored_t2i_attention(qp, UK, UV, *_split_blocks(blocks), a,
                                                  KS, KC, VS, heads)


def factored_i2t_scores(kt, UQ, blocks, a, QS, QC, heads: int):
    """`torch.ops.sam6d.factored_i2t_scores`."""
    return torch.ops.sam6d.factored_i2t_scores(kt, UQ, *_split_blocks(blocks), a, QS, QC,
                                               heads)
