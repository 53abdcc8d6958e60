"""SAM (Segment Anything): the ViTDet image encoder, the prompt encoder and
the two-way mask decoder.

Port of `sam6d_tpu/models/sam.py` (reference `Instance_Segmentation_Model/
segment_anything/modeling/`: image_encoder.py, prompt_encoder.py,
transformer.py, mask_decoder.py). Images and embeddings stay channels-last
(B, H, W, C) as in the JAX package; module and parameter names follow the
reference `state_dict` (`image_encoder.blocks.{i}.attn.qkv`, `neck.0-3`,
`prompt_encoder.pe_layer.positional_encoding_gaussian_matrix`,
`mask_decoder.transformer.layers.{i}.norm4`, `output_upscaling.0/1/3`,
`output_hypernetworks_mlps.{i}`, `iou_prediction_head`), so the released
checkpoint loads with `strict=True`.

- Every encoder attention, windowed and global, goes through the rel-pos
  attention dispatch (`kernels/attention_relpos.py`); windowed blocks pad
  64 -> 70 after norm1 and attend over the zero pad tokens, as the
  reference does. The rel-pos tables keep the reference sizes (27 rows
  windowed, 127 global).
- The two-way transformer's LayerNorms use eps 1e-6 (flax's default, as the
  JAX package); norm4 and the factored LayerNorm use flax's fast-variance
  form E[x^2] - E[x]^2.
- `TwoWayTransformer.factored` is the exact token-side pass of the AMG's
  iou-prefix scoring with the image side kept as a * S + P_eff^T U; it calls
  the three factored kernels (`kernels/factored.py`) exactly where the JAX
  package takes its kernel branch.
- The mask decoder's upscale runs as two GEMMs in row-major pixel order
  (the JAX package's `block_layout` path with `block_masks=False`).

Every module runs in the dtype of its weights (float32, or bfloat16 after
`core/params.cast_float_params`) with the JAX package's fp32 islands: the
prompt encodings stay float32 (the Fourier features of float32 coordinates;
JAX promotes bf16 + fp32 to fp32, and so does PyTorch), and are cast where
they enter a projection, as flax's `Dense` casts to its `dtype`; flax's
LayerNorm (`nn.LayerNorm` here) takes its statistics in fp32, while the
manual norms (`apply_ln`, `LayerNorm2d`) run in the input's dtype as JAX's
do; the rel-pos attention and the factored iou pass's three kernels take
bf16 to their bf16 entries, and the factored LayerNorm casts as the JAX
package's kernel branch does (`TwoWayTransformer._ln_factored`). GELU stays
the exact erf form in bf16 (`vit.MlpBlock`).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.uploads import device_constant
from ..kernels.attention_relpos import flash_attention_relpos
from ..kernels.factored import (blocks_concat, factored_i2t_scores,
                                factored_ln_stats, factored_t2i_attention,
                                heads_block, heads_diag)
from .vit import PatchEmbed


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act: str = "gelu"):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = F.gelu if act == "gelu" else F.relu

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over the last axis, eps 1e-6 (reference
    common.py LayerNorm2d, applied channels-last)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        u = x.mean(dim=-1, keepdim=True)
        s = ((x - u) ** 2).mean(dim=-1, keepdim=True)
        return (x - u) / torch.sqrt(s + self.eps) * self.weight + self.bias


class MLP(nn.Module):
    """Reference mask_decoder.MLP: Linear layers with ReLU between."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims, dims[1:] + [out_dim]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def apply_ln(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax nn.LayerNorm's arithmetic (fast variance E[x^2] - E[x]^2, rsqrt)
    with `ln`'s affine, so the standard and factored paths share norm4."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps) * ln.weight + ln.bias


# ------------------------------------------------------------------ encoder


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> ((B * nW, ws, ws, C), (Hp, Wp)), zero-padded to
    multiples of ws (reference image_encoder.py:243-264)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    C = wins.shape[-1]
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, C)[:, :H, :W]


class SAMAttention(nn.Module):
    """ViTDet attention with the decomposed relative-position bias; the
    softmax(q k^T + bias) v chain is the rel-pos attention dispatch (the
    CUDA kernel for a CUDA tensor, its plain version on the CPU)."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):
        B, H, W, C = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3 * C)
        out = flash_attention_relpos(qkv, self.rel_pos_h, self.rel_pos_w, (H, W),
                                     self.num_heads)
        return self.proj(out.reshape(B, H, W, C))


class SAMBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, grid: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size       # 0 = global attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        size = (window_size, window_size) if window_size > 0 else (grid, grid)
        self.attn = SAMAttention(dim, num_heads, size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class SAMImageEncoder(nn.Module):
    """ViTDet image encoder (reference image_encoder.py:17-116):
    (B, H, W, 3) preprocessed -> (B, H/16, W/16, out_chans)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
                 out_chans: int = 256):
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            SAMBlock(embed_dim, num_heads,
                     0 if i in global_attn_indexes else window_size, grid)
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        conv1, ln1, conv2, ln2 = self.neck
        x = ln1(x @ conv1.weight[:, :, 0, 0].t())
        x = F.conv2d(x.permute(0, 3, 1, 2), conv2.weight, padding=1)
        return ln2(x.permute(0, 2, 3, 1))


# ------------------------------------------------------------------ prompts


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding matrix (reference
    prompt_encoder.PositionEmbeddingRandom; a buffer in its state_dict)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))


class PromptEncoder(nn.Module):
    """Prompt encoder (reference prompt_encoder.py:16-170): points, boxes
    and mask inputs; the AMG uses only the point path."""

    def __init__(self, embed_dim: int = 256, input_image_size=(1024, 1024),
                 image_embedding_size=(64, 64), mask_in_chans: int = 16):
        super().__init__()
        self.input_image_size = tuple(input_image_size)
        self.image_embedding_size = tuple(image_embedding_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        c4 = mask_in_chans // 4
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c4, 2, stride=2), LayerNorm2d(c4), nn.GELU(),
            nn.Conv2d(c4, mask_in_chans, 2, stride=2), LayerNorm2d(mask_in_chans),
            nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def _pe(self, coords01):
        """[0, 1]-normalized coords (..., 2) -> (..., C), in the coordinates'
        dtype (float32; the matrix is cast up, as in JAX)."""
        g = self.pe_layer.positional_encoding_gaussian_matrix
        c = (2.0 * coords01 - 1.0) @ g.to(coords01.dtype)
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def _size(self, like):
        H, W = self.input_image_size
        return device_constant(("sam_input_size", W, H), lambda: np.array([W, H], np.float32),
                               like.device)

    def embed_points(self, points, labels, pad: bool = True):
        """points (B, N, 2) pixel coords in the model input frame; labels
        (B, N) in {-1 pad, 0 negative, 1 positive}. Appends the padding point
        unless `pad=False` (the reference pads only when no box comes with
        the points). Returns (B, N[+1], C)."""
        B = points.shape[0]
        if pad:
            points = torch.cat([points, points.new_zeros(B, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(B, 1)], dim=1)
        pe = self._pe((points + 0.5) / self._size(points))
        pt = [e.weight[0] for e in self.point_embeddings]
        emb = torch.where((labels == -1)[..., None], self.not_a_point_embed.weight[0], pe)
        emb = emb + torch.where((labels == 0)[..., None], pt[0], torch.zeros_like(pt[0]))
        return emb + torch.where((labels == 1)[..., None], pt[1], torch.zeros_like(pt[1]))

    def embed_boxes(self, boxes):
        """boxes (B, 4) xyxy in the model input frame -> (B, 2, C)."""
        coords = (boxes.to(torch.float32) + 0.5).reshape(-1, 2, 2)
        corners = torch.stack([self.point_embeddings[2].weight[0],
                               self.point_embeddings[3].weight[0]])
        return self._pe(coords / self._size(boxes)) + corners

    def embed_masks(self, masks):
        """masks (B, 4h, 4w, 1) low-res mask logits, channels-last -> dense
        embedding (B, h, w, C) (reference mask_downscaling)."""
        conv1, ln1, _, conv2, ln2, _, conv3 = self.mask_downscaling
        masks = masks.to(conv1.weight.dtype)
        x = ln1(conv1(masks.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        x = ln2(conv2(F.gelu(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return conv3(F.gelu(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def dense_pe(self):
        """(h, w, C) positional encoding of the embedding grid."""
        h, w = self.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self._pe(grid)

    def no_mask_dense(self):
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight[0].expand(h, w, -1)

    def forward(self, points=None, labels=None, boxes=None, masks=None):
        """(sparse (B, n, C), dense (h, w, C) or (B, h, w, C)) from points
        and/or boxes and an optional mask input (reference :128-170)."""
        parts = []
        if points is not None:
            parts.append(self.embed_points(points, labels, pad=boxes is None))
        if boxes is not None:
            parts.append(self.embed_boxes(boxes))
        if not parts:
            raise ValueError("at least one of points / boxes is required")
        sparse = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        dense = self.embed_masks(masks) if masks is not None else self.no_mask_dense()
        return sparse, dense


# ------------------------------------------------------------ mask decoder


class DownsampleAttention(nn.Module):
    """Reference transformer.Attention with channel downsampling. q / k / v
    may have batch 1 against a batch-B other side (shared across prompts:
    projected once, broadcast in the products). q_extra / k_extra are
    batch-1 additive terms (positional encodings) distributed through the
    projections: proj(x + e) = x W + (e W + b)."""

    def __init__(self, embed_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.inner_dim = embed_dim // downsample_rate
        self.q_proj = nn.Linear(embed_dim, self.inner_dim)
        self.k_proj = nn.Linear(embed_dim, self.inner_dim)
        self.v_proj = nn.Linear(embed_dim, self.inner_dim)
        self.out_proj = nn.Linear(self.inner_dim, embed_dim)

    @staticmethod
    def _proj(lin: nn.Linear, x, extra=None):
        """The projection of x (+ extra), both cast to the weights' dtype."""
        dt = lin.weight.dtype
        if extra is None:
            return lin(x.to(dt))
        W = lin.weight.t()
        return x.to(dt) @ W + (extra.to(dt) @ W + lin.bias)

    def forward(self, q, k, v, q_extra=None, k_extra=None):
        H = self.num_heads
        hd = self.inner_dim // H
        qp = self._proj(self.q_proj, q, q_extra) / math.sqrt(hd)
        kp = self._proj(self.k_proj, k, k_extra)
        vp = self._proj(self.v_proj, v)

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], H, hd).transpose(1, 2)

        a = torch.softmax(heads(qp) @ heads(kp).transpose(-1, -2), dim=-1)
        o = (a @ heads(vp)).transpose(1, 2)
        return self.out_proj(o.reshape(o.shape[0], o.shape[1], self.inner_dim))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(embed_dim, num_heads, 1)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.cross_attn_token_to_image = DownsampleAttention(embed_dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.mlp = MLPBlock(embed_dim, mlp_dim, act="relu")
        self.norm3 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.norm4 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.cross_attn_image_to_token = DownsampleAttention(embed_dim, num_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        """keys / key_pe may have batch 1 (shared by the prompts); the
        image<-token update makes keys per prompt."""
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, keys, keys, k_extra=key_pe))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        attn = self.cross_attn_image_to_token(keys, q, queries, q_extra=key_pe)
        return queries, apply_ln(self.norm4, keys + attn)


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.num_heads = num_heads
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DownsampleAttention(embed_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (1 or B, N, C); point_embedding
        (B, T, C). Returns (queries (B, T, C), keys (B, N, C))."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q = queries + point_embedding
        attn = self.final_attn_token_to_image(q, keys, keys, k_extra=image_pe)
        return self.norm_final_attn(queries + attn), keys

    # ---------------- the image side kept factored (exact, never formed) ---
    #
    # For the AMG every prompt shares the image tensor until the first
    # image<-token update, and each update is rank H*T + 1. The image side
    # is carried as keys[b] = a[b] * S + P_eff[b]^T @ U[b] with S (N, C)
    # shared, a (B, N) per-position scalars (from the LayerNorms) and P_eff
    # a tuple of scaled blocks (see kernels/factored.py).

    @staticmethod
    def _proj_factored(lin: nn.Linear, S, U, pos, scale: float = 1.0):
        """The projection of the factored keys plus the shared pos, times
        `scale`: (KS (N, d) [times a at use], UK (B, R, d) or None,
        KC (N, d) or (1, d) constant part)."""
        W = lin.weight.t() * scale
        KS = S @ W
        UK = None if U is None else U @ W
        KC = lin.bias[None, :] * scale
        if pos is not None:
            KC = pos[0].to(W.dtype) @ W + KC
        return KS, UK, KC

    @staticmethod
    def _ln_factored(ln: nn.LayerNorm, S, a, blocks, Uc, eps: float = 1e-6):
        """LayerNorm over the channels of x = a * S + P_eff^T Uc, returning
        the updated factored state (S', a', blocks', U'): the statistics come
        from the factored LN-stats dispatch; the 1/sigma scaling goes into
        the block scales and one rank-2 block ([-mu/sigma, 1] rows) is
        appended. The casts are the JAX package's kernel branch: the dispatch
        takes mS, qS in the compute dtype and returns fp32 (mu, 1/sigma);
        1/sigma is cast to the compute dtype, the rows are
        (-mu * float(1/sigma)) cast to it (a no-op in float32)."""
        gamma, beta = ln.weight, ln.bias
        B, _, N = blocks[0][0].shape
        C = S.shape[-1]
        dt = S.dtype
        mu, inv = factored_ln_stats(blocks, Uc, S, a, eps)
        inv = inv.to(dt)
        a2 = inv if a is None else a * inv
        blocks2 = tuple((pd, inv if s is None else s * inv) for pd, s in blocks)
        rows = torch.cat([(-mu * inv.to(mu.dtype)).to(dt)[:, None, :],
                          torch.ones_like(inv)[:, None, :]], dim=1)
        U2 = torch.cat([Uc * gamma, gamma.expand(B, 1, C), beta.expand(B, 1, C)], dim=1)
        return S * gamma, a2, blocks2 + ((rows, None),), U2

    def _t2i_factored(self, att: DownsampleAttention, q_tokens, S, a, blocks, U, pos):
        """Token->image attention over the factored keys; returns its output
        on the token side (B, T, C). `blocks` is empty before the first
        image<-token update."""
        H = self.num_heads
        hd = att.inner_dim // H
        qp = att._proj(att.q_proj, q_tokens) / math.sqrt(hd)
        B, T, _ = qp.shape
        N = S.shape[0]
        KS, UK, KC = self._proj_factored(att.k_proj, S, U, pos)
        VS, UV, VC = self._proj_factored(att.v_proj, S, U, None)
        if blocks and a is not None and KC.shape[0] == N:
            out = factored_t2i_attention(qp, UK, UV, blocks, a, KS, KC, VS, H)
            return att.out_proj(out + VC)   # softmax rows sum to 1: bias adds once
        qb = heads_block(qp, H)
        P = blocks_concat(blocks) if blocks else None
        s = torch.einsum("btd,nd->btn", qb, KS)
        if a is not None:
            s = s * a[:, None, :]
        s = s + (qb @ KC.T if KC.shape[0] == N else torch.einsum("btd,od->bto", qb, KC))
        if P is not None:
            s = s + torch.einsum("btr,brn->btn", torch.einsum("btd,brd->btr", qb, UK), P)
        p = torch.softmax(s.reshape(B, H, T, N), dim=-1).reshape(B, H * T, N)
        res = torch.einsum("btn,nd->btd", p if a is None else p * a[:, None, :], VS)
        if P is not None:
            res = res + torch.einsum("btr,brd->btd", torch.einsum("btn,brn->btr", p, P), UV)
        return att.out_proj(heads_diag(res + VC, H))

    def _i2t_update_factors(self, att: DownsampleAttention, queries, point_embedding,
                            S, a, blocks, U, pos):
        """Image<-token attention as one more raw factor block (Pd (B, HT+1,
        N), scale None) and its U rows ((v W_o) per head and token, then the
        b_o row): delta = Pd^T Ud, exact (out-proj reassociated). `pos` is
        the shared image pe, so the probabilities always come from the
        factored i2t dispatch."""
        H = self.num_heads
        d = att.inner_dim
        hd = d // H
        B = queries.shape[0]
        QS, UQ, QC = self._proj_factored(att.q_proj, S, U, pos, scale=float(hd) ** -0.5)
        k_t = att._proj(att.k_proj, queries + point_embedding)  # (B, T, d)
        Pd = factored_i2t_scores(k_t, UQ if blocks else None, blocks, a, QS, QC, H)
        vbo = heads_block(att._proj(att.v_proj, queries), H) @ att.out_proj.weight.t()
        C = vbo.shape[-1]
        Ud = torch.cat([vbo, att.out_proj.bias.expand(B, 1, C)], dim=1)
        return blocks + ((Pd, None),), (Ud if U is None else torch.cat([U, Ud], dim=1))

    def factored(self, image_embedding, image_pe, point_embedding):
        """Exact two-way pass with the image side factored.
        image_embedding / image_pe (1, N, C); point_embedding (B, T, C).
        Returns (queries (B, T, C), (S, a, blocks, U))."""
        queries = point_embedding
        S = image_embedding[0]
        pos = image_pe
        a, blocks, U = None, (), None
        for lyr in self.layers:
            if lyr.skip_first_layer_pe:
                queries = lyr.self_attn(queries, queries, queries)
            else:
                q = queries + point_embedding
                queries = queries + lyr.self_attn(q, q, queries)
            queries = lyr.norm1(queries)
            attn = self._t2i_factored(lyr.cross_attn_token_to_image,
                                      queries + point_embedding, S, a, blocks, U, pos)
            queries = lyr.norm2(queries + attn)
            queries = lyr.norm3(queries + lyr.mlp(queries))
            blocks, U = self._i2t_update_factors(lyr.cross_attn_image_to_token, queries,
                                                 point_embedding, S, a, blocks, U, pos)
            S, a, blocks, U = self._ln_factored(lyr.norm4, S, a, blocks, U)
        attn = self._t2i_factored(self.final_attn_token_to_image,
                                  queries + point_embedding, S, a, blocks, U, pos)
        return self.norm_final_attn(queries + attn), (S, a, blocks, U)


class MaskDecoder(nn.Module):
    """Two-way transformer + hypernetwork mask head + IoU head (reference
    mask_decoder.py)."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 iou_head_hidden_dim: int = 256):
        super().__init__()
        C = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(2, C, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2), LayerNorm2d(C // 4), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(C, iou_head_hidden_dim, self.num_mask_tokens, 3)

    def _upscale_masks(self, src, hyper, H, W):
        """src (B, H*W, C) image side after the transformer; hyper (B, K,
        C/8). The two stride-2 ConvTranspose layers as GEMMs: pixel
        (2i+p, 2j+q) of the first comes from column block (p, q) of
        src @ k1m, likewise for the second. Returns (B, K, 4H, 4W)."""
        up1, ln, _, up2, _ = self.output_upscaling
        B, _, C = src.shape
        C4, C8 = C // 4, C // 8
        k1m = up1.weight.permute(0, 2, 3, 1).reshape(C, 4 * C4)
        k2m = up2.weight.permute(0, 2, 3, 1).reshape(C4, 4 * C8)
        x = (src @ k1m).reshape(B, H, W, 2, 2, C4) + up1.bias
        x = F.gelu(ln(x))
        x = (x.reshape(-1, C4) @ k2m).reshape(B, H, W, 2, 2, 2, 2, C8) + up2.bias
        x = F.gelu(x)                                        # (b, i, j, p, q, r, s, c)
        m = torch.einsum("bkc,bijpqrsc->bkijpqrs", hyper, x)
        m = m.permute(0, 1, 2, 4, 6, 3, 5, 7)                 # (b, k, i, p, r, j, q, s)
        return m.reshape(B, hyper.shape[1], 4 * H, 4 * W)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                iou_only: bool = False, sel_channel: torch.Tensor | None = None):
        """image_embeddings, image_pe, dense_prompt (H, W, C) of one image;
        sparse_prompt (B, Np, C). Returns (masks (B, 4, 4H, 4W) logits,
        iou_pred (B, 4)); with `iou_only`, (None, iou_pred) from the factored
        token-side pass (no (B, H*W, C) tensor, no upscale). `sel_channel`
        (B,) mask-token indices: only that channel's mask is made, (B, 1,
        4H, 4W), the selection taken on the (B, 4, C/8) hypernetwork vectors
        (JAX's MaskDecoder sel_channel)."""
        H, W, C = image_embeddings.shape
        B = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.expand(B, -1, -1), sparse_prompt], dim=1)
        # the image side enters with batch 1, shared by every prompt
        src = (image_embeddings + dense_prompt).reshape(1, H * W, C)
        pos = image_pe.reshape(1, H * W, C)
        if iou_only:
            hs, _ = self.transformer.factored(src, pos, tokens)
            return None, self.iou_prediction_head(hs[:, 0])
        hs, src = self.transformer(src, pos, tokens)
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        hyper = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        if sel_channel is not None:
            hyper = hyper[torch.arange(B, device=hyper.device), sel_channel][:, None]
        masks = self._upscale_masks(src.expand(B, -1, -1), hyper, H, W)
        return masks, self.iou_prediction_head(hs[:, 0])


class SAM(nn.Module):
    """The three SAM modules under the reference checkpoint's names."""

    def __init__(self, cfg):
        super().__init__()
        grid = cfg.img_size // cfg.patch_size
        self.image_encoder = SAMImageEncoder(
            cfg.img_size, cfg.patch_size, cfg.encoder_embed_dim, cfg.encoder_depth,
            cfg.encoder_num_heads, cfg.window_size, cfg.encoder_global_attn_indexes,
            cfg.prompt_embed_dim)
        self.prompt_encoder = PromptEncoder(cfg.prompt_embed_dim,
                                            (cfg.img_size, cfg.img_size), (grid, grid))
        self.mask_decoder = MaskDecoder(cfg.prompt_embed_dim)
