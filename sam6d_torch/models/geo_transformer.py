"""Geometric transformer stack for point matching.

Port of `sam6d_tpu/models/geo_transformer.py` (reference
`Pose_Estimation_Model/model/transformer.py`): the geometric structure
embedding, RPE self-attention with the proj_p projection folded into the
query, vanilla cross-attention, focused linear attention and the
sparse-to-dense transformer. Module and parameter names follow the reference
`state_dict`; LayerNorm eps is 1e-6 as in the JAX package. Every module runs
in the dtype of its weights: the structure embedding's geometry and
sinusoids stay float32 (the point clouds are float32) and are cast where
they enter proj_d / proj_a, as flax's `Dense` casts them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embedding import pairwise_planar_diffs, sinusoid_phase_tables
from ..ops.geometry import pairwise_sq_distance

LN_EPS = 1e-6


def nearest_neighbours(points, k: int):
    """points (B, N, 3) -> (B, N, k + 1) indices of each point's k + 1
    nearest points, nearest first (the point itself, which the caller
    drops), selected on the matmul-form distance (the reference's near-tie
    ordering); a stable sort gives equal distances to the lower index, as
    jax.lax.top_k does (torch.topk promises no order among ties)."""
    d2 = pairwise_sq_distance(points, points)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k + 1]


class GeometricStructureEmbedding(nn.Module):
    def __init__(self, hidden_dim: int = 256, sigma_d: float = 0.2,
                 sigma_a: float = 15.0, angle_k: int = 3,
                 reduction_a: str = "max"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.sigma_d = sigma_d
        self.sigma_a = sigma_a
        self.angle_k = angle_k
        self.reduction_a = reduction_a
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, points):
        """points (B, N, 3) -> (B, N, N, hidden_dim): distance and k-wedge-angle
        sinusoids, projected, angle-k reduction applied to the projected
        embeddings one k at a time (max_k(xW + b) = max_k(xW) + b)."""
        B, N, _ = points.shape
        dev = points.device
        ax, ay, az = pairwise_planar_diffs(points)
        dist = torch.sqrt(ax * ax + ay * ay + az * az)
        dt = self.proj_d.weight.dtype
        div_d, phase = sinusoid_phase_tables(self.hidden_dim, 1.0 / self.sigma_d, dev)
        # torch.sin in bf16 too: the JAX package's bf16 path takes a
        # polynomial sin (geo_transformer._fast_sin) for speed, whose
        # difference lies inside bf16's own rounding noise
        # (tests/test_bf16_budget.py::test_fast_sin_error_below_bf16_cast_noise)
        out = self.proj_d(torch.sin(dist[..., None] * div_d + phase).to(dt))

        k = self.angle_k
        flat = nearest_neighbours(points, k)[..., 1:].reshape(B, N * k)
        px, py, pz = points[..., 0], points[..., 1], points[..., 2]
        rx = torch.gather(px, 1, flat).reshape(B, N, k) - px[..., None]
        ry = torch.gather(py, 1, flat).reshape(B, N, k) - py[..., None]
        rz = torch.gather(pz, 1, flat).reshape(B, N, k) - pz[..., None]

        div_a, _ = sinusoid_phase_tables(self.hidden_dim,
                                         180.0 / (self.sigma_a * np.pi), dev)
        a_out = None
        for kk in range(k):
            rxe, rye, rze = rx[..., kk:kk + 1], ry[..., kk:kk + 1], rz[..., kk:kk + 1]
            cx = rye * az - rze * ay
            cy = rze * ax - rxe * az
            cz = rxe * ay - rye * ax
            sin_v = torch.sqrt(cx * cx + cy * cy + cz * cz)
            # + 0.0 turns the diagonal's -0.0 into +0.0 (atan2(0, -0) = pi)
            cos_v = rxe * ax + rye * ay + rze * az + 0.0
            ang = torch.atan2(sin_v, cos_v)
            p = self.proj_a(torch.sin(ang[..., None] * div_a + phase).to(dt))
            if a_out is None:
                a_out = p
            elif self.reduction_a == "max":
                a_out = torch.maximum(a_out, p)
            else:
                a_out = a_out + p
        if self.reduction_a != "max" and k > 1:
            a_out = a_out / k
        return out + a_out


class AttentionOutput(nn.Module):
    """Post-LN FFN: expand 2x, ReLU, squeeze, residual, LayerNorm."""

    def __init__(self, d_model: int):
        super().__init__()
        self.expand = nn.Linear(d_model, d_model * 2)
        self.squeeze = nn.Linear(d_model * 2, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


def _heads(x, H):
    B, N, C = x.shape
    return x.reshape(B, N, H, C // H).transpose(1, 2)      # (B, H, N, dh)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in):
        H = self.num_heads
        q, k, v = (_heads(self.proj_q(q_in), H), _heads(self.proj_k(k_in), H),
                   _heads(self.proj_v(v_in), H))
        dh = q.shape[-1]
        attn = torch.softmax((q @ k.transpose(-1, -2)) / dh ** 0.5, dim=-1)
        out = attn @ v
        B, _, N, _ = out.shape
        return out.transpose(1, 2).reshape(B, N, -1)


class RPEMultiHeadAttention(nn.Module):
    """Self-attention with the additive relative score q . proj_p(embed),
    computed as (q W_p^T) . embed + q . b_p so the (B, N, M, C) embedding is
    read once and never projected. `embed` may have batch 1 (the template
    trunk cached at onboarding) and is then shared by every batch item."""

    def __init__(self, d_model: int, num_heads: int, embed_dim: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p = nn.Linear(embed_dim or d_model, d_model)

    def forward(self, q_in, k_in, v_in, embed_qk):
        H = self.num_heads
        q, k, v = (_heads(self.proj_q(q_in), H), _heads(self.proj_k(k_in), H),
                   _heads(self.proj_v(v_in), H))                 # (B, H, N, dh)
        B, _, N, dh = q.shape
        C_e = embed_qk.shape[-1]
        scores_e = q @ k.transpose(-1, -2)                       # (B, H, N, M)
        Wp = self.proj_p.weight.reshape(H, dh, C_e)              # (H, dh, C_e)
        qW = torch.einsum("bhnc,hce->bnhe", q, Wp)               # (B, N, H, C_e)
        qb = torch.einsum("bhnc,hc->bhn", q, self.proj_p.bias.reshape(H, dh))
        if embed_qk.shape[0] == 1 and B > 1:
            scores_p = torch.einsum("nme,bnhe->bhnm", embed_qk[0], qW)
        else:
            scores_p = torch.einsum("bnme,bnhe->bhnm", embed_qk, qW)
        scores = (scores_e + scores_p + qb[..., None]) / dh ** 0.5
        out = torch.softmax(scores, dim=-1) @ v
        return out.transpose(1, 2).reshape(B, N, -1)


class AttentionLayer(nn.Module):
    """attention -> linear -> residual -> LayerNorm (post-LN)."""

    def __init__(self, d_model: int, num_heads: int, rpe: bool = False):
        super().__init__()
        self.rpe = rpe
        self.attention = (RPEMultiHeadAttention(d_model, num_heads) if rpe
                          else MultiHeadAttention(d_model, num_heads))
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory, embed=None):
        if self.rpe:
            h = self.attention(x, memory, memory, embed)
        else:
            h = self.attention(x, memory, memory)
        return self.norm(self.linear(h) + x)


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, rpe: bool = False):
        super().__init__()
        self.attention = AttentionLayer(d_model, num_heads, rpe)
        self.output = AttentionOutput(d_model)

    def forward(self, x, memory, embed=None):
        return self.output(self.attention(x, memory, embed))


class GeometricTransformer(nn.Module):
    """['self', 'cross'] block pair: RPE self-attention on each cloud, then
    sequential cross-attention (cloud 1 attends to the updated cloud 0)."""

    def __init__(self, d_model: int, num_heads: int, blocks=("self", "cross")):
        super().__init__()
        self.blocks = tuple(blocks)
        self.layers = nn.ModuleList(
            [TransformerLayer(d_model, num_heads, rpe=(b == "self"))
             for b in self.blocks])

    def forward(self, f0, e0, f1, e1):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                f0 = layer(f0, f0, e0)
                f1 = layer(f1, f1, e1)
            else:
                f0 = layer(f0, f1)
                f1 = layer(f1, f0)
        return f0, f1


class FocusedLinearAttention(nn.Module):
    """Focused linear attention (Flatten-Transformer) in its O(N) form: ReLU
    kernel, softplus scale, focusing power, norm restoration."""

    def __init__(self, d_model: int, num_heads: int, focusing_factor: int = 3):
        super().__init__()
        self.num_heads = num_heads
        self.focusing_factor = focusing_factor
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.scale = nn.Parameter(torch.zeros(1, 1, d_model))

    def forward(self, q_in, k_in, v_in):
        q = F.relu(self.proj_q(q_in)) + 1e-6
        k = F.relu(self.proj_k(k_in)) + 1e-6
        v = self.proj_v(v_in)
        scale = F.softplus(self.scale)
        q = q / scale
        k = k / scale
        q_norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        k_norm = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
        q = q ** self.focusing_factor
        k = k ** self.focusing_factor
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True) * q_norm
        k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True) * k_norm
        H = self.num_heads
        B, N, C = q.shape
        M = k.shape[1]
        q = q.reshape(B, N, H, C // H)
        k = k.reshape(B, M, H, C // H)
        v = v.reshape(B, M, H, C // H)
        z = 1.0 / (torch.einsum("bnhc,bhc->bnh", q, k.sum(1)) + 1e-6)
        kv = torch.einsum("bmhc,bmhd->bhcd", k, v)
        out = torch.einsum("bnhc,bhcd->bnhd", q, kv) * z[..., None]
        return out.reshape(B, N, C)


class LinearAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, focusing_factor: int = 3):
        super().__init__()
        self.attention = FocusedLinearAttention(d_model, num_heads, focusing_factor)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory):
        return self.norm(self.linear(self.attention(x, memory, memory)) + x)


class LinearTransformerLayer(nn.Module):
    """linear attention -> linear -> post-LN residual -> FFN (reference
    transformer.py:567-608)."""

    def __init__(self, d_model: int, num_heads: int, focusing_factor: int = 3):
        super().__init__()
        self.attention = LinearAttentionLayer(d_model, num_heads, focusing_factor)
        self.output = AttentionOutput(d_model)

    def forward(self, x, memory):
        return self.output(self.attention(x, memory))


class SparseToDenseTransformer(nn.Module):
    """Gather FPS tokens (+bg), geometric attention on the sparse set, then
    sparse -> dense propagation by linear attention (reference :613-673)."""

    def __init__(self, d_model: int, num_heads: int = 4, focusing_factor: int = 3):
        super().__init__()
        self.sparse_layer = GeometricTransformer(d_model, num_heads)
        self.dense_layer = LinearTransformerLayer(d_model, num_heads, focusing_factor)

    @staticmethod
    def _sample(dense, fps_idx):
        # Reference quirk (transformer.py:651-658), kept on purpose: fps_idx
        # indexes the bg-LESS cloud but gathers from the bg-PREPENDED tokens.
        B, _, C = dense.shape
        idx = fps_idx.long().expand(B, -1)[..., None].expand(-1, -1, C)
        return torch.cat([dense[:, :1], torch.gather(dense, 1, idx)], dim=1)

    def forward(self, dense0, e0, fps_idx0, dense1, e1, fps_idx1):
        f0, f1 = self.sparse_layer(self._sample(dense0, fps_idx0), e0,
                                   self._sample(dense1, fps_idx1), e1)
        d0 = self.dense_layer(dense0[:, 1:], f0[:, 1:])
        d1 = self.dense_layer(dense1[:, 1:], f1[:, 1:])
        return (torch.cat([f0[:, :1], d0], dim=1),
                torch.cat([f1[:, :1], d1], dim=1))
