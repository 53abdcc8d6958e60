"""Positional / geometric embedding helpers (port of
`sam6d_tpu/ops/embedding.py`)."""
from __future__ import annotations

import numpy as np
import torch


def sinusoid_phase_tables(d_model: int, scale: float = 1.0, device=None):
    """Interleaved [sin, cos] embedding as one sin: emb = sin(x[..., None] *
    div2 + phase) with div2 = repeat(div * scale, 2), phase = tile([0, pi/2]).
    Same float32 tables as the JAX package (computed in float64, rounded)."""
    if d_model % 2 != 0:
        raise ValueError(f"odd d_model: {d_model}")
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d_model))
    div2 = np.repeat(div * scale, 2).astype(np.float32)
    phase = np.tile(np.array([0.0, np.pi / 2], np.float64),
                    d_model // 2).astype(np.float32)
    return (torch.from_numpy(div2).to(device),
            torch.from_numpy(phase).to(device))


def pairwise_planar_diffs(points: torch.Tensor):
    """points (B, N, 3) -> (ax, ay, az), each (B, N, N) with
    a[b, n, m] = p[b, m] - p[b, n]."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    return (px[:, None, :] - px[:, :, None],
            py[:, None, :] - py[:, :, None],
            pz[:, None, :] - pz[:, :, None])
