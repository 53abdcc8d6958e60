"""The bf16 error budget of the inference stages: the port's own copy of what
it needs from `scripts/bf16_budget.py` (the recorded budgets and the q99
error metric), so that the card's check (`chip_smoke.py` phase 12) and the
CPU tests hold the bf16 path to the same numbers as the JAX package.

Each stage runs twice on identical weights and inputs, once in bf16 and
once in float32; its error is `q99_rel(bf16 output, fp32 output)`, and
`BUDGETS` is the most each stage may show (PEM's rotation is compared by
its geodesic angle instead: q99 of the angle in degrees over 180).
"""
from __future__ import annotations

import numpy as np

# q99 of |bf16 - fp32| in units of the fp32 output's RMS (pem_R: q99 of the
# geodesic angle / 180 degrees); the JAX package's recorded budgets
BUDGETS = {
    "sam_encode": 0.06,
    "amg_decode_masks": 0.08,
    "amg_decode_iou": 0.04,
    "dinov2_cls": 0.04,
    "dinov2_patch": 0.10,
    "ism_scores": 0.05,
    "pem_R": 0.02,
    "pem_t": 0.05,
    "pem_score": 0.05,
}


def q99_rel(bf, fp) -> float:
    """q99 of |bf - fp| in units of the fp32 tensor's RMS: scale-invariant,
    so the small activations of deep fan-in-scaled stacks do not turn
    ordinary rounding into large relative errors."""
    bf = np.asarray(bf, np.float32).ravel()
    fp = np.asarray(fp, np.float32).ravel()
    rms = float(np.sqrt(np.mean(fp * fp))) + 1e-12
    return float(np.quantile(np.abs(bf - fp), 0.99) / rms)


def rotation_q99(R_bf, R_fp) -> float:
    """q99 over the batch of the geodesic angle between two (B, 3, 3)
    rotation stacks, in degrees over 180 (the pem_R metric)."""
    R_bf = np.asarray(R_bf, np.float64)
    R_fp = np.asarray(R_fp, np.float64)
    tr = np.clip((np.einsum("bij,bij->b", R_bf, R_fp) - 1) / 2, -1, 1)
    return float(np.quantile(np.degrees(np.arccos(tr)), 0.99) / 180.0)
