"""DINOv2 weights for the port.

The port's DINOv2 carries the reference `state_dict` names, so the released
`dinov2_vitl14_pretrain.pth` loads with one change: its 518-input position
embedding (37x37 grid) is interpolated to the 224-input grid once, at load,
with the reference's interpolate_pos_encoding rule (vision_transformer.py
:179-211: bicubic, scale_factor (g + 0.1) / M, no antialias).
`dinov2_state_dict_from_flax` carries the JAX package's DINOv2 variables
into a port `state_dict` (the inverse of
`sam6d_tpu.weights.convert_dinov2.convert_dinov2_state_dict`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dinov2 import DINOv2
from .checkpoint import (_depth, _layernorm, _linear, _unstack,
                         load_torch_checkpoint)


def interpolate_pos_embed(pos: torch.Tensor, target_grid: int,
                          offset: float = 0.1) -> torch.Tensor:
    """(1, 1 + M*M, C) -> (1, 1 + g*g, C), the DINOv2 rule."""
    cls, body = pos[:, :1], pos[:, 1:]
    M = int(round(body.shape[1] ** 0.5))
    C = pos.shape[-1]
    if M == target_grid:
        return pos
    t = body.reshape(1, M, M, C).permute(0, 3, 1, 2).float()
    out = F.interpolate(t, scale_factor=(target_grid + offset) / M,
                        mode="bicubic", antialias=False,
                        recompute_scale_factor=False)
    if out.shape[-1] != target_grid:
        raise ValueError(f"pos_embed interpolation gave {tuple(out.shape)}")
    out = out.permute(0, 2, 3, 1).reshape(1, target_grid * target_grid, C)
    return torch.cat([cls.float(), out], dim=1)


def load_reference_checkpoint(path: str, net: DINOv2):
    """Load a reference DINOv2 checkpoint (a bare `state_dict`, as
    dinov2_vitl14_pretrain.pth is) into an unfolded `net`. Every parameter
    of `net` must be in the file; the keys the port has no module for (e.g.
    `mask_token`) are returned, not loaded."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in load_torch_checkpoint(path).items()}
    own = net.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} DINOv2 keys, e.g. {missing[:5]}")
    grid = int(round((own["pos_embed"].shape[1] - 1) ** 0.5))
    sd["pos_embed"] = interpolate_pos_embed(sd["pos_embed"], grid)
    net.load_state_dict({k: sd[k] for k in own}, strict=True)
    return sorted(set(sd) - set(own))


def dinov2_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX DINOv2 variables ({'params': ...}, unfolded, scanned blocks
    stacked on axis 0) -> port `state_dict` (reference names)."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {
        "cls_token": np.asarray(p["cls_token"]),
        "pos_embed": np.asarray(p["pos_embed"]),
        "patch_embed.proj.weight": np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": np.asarray(p["patch_embed"]["bias"]),
    }
    blocks = p["blocks"]["block"]
    for i in range(_depth(blocks)):
        b, pre = _unstack(blocks, i), f"blocks.{i}"
        _layernorm(sd, f"{pre}.norm1", b["norm1"])
        _linear(sd, f"{pre}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", b["attn"]["proj"])
        sd[f"{pre}.ls1.gamma"] = np.asarray(b["ls1_gamma"])
        _layernorm(sd, f"{pre}.norm2", b["norm2"])
        _linear(sd, f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", b["mlp"]["fc2"])
        sd[f"{pre}.ls2.gamma"] = np.asarray(b["ls2_gamma"])
    _layernorm(sd, "norm", p["norm"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def random_dinov2_state_dict(net: DINOv2, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights for an unfolded `net`: fan-in scaled normal
    matrices, zero biases, unit LayerNorm and LayerScale, 0.02-normal
    cls/pos tokens."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in net.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "pos_embed"):
            sd[name] = 0.02 * torch.randn(t.shape, generator=g)
        elif leaf == "bias":
            sd[name] = torch.zeros_like(t)
        elif t.dim() == 1:                      # LayerNorm weight, LayerScale
            sd[name] = torch.ones_like(t)
        else:
            sd[name] = torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5
    return sd
