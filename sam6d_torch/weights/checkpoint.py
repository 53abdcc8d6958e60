"""Reading reference PyTorch checkpoints (`.pth`) into numpy arrays, and
the helpers that turn the JAX package's parameter trees into port
`state_dict` entries."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's `state_dict` as numpy arrays: a bare `state_dict`, or
    one under 'model' (gorilla) or 'state_dict'."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt)) if isinstance(ckpt, dict) else ckpt
    return {k: (v.detach().cpu().numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in sd.items()}


def _linear(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _layernorm(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.asarray(d["scale"])
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _unstack(tree, i):
    """Slice item i of a tree of arrays stacked on axis 0 (nn.scan layout)."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]
