"""Random weights and inputs of the bf16 budget harness, shared by the CPU
tests (`tests/test_torch_port_bf16.py`) and the card's check
(`chip_smoke.py` phase 12). Imports torch, numpy and sam6d_torch only, so
`chip_smoke.py` imports it where JAX is absent.

- `rand_like_state_dict`: the JAX package's `rand_like_tree`
  (scripts/bf16_budget.py) for a port network, drawn on the flax layout
  its converter fills.
- `conditioned_pem_state_dict` and `posed_pem_frame`: the PEM stage's
  weights and frame, conditioned so that its pose has an answer in fp32 at
  all (the functions' docstrings say why).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from sam6d_torch.data.synthetic import random_rotation

# The port's ModuleLists whose blocks the JAX package runs under nn.scan:
# flax stores each of their parameters once, stacked along a leading depth
# axis, and `rand_like_tree` draws on that layout (by the class name of the
# network the list belongs to)
SCANNED = {
    "SAM": ("image_encoder.blocks",),
    "DINOv2": ("blocks",),
    "PEMNet": ("feature_extraction.rgb_net.vit.blocks", "coarse_point_matching.transformers",
               "fine_point_matching.transformers"),
}
# ModuleLists of (1, C) embeddings that flax keeps as one (n, C) leaf
MERGED = {"SAM": ("prompt_encoder.point_embeddings",)}


def _flax_lead(module: nn.Module, name: str, t: torch.Tensor) -> int:
    """The product of all axes but the last of the flax leaf that holds
    parameter `name` of `module` (its own shape, without a stack's axis): a
    Linear or convolution weight's input axes, a transposed convolution's
    input and kernel axes, any other tensor's leading axes."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return int(t.shape[0] * t[0, 0].numel())
    if name == "weight" and isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return int(t[0].numel())
    return int(np.prod(t.shape[:-1]))


def _stack_of(net: nn.Module, key: str):
    """(depth, stack prefix) of the scanned ModuleList `key` lies in, or
    (1, None)."""
    for prefix in SCANNED.get(type(net).__name__, ()):
        if key.startswith(prefix + "."):
            return len(net.get_submodule(prefix)), prefix
    return 1, None


@torch.no_grad()
def rand_like_state_dict(net: nn.Module, seed: int,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """Random weights for `net` (every parameter and floating buffer, in
    state_dict order; `net` may live on the meta device) drawn as the JAX
    package's `rand_like_tree` draws the same network's flax tree: a leaf of
    one or no axis 1 + 0.05 N(0, 1) (norm scales and biases, O(1) so deep
    stacks stay conditioned); any other leaf N(0, 1) / sqrt(fan-in), the
    fan-in being the product of all its axes but the last (the statistics a
    trained checkpoint roughly has); integer buffers zero. The leaf is the
    flax one: a block of a scanned stack (`SCANNED`) holds its parameters
    with a leading depth axis, so their fan-in includes the depth and their
    1-D tensors are 2-D leaves (N(0, 1) / sqrt(depth)); the rel-pos tables
    of a scanned SAM stack are stored at the stack's largest size; the
    `MERGED` lists are one leaf. One generator on `device`, seeded by
    `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    owner = {}
    for mod_name, mod in net.named_modules():
        for name, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            owner[f"{mod_name}.{name}" if mod_name else name] = (mod, name)
    state = net.state_dict()
    rows = {}   # (stack prefix, leaf name) -> largest leading size in the stack
    for key, t in state.items():
        depth, prefix = _stack_of(net, key)
        if prefix is not None and t.dim() >= 2:
            leaf = key[len(prefix) + 1:].split(".", 1)[1]
            rows[prefix, leaf] = max(rows.get((prefix, leaf), 0), int(t.shape[0]))
    merged = {p: len(net.get_submodule(p)) for p in MERGED.get(type(net).__name__, ())}
    out = {}
    for key, t in state.items():
        if not torch.is_floating_point(t):
            out[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        x = torch.randn(t.shape, generator=gen, device=device, dtype=torch.float32)
        depth, prefix = _stack_of(net, key)
        mod, name = owner[key]
        lists = [n for p, n in merged.items() if key.startswith(p + ".")]
        if lists:
            lead = lists[0]
        elif prefix is not None and t.dim() >= 2:
            leaf = key[len(prefix) + 1:].split(".", 1)[1]
            lead = _flax_lead(mod, name, t)
            if leaf.endswith("rel_pos_h") or leaf.endswith("rel_pos_w"):
                lead = rows[prefix, leaf]
            lead *= depth
        elif prefix is not None:
            lead = depth           # a 1-D tensor of a stack: a (depth, C) leaf
        elif t.dim() <= 1:
            out[key] = 1.0 + 0.05 * x
            continue
        else:
            lead = _flax_lead(mod, name, t)
        out[key] = x * float(lead) ** -0.5
    return out


# the matching heads' residual branches: each attention layer's output
# projection and each feed-forward's squeeze
_BRANCH_OUTPUTS = (".attention.linear.weight", ".output.squeeze.weight")
_MATCHING_HEADS = ("coarse_point_matching.", "fine_point_matching.")
# what conditioned_pem_state_dict scales them by, and every bias
CONDITIONING_SCALE = 0.1


def conditioned_pem_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """PEM weights from `rand_like_state_dict(PEMNet)` with every bias and
    BatchNorm running mean, and the matching heads' residual branches
    (`_BRANCH_OUTPUTS`), scaled by CONDITIONING_SCALE.

    Under the plain draw every bias is O(1) and every residual branch as
    large as its input, so each post-LN layer of the matching heads adds one
    vector common to all tokens: after the blocks every token points the
    same way, the fp32 fine similarities of all pairs lie within ~0.01 of
    1 / temp = 10 (below bf16's spacing there, 0.0625), and the pose has no
    answer to agree on in either package, fp32 included. Scaled so, the
    tokens keep their own direction, the true pair of a posed frame
    (`posed_pem_frame`) holds the largest similarity of its row, and the
    fp32 solve recovers the frame's pose within a degree."""
    out = {}
    for k, v in sd.items():
        if k.endswith(("bias", "running_mean")) or (
                k.startswith(_MATCHING_HEADS) and k.endswith(_BRANCH_OUTPUTS)):
            v = v * CONDITIONING_SCALE
        out[k] = v
    return out


def posed_pem_frame(rng: np.random.RandomState, cfg, B: int, features):
    """A PEM frame whose pose is known: the observed cloud (`pts`, B x
    fine_npoint points in a 0.1 m cube, with random image features
    `features(rgb, choose)` -> numpy (B, N, C)) and, as the template, the
    same points in the object's frame under a random rigid pose (R, t: pts
    = dense_po @ R^T + t), with the same features; the model points are the
    template's first n_sample_model_point. Returns (the inputs of
    PEMNet.infer as numpy arrays, R, t)."""
    S, NF = cfg.img_size, cfg.fine_npoint
    rgb = rng.rand(B, S, S, 3).astype(np.float32)
    choose = rng.randint(0, S * S, (B, NF)).astype(np.int64)
    pts = (rng.rand(B, NF, 3) * 0.1).astype(np.float32)
    R = np.stack([random_rotation(rng) for _ in range(B)])
    t = ((rng.rand(B, 3) - 0.5) * 0.05).astype(np.float32)
    dense_po = np.einsum("bnj,bji->bni", pts - t[:, None], R).astype(np.float32)
    inputs = dict(rgb=rgb, rgb_choose=choose, pts=pts, dense_po=dense_po,
                  dense_fo=np.array(features(rgb, choose), np.float32),
                  model=dense_po[:, :cfg.n_sample_model_point].copy())
    return inputs, R, t
