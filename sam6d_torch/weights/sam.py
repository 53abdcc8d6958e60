"""SAM weights for the port.

The port's SAM carries the reference `state_dict` names (`image_encoder.*`,
`prompt_encoder.*`, `mask_decoder.*`), so the released
`sam_vit_h_4b8939.pth` loads as it is (`load_reference_checkpoint`).
`sam_state_dict_from_flax` carries the JAX package's SAM variables into a
port `state_dict`: the inverse of
`sam6d_tpu.weights.convert_sam.convert_sam_state_dict`, which stacks the
scanned encoder blocks, zero-pads the windowed rel-pos tables to the global
length and stores the ConvTranspose kernels spatially flipped.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .checkpoint import _depth, _layernorm, _linear, _unstack, load_torch_checkpoint


def load_reference_checkpoint(path: str, net) -> list:
    """Load a reference SAM checkpoint into the port's `SAM` module `net`
    (every parameter must be in the file). Returns the file's keys the port
    has no module for."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in load_torch_checkpoint(path).items()}
    own = net.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} SAM keys, e.g. {missing[:5]}")
    net.load_state_dict({k: sd[k] for k in own}, strict=True)
    return sorted(set(sd) - set(own))


def random_sam_state_dict(net, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded random weights for `net` (its tensors may be on the meta
    device: only names and shapes are read), drawn by a generator on
    `device`: fan-in scaled normal matrices, zero biases, unit LayerNorm
    weights, 0.02-normal position embeddings and rel-pos tables, unit-normal
    token embeddings and Fourier matrix."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=dev)

    tokens = {f"{n}.weight" for n, m in net.named_modules()
              if isinstance(m, torch.nn.Embedding)}
    sd = {}
    for name, t in net.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            sd[name] = normal(shape, 0.02)
        elif name in tokens or leaf == "positional_encoding_gaussian_matrix":
            sd[name] = normal(shape, 1.0)
        elif leaf == "bias":
            sd[name] = torch.zeros(shape, device=dev)
        elif len(shape) == 1:                        # LayerNorm weight
            sd[name] = torch.ones(shape, device=dev)
        else:
            fan_in = shape[1] * int(np.prod(shape[2:])) if len(shape) > 2 else shape[1]
            if "output_upscaling" in name:           # ConvTranspose (in, out, kh, kw)
                fan_in = shape[0]
            sd[name] = normal(shape, fan_in ** -0.5)
    return sd


def _conv(sd, prefix, d):
    """flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in d:
        sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _conv_transpose(sd, prefix, d):
    """flax ConvTranspose kernel (kh, kw, in, out), spatially flipped ->
    torch ConvTranspose2d (in, out, kh, kw)."""
    sd[f"{prefix}.weight"] = np.asarray(d["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _ln2d(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.asarray(d["weight"])
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _attention(sd, prefix, d):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, f"{prefix}.{name}", d[name])


def sam_state_dict_from_flax(variables, cfg) -> Dict[str, torch.Tensor]:
    """JAX SAM variables ({'image_encoder': {'params': ...},
    'prompt_encoder': ..., 'mask_decoder': ...}) -> port `state_dict`
    (reference names) for the SAMConfig `cfg`."""
    sd: Dict[str, np.ndarray] = {}
    enc = variables["image_encoder"]["params"]
    p = "image_encoder"
    _conv(sd, f"{p}.patch_embed.proj", enc["patch_embed"])
    sd[f"{p}.pos_embed"] = np.asarray(enc["pos_embed"])
    blocks = enc["blocks"]["block"]
    L = 2 * cfg.window_size - 1
    for i in range(_depth(blocks)):
        b, pre = _unstack(blocks, i), f"{p}.blocks.{i}"
        windowed = i not in cfg.encoder_global_attn_indexes
        _layernorm(sd, f"{pre}.norm1", b["norm1"])
        _linear(sd, f"{pre}.attn.qkv", b["attn_qkv"])
        _linear(sd, f"{pre}.attn.proj", b["attn_proj"])
        # windowed tables are stored zero-padded to the global length
        sd[f"{pre}.attn.rel_pos_h"] = b["rel_pos_h"][:L] if windowed else b["rel_pos_h"]
        sd[f"{pre}.attn.rel_pos_w"] = b["rel_pos_w"][:L] if windowed else b["rel_pos_w"]
        _layernorm(sd, f"{pre}.norm2", b["norm2"])
        _linear(sd, f"{pre}.mlp.lin1", b["mlp"]["lin1"])
        _linear(sd, f"{pre}.mlp.lin2", b["mlp"]["lin2"])
    _conv(sd, f"{p}.neck.0", enc["neck_conv1"])
    _ln2d(sd, f"{p}.neck.1", enc["neck_ln1"])
    _conv(sd, f"{p}.neck.2", enc["neck_conv2"])
    _ln2d(sd, f"{p}.neck.3", enc["neck_ln2"])

    pe = variables["prompt_encoder"]["params"]
    p = "prompt_encoder"
    sd[f"{p}.pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(pe["pe_gaussian"])
    for i in range(4):
        sd[f"{p}.point_embeddings.{i}.weight"] = np.asarray(pe["point_embeddings"])[i:i + 1]
    sd[f"{p}.not_a_point_embed.weight"] = np.asarray(pe["not_a_point_embed"])
    sd[f"{p}.no_mask_embed.weight"] = np.asarray(pe["no_mask_embed"])
    for idx, name in ((0, "mask_conv1"), (3, "mask_conv2"), (6, "mask_conv3")):
        _conv(sd, f"{p}.mask_downscaling.{idx}", pe[name])
    for idx, name in ((1, "mask_ln1"), (4, "mask_ln2")):
        _ln2d(sd, f"{p}.mask_downscaling.{idx}", pe[name])

    dec = variables["mask_decoder"]["params"]
    p = "mask_decoder"
    tr = dec["transformer"]
    n_layers = sum(1 for k in tr if k.startswith("layers_"))
    for i in range(n_layers):
        lt, pre = tr[f"layers_{i}"], f"{p}.transformer.layers.{i}"
        for name in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _attention(sd, f"{pre}.{name}", lt[name])
        for name in ("norm1", "norm2", "norm3", "norm4"):
            _layernorm(sd, f"{pre}.{name}", lt[name])
        _linear(sd, f"{pre}.mlp.lin1", lt["mlp"]["lin1"])
        _linear(sd, f"{pre}.mlp.lin2", lt["mlp"]["lin2"])
    _attention(sd, f"{p}.transformer.final_attn_token_to_image",
               tr["final_attn_token_to_image"])
    _layernorm(sd, f"{p}.transformer.norm_final_attn", tr["norm_final_attn"])
    sd[f"{p}.iou_token.weight"] = np.asarray(dec["iou_token"])
    sd[f"{p}.mask_tokens.weight"] = np.asarray(dec["mask_tokens"])
    _conv_transpose(sd, f"{p}.output_upscaling.0", dec["upscale_conv1"])
    _ln2d(sd, f"{p}.output_upscaling.1", dec["upscale_ln"])
    _conv_transpose(sd, f"{p}.output_upscaling.3", dec["upscale_conv2"])
    n_tokens = sum(1 for k in dec if k.startswith("hyper_mlps_"))
    for i in range(n_tokens):
        for j in range(3):
            _linear(sd, f"{p}.output_hypernetworks_mlps.{i}.layers.{j}",
                    dec[f"hyper_mlps_{i}"][f"layers_{j}"])
    for j in range(3):
        _linear(sd, f"{p}.iou_prediction_head.layers.{j}",
                dec["iou_prediction_head"][f"layers_{j}"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
