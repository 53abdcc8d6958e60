"""PEM weights for the port.

The port's modules carry the reference `state_dict` names, so the released
`sam-6d-pem-base.pth` loads as it is. `pem_state_dict_from_flax` turns the
JAX package's PEM variables into a port `state_dict`; it is the exact inverse
of `sam6d_tpu.weights.convert_pem.convert_pem_state_dict`.
`mae_vit_state_dict` reads the MAE pre-training checkpoint that training
starts the backbone from (the counterpart of `convert_mae_vit`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.pem import PEMNet
from .checkpoint import (_depth, _layernorm, _linear, _unstack,
                         load_torch_checkpoint)


def load_reference_checkpoint(path: str, net: PEMNet):
    """Load a reference checkpoint (.pth, a bare `state_dict` or gorilla's
    {'model': ...}) into `net`. Every parameter and buffer of `net` must be
    in the file; keys the port has no module for (e.g. a classifier head
    the inference path never runs) are returned, not loaded."""
    sd = load_torch_checkpoint(path)
    own = net.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} PEM keys, e.g. {missing[:5]}")
    net.load_state_dict({k: torch.as_tensor(np.asarray(sd[k])) for k in own},
                        strict=True)
    return sorted(set(sd) - set(own))


def mae_vit_state_dict(sd, depth: int = 12) -> Dict[str, torch.Tensor]:
    """The MAE pre-training checkpoint (`mae_pretrain_vit_base.pth`: a
    'model' dict under plain timm ViT names, reference
    feature_extraction.py:78-95) -> the `state_dict` of the port's `ViT`
    (`PEMNet.feature_extraction.rgb_net.vit`): cls_token, pos_embed,
    patch_embed, `depth` blocks and the final norm. Other entries (the MAE
    decoder, the mask token) are not read. `sd` is a mapping of arrays or a
    checkpoint path."""
    if isinstance(sd, str):
        sd = load_torch_checkpoint(sd)
    names = ["cls_token", "pos_embed", "patch_embed.proj.weight", "patch_embed.proj.bias",
             "norm.weight", "norm.bias"]
    for i in range(depth):
        names += [f"blocks.{i}.{m}.{p}" for m in ("norm1", "attn.qkv", "attn.proj", "norm2",
                                                   "mlp.fc1", "mlp.fc2")
                  for p in ("weight", "bias")]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"MAE checkpoint lacks {len(missing)} ViT keys, e.g. {missing[:5]}")
    return {n: torch.from_numpy(np.array(sd[n], np.float32)) for n in names}


def _transformer_layer(sd, prefix, d, rpe: bool):
    att = d["attention"]
    names = ("proj_q", "proj_k", "proj_v") + (("proj_p",) if rpe else ())
    for n in names:
        _linear(sd, f"{prefix}.attention.attention.{n}", att["attention"][n])
    _linear(sd, f"{prefix}.attention.linear", att["linear"])
    _layernorm(sd, f"{prefix}.attention.norm", att["norm"])
    _attention_output(sd, f"{prefix}.output", d["output"])


def _attention_output(sd, prefix, d):
    _linear(sd, f"{prefix}.expand", d["expand"])
    _linear(sd, f"{prefix}.squeeze", d["squeeze"])
    _layernorm(sd, f"{prefix}.norm", d["norm"])


def _geometric_transformer(sd, prefix, d):
    _transformer_layer(sd, f"{prefix}.layers.0", d["layers_0"], rpe=True)
    _transformer_layer(sd, f"{prefix}.layers.1", d["layers_1"], rpe=False)


def pem_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX PEM variables {'params', 'batch_stats'} (nested dicts of arrays,
    scanned blocks stacked on axis 0) -> port `state_dict`."""
    p = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    fx = "feature_extraction.rgb_net"
    vit = p["feature_extraction"]["vit"]
    sd[f"{fx}.vit.cls_token"] = np.asarray(vit["cls_token"])
    sd[f"{fx}.vit.pos_embed"] = np.asarray(vit["pos_embed"])
    sd[f"{fx}.vit.patch_embed.proj.weight"] = np.asarray(
        vit["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{fx}.vit.patch_embed.proj.bias"] = np.asarray(vit["patch_embed"]["bias"])
    blocks = vit["blocks"]["block"]
    for i in range(_depth(blocks)):
        b, pre = _unstack(blocks, i), f"{fx}.vit.blocks.{i}"
        _layernorm(sd, f"{pre}.norm1", b["norm1"])
        _linear(sd, f"{pre}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", b["attn"]["proj"])
        _layernorm(sd, f"{pre}.norm2", b["norm2"])
        _linear(sd, f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", b["mlp"]["fc2"])
    _layernorm(sd, f"{fx}.vit.norm", vit["norm"])
    _linear(sd, f"{fx}.output_upscaling",
            p["feature_extraction"]["decoder"]["output_upscaling"])

    _linear(sd, "geo_embedding.proj_d", p["geo_embedding"]["proj_d"])
    _linear(sd, "geo_embedding.proj_a", p["geo_embedding"]["proj_a"])

    cm = p["coarse_point_matching"]
    _linear(sd, "coarse_point_matching.in_proj", cm["in_proj"])
    _linear(sd, "coarse_point_matching.out_proj", cm["out_proj"])
    sd["coarse_point_matching.bg_token"] = np.asarray(cm["bg_token"])
    for i in range(_depth(cm["transformers"]["block"])):
        _geometric_transformer(sd, f"coarse_point_matching.transformers.{i}",
                               _unstack(cm["transformers"]["block"], i))

    pe, pe_stats = p["fine_pe"], stats["fine_pe"]
    for mlp in ("mlp1", "mlp2"):
        n_layers = sum(1 for k in pe[mlp] if k.startswith("conv_"))
        for i in range(n_layers):
            pre = f"fine_point_matching.PE.{mlp}.layer{i}"
            sd[f"{pre}.conv.weight"] = np.asarray(
                pe[mlp][f"conv_{i}"]["kernel"]).T[:, :, None, None]
            bn, bs = pe[mlp][f"bn_{i}"], pe_stats[mlp][f"bn_{i}"]
            sd[f"{pre}.normlayer.bn.weight"] = np.asarray(bn["scale"])
            sd[f"{pre}.normlayer.bn.bias"] = np.asarray(bn["bias"])
            sd[f"{pre}.normlayer.bn.running_mean"] = np.asarray(bs["mean"])
            sd[f"{pre}.normlayer.bn.running_var"] = np.asarray(bs["var"])
            sd[f"{pre}.normlayer.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    sd["fine_point_matching.PE.mlp3.conv.weight"] = np.asarray(
        pe["mlp3"]["kernel"]).T[:, :, None]
    sd["fine_point_matching.PE.mlp3.conv.bias"] = np.asarray(pe["mlp3"]["bias"])

    fm = p["fine_point_matching"]
    _linear(sd, "fine_point_matching.in_proj", fm["in_proj"])
    _linear(sd, "fine_point_matching.out_proj", fm["out_proj"])
    sd["fine_point_matching.bg_token"] = np.asarray(fm["bg_token"])
    for i in range(_depth(fm["transformers"]["block"])):
        blk = _unstack(fm["transformers"]["block"], i)
        pre = f"fine_point_matching.transformers.{i}"
        _geometric_transformer(sd, f"{pre}.sparse_layer", blk["sparse_layer"])
        dl = blk["dense_layer"]
        for n in ("proj_q", "proj_k", "proj_v"):
            _linear(sd, f"{pre}.dense_layer.attention.attention.{n}",
                    dl["attention"][n])
        sd[f"{pre}.dense_layer.attention.attention.scale"] = np.asarray(
            dl["attention"]["scale"])
        _linear(sd, f"{pre}.dense_layer.attention.linear", dl["linear"])
        _layernorm(sd, f"{pre}.dense_layer.attention.norm", dl["norm"])
        _attention_output(sd, f"{pre}.dense_layer.output", dl["output"])

    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def random_pem_state_dict(net: PEMNet, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights for `net` (fan-in scaled normal matrices, zero
    biases, unit norms, 0.02-normal tokens, identity BN statistics)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in net.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros_like(t)
        elif leaf in ("running_mean", "bias") or name.endswith("attention.scale"):
            sd[name] = torch.zeros_like(t)
        elif leaf == "running_var":
            sd[name] = torch.ones_like(t)
        elif leaf in ("cls_token", "pos_embed", "bg_token"):
            sd[name] = 0.02 * torch.randn(t.shape, generator=g)
        elif t.dim() == 1:                      # LayerNorm / BatchNorm scale
            sd[name] = torch.ones_like(t)
        else:
            fan_in = t[0].numel()
            sd[name] = torch.randn(t.shape, generator=g) / fan_in ** 0.5
    return sd
