"""FastSAM weights for the port.

The port's `FastSAMNet` carries the ultralytics names under `model.{i}`, so
a FastSAM-x.pt `state_dict` (`model.model.{i}...`) loads once the prefix
is shortened (`load_reference_checkpoint`). The checkpoint's fixed DFL conv
(`model.22.dfl.conv.weight`, an arange the port computes) is not loaded.
`fastsam_state_dict_from_flax` carries the JAX package's FastSAM variables
into a port `state_dict`: the inverse of
`sam6d_tpu.weights.convert_fastsam.convert_fastsam_state_dict`, which
transposes the convolutions to HWIO, flips the ConvTranspose kernel
spatially and keeps the BatchNorm statistics under 'batch_stats'.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def reference_state_dict(sd) -> Dict[str, np.ndarray]:
    """A FastSAM checkpoint (a path, or a mapping under the ultralytics
    names) -> arrays under the port's names (`model.model.` -> `model.`).
    A file that pickles the ultralytics model itself ({'model': module},
    as FastSAM-x.pt does) needs the ultralytics package to unpickle."""
    if isinstance(sd, str):
        ckpt = torch.load(sd, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt)) if isinstance(ckpt, dict) else ckpt
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k.replace("model.model.", "model.", 1):
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def fastsam_arch(sd: Mapping) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(widths, depths) of the YOLOv8-seg whose port-named `state_dict` is
    `sd`: the output channels of the five strided backbone convs and the
    bottleneck counts of the four backbone C2f blocks."""
    widths = tuple(int(sd[f"model.{i}.conv.weight"].shape[0]) for i in (0, 1, 3, 5, 7))
    depths = []
    for i in (2, 4, 6, 8):
        pat = re.compile(rf"model\.{i}\.m\.(\d+)\.")
        depths.append(len({m.group(1) for k in sd for m in [pat.match(k)] if m}))
    return widths, tuple(depths)


def load_reference_checkpoint(path, net) -> list:
    """Load a FastSAM checkpoint (ultralytics names; a path or a mapping)
    into the port's `FastSAMNet` `net`. Every parameter and BatchNorm
    statistic of `net` must be in it (a missing `num_batches_tracked` keeps
    the net's own). Returns the checkpoint's keys that were not loaded: the
    DFL conv, and anything the port has no module for."""
    sd = reference_state_dict(path)
    own = net.state_dict()
    missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} FastSAM keys, e.g. {missing[:5]}")
    net.load_state_dict({k: torch.as_tensor(sd[k]) if k in sd else v for k, v in own.items()},
                        strict=True)
    return sorted(set(sd) - set(own))


def random_fastsam_state_dict(net, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded random weights for `net` (its tensors may be on the meta
    device: only names and shapes are read), drawn by a generator on
    `device`: fan-in scaled normal conv kernels, zero conv biases, the
    BatchNorm affine and statistics at their identity (weight 1, bias 0,
    mean 0, variance 1)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for name, t in net.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.int64, device=dev)
        elif leaf in ("weight", "running_var") and len(shape) == 1:
            sd[name] = torch.ones(shape, device=dev)
        elif len(shape) <= 1:
            sd[name] = torch.zeros(shape, device=dev)
        else:
            # a ConvTranspose (in, out, 2, 2) at stride 2 sums `in` terms
            fan_in = shape[0] if "upsample" in name else int(np.prod(shape[1:]))
            sd[name] = fan_in ** -0.5 * torch.randn(shape, generator=g, device=dev)
    return sd


@torch.no_grad()
def rescale_to_input(net, x: torch.Tensor, rms: float = 0.3, head_rms: float = 1.0):
    """Rescale each convolution of `net` (random weights) by one scalar, in
    execution order over one forward pass on `x` (B, 3, S, S), so that its
    output on `x` has the root mean square `rms`; the head's three output
    convs (box, class and coefficient logits) get `head_rms`. In place;
    returns `net`.

    Why: fan-in scaled kernels shrink SiLU activations ~0.6x a conv, so
    FastSAM-x's scores would all sit at 0.5 +- 1e-4, closer together than
    float32 resolves; a small `rms` keeps the SiLUs near their linear part,
    where the many residual adds do not make the network chaotic (unit
    `rms`, or BatchNorm statistics taken from `x`, do)."""
    heads = {m for n, m in net.named_modules()
             if n.startswith("model.22.cv") and n.endswith(".2")}

    def hook(m, _, out):
        r = out.pow(2).mean().sqrt() / (head_rms if m in heads else rms)
        m.weight.div_(r)
        if m.bias is not None:
            m.bias.div_(r)
        return out / r

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        net.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return net


def _conv_bn(sd, prefix, p, s):
    sd[f"{prefix}.conv.weight"] = np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{prefix}.bn.weight"] = np.asarray(p["bn"]["scale"])
    sd[f"{prefix}.bn.bias"] = np.asarray(p["bn"]["bias"])
    sd[f"{prefix}.bn.running_mean"] = np.asarray(s["bn"]["mean"])
    sd[f"{prefix}.bn.running_var"] = np.asarray(s["bn"]["var"])
    sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)


def _children(sd, prefix, p, s):
    """cv1/cv2/cv3 Conv-BN-SiLUs and m_{j} bottlenecks of a C2f, SPPF or
    Proto."""
    for name in p:
        if name.startswith("m_"):
            j = name[2:]
            for cv in ("cv1", "cv2"):
                _conv_bn(sd, f"{prefix}.m.{j}.{cv}", p[name][cv], s[name][cv])
        elif name.startswith("cv"):
            _conv_bn(sd, f"{prefix}.{name}", p[name], s[name])


def fastsam_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX FastSAMNet variables ({'params', 'batch_stats'}) -> port
    `state_dict`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        s = stats[name]
        if name == "proto":
            prefix = "model.22.proto"
            _children(sd, prefix, p, s)
            up = p["upsample"]
            # flax ConvTranspose (kh, kw, in, out), flipped -> torch (in, out, kh, kw)
            sd[f"{prefix}.upsample.weight"] = np.asarray(up["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
            sd[f"{prefix}.upsample.bias"] = np.asarray(up["bias"])
        elif name.startswith("cv"):                  # head branch cv{2,3,4}_{level}
            branch, level = name.split("_")
            prefix = f"model.22.{branch}.{level}"
            _conv_bn(sd, f"{prefix}.0", p["c0"], s["c0"])
            _conv_bn(sd, f"{prefix}.1", p["c1"], s["c1"])
            sd[f"{prefix}.2.weight"] = np.asarray(p["c2"]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{prefix}.2.bias"] = np.asarray(p["c2"]["bias"])
        elif "conv" in p:                            # a strided Conv-BN-SiLU m{i}
            _conv_bn(sd, f"model.{name[1:]}", p, s)
        else:                                        # C2f / SPPF m{i}
            _children(sd, f"model.{name[1:]}", p, s)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
