"""Deployment export: the port's programs as `torch.export` artifacts.

Port of `sam6d_tpu/deploy/export.py`, in PyTorch's idiom: a program is
traced by `torch.export.export` at static shapes on example inputs on one
device (JAX's `platforms` becomes `device`), its weights are captured into
the artifact, and `torch.export.save` serialises it to bytes. Three
programs are exported, as in the JAX package:

- PEM inference (`export_pem_infer`): runs FPS (K7) and the two-scale ball
  query (K6);
- the SAM prompt decode (`export_sam_decode`): the scope of the reference's
  ONNX model (segment_anything/utils/onnx.py); it runs no kernel;
- the DINOv2 describe (`export_dinov2_describe`): the fused-attention
  network of the ISM, which runs K5 (K8 at 448).

Every kernel is the operator `torch.ops.sam6d.<name>`
(`sam6d_torch/kernels/ops.py`), so the artifact's graph holds it as one node
and a card run of the artifact launches the hand-written kernel. What the
artifact needs that the JAX one does not: an importable `sam6d_torch`, which
registers the operators and holds their CUDA sources; `load_exported`
imports it, and the kernel library is built at its first use, as
everywhere in the port. The weights are inside the artifact.

Typical use:

    data = export_pem_infer(cfg, state_dict, batch_size=16, path="pem.pt2")
    ...
    runner = load_exported("pem.pt2")
    out = runner(inputs)            # dict with pred_R / pred_t / score
"""
from __future__ import annotations

import io
import os
from typing import Any, Callable, Dict, Sequence

import torch
from torch import nn

from ..core.params import cast_float_params


class _Program(nn.Module):
    """A callable as a module, so `torch.export` can trace it; `modules`
    are registered so their weights become the program's parameters."""

    def __init__(self, fn: Callable, **modules: nn.Module):
        super().__init__()
        self.fn = fn
        self.parts = nn.ModuleDict(modules)

    def forward(self, *args):
        return self.fn(*args)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def export_fn(fn: Callable, example_args: Sequence[Any], device="cuda") -> bytes:
    """Trace `fn` (an `nn.Module` or a callable) at the static shapes of
    `example_args`, moved with the module to `device`, and serialise it.

    A module's parameters and buffers, and tensors a callable closes over,
    are captured into the artifact, so it is self-contained."""
    module = fn if isinstance(fn, nn.Module) else _Program(fn)
    module = module.to(device).eval()
    with torch.no_grad():
        program = torch.export.export(module, tuple(_to(list(example_args), device)))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_exported(data: bytes, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _spec(node):
    val = node.meta["val"]
    return tuple(val.shape), val.dtype


class ExportedRunner:
    """A loaded artifact: call it with the example inputs' structure.
    `in_specs` / `out_specs` are the (shape, dtype) of each flattened input
    and output (JAX's in_avals / out_avals), `device` the device it was
    traced on. A wrong input shape raises (the program's own input check)."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()
        user_inputs = set(program.graph_signature.user_inputs)
        nodes = list(program.graph.nodes)
        inputs = [n for n in nodes if n.op == "placeholder" and n.name in user_inputs]
        outputs = nodes[-1].args[0]
        self.in_specs = [_spec(n) for n in inputs]
        self.out_specs = [_spec(n) for n in outputs
                          if isinstance(n, torch.fx.Node) and "val" in n.meta]
        self.device = inputs[0].meta["val"].device if inputs else torch.device("cpu")

    def __call__(self, *args):
        with torch.no_grad():
            return self.module(*args)


def load_exported(path_or_bytes) -> ExportedRunner:
    """Load an artifact from a file path or raw bytes. Registers the
    `torch.ops.sam6d` operators first (importing `sam6d_torch.kernels`);
    the kernel library builds at its first use. Like the port's pipelines,
    it turns TF32 off for the process (`use_strict_fp32`): an artifact holds
    no such setting, and cuDNN's convolutions default to TF32."""
    from .. import use_strict_fp32
    from ..kernels import ops  # noqa: F401  (registers torch.ops.sam6d)
    use_strict_fp32()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(bytes(path_or_bytes))
    else:
        f = path_or_bytes
    return ExportedRunner(torch.export.load(f))


def pem_example_inputs(cfg, batch_size: int, with_pe_o: bool = True,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Zero-filled inputs with the deployment shapes of PEMNet.infer (see
    PEMPipeline.infer_batch for the production producer of each field),
    plus `u`: the hypothesis sampler's (B, 3 * coarse.nproposal1) uniforms,
    which stand where the JAX artifact takes its key (a torch.Generator
    cannot enter an exported program)."""
    B, S, NF = batch_size, cfg.img_size, cfg.fine_npoint
    z = dict(dtype=torch.float32, device=device)
    inputs = dict(
        rgb=torch.zeros((B, S, S, 3), **z),
        rgb_choose=torch.zeros((B, NF), dtype=torch.int64, device=device),
        pts=torch.zeros((B, NF, 3), **z),
        model=torch.zeros((B, cfg.n_sample_model_point, 3), **z),
        dense_po=torch.zeros((B, NF, 3), **z),
        dense_fo=torch.zeros((B, NF, cfg.vit.out_dim), **z),
    )
    if with_pe_o:
        inputs["pe_o"] = torch.zeros((B, NF, cfg.fine.hidden_dim), **z)
    inputs["u"] = torch.zeros((B, 3 * cfg.coarse.nproposal1), **z)
    return inputs


def _finish(data: bytes, path: str | None) -> bytes:
    if path is not None:
        save_exported(data, path)
    return data


def export_pem_infer(cfg, net_or_state_dict, batch_size: int = 16,
                     path: str | None = None, device="cuda", with_pe_o: bool = True,
                     dtype: torch.dtype = torch.float32) -> bytes:
    """Export the full PEM inference program. The artifact takes one dict
    shaped like `pem_example_inputs(cfg, batch_size, with_pe_o)` (the
    sampler's uniforms under "u") and returns PEMNet.infer's dict (init/pred
    R, t in the input unit, pred_pose_score). `net_or_state_dict`: a PEMNet
    (moved to `device` and cast in place) or its `state_dict`; the weights
    are cast to `dtype`, as PEMPipeline casts them."""
    from ..models.pem import PEMNet

    if isinstance(net_or_state_dict, nn.Module):
        net = net_or_state_dict
    else:
        net = PEMNet(cfg)
        net.load_state_dict(net_or_state_dict, strict=True)
    net = cast_float_params(net.to(device), dtype).eval()
    program = _Program(lambda inputs: net.infer(inputs, u=inputs["u"]), net=net)
    example = (pem_example_inputs(cfg, batch_size, with_pe_o, device),)
    return _finish(export_fn(program, example, device), path)


def export_sam_decode(cfg, state_dict, num_prompts: int = 1, path: str | None = None,
                      device="cuda", dtype: torch.dtype = torch.float32) -> bytes:
    """Export the SAM prompt-encoder + mask-decoder program (the reference's
    SamOnnxModel scope: image embedding in, point prompts and a mask input
    in, masks and iou out). `state_dict`: SAM weights under the reference
    names (only `prompt_encoder.*` and `mask_decoder.*` are read).

    The artifact takes (embedding (g, g, C) channels-last, points (P, N, 2)
    input-frame pixel coordinates, labels (P, N), mask_input (P, 4g, 4g, 1),
    has_mask ()) and returns (masks (P, 4, 4g, 4g) row-major low-res logits,
    iou (P, 4)). Box prompts enter as two labelled corner points (labels
    2/3), the reference ONNX model's packing. `has_mask` weighs the first
    prompt's mask-input embedding against the no-mask embedding, as the JAX
    artifact does, so one artifact serves both cases."""
    from ..models.sam import MaskDecoder, PromptEncoder

    grid = cfg.img_size // cfg.patch_size
    C = cfg.prompt_embed_dim
    pe = PromptEncoder(C, (cfg.img_size, cfg.img_size), (grid, grid))
    dec = MaskDecoder(C)
    for name, part in (("prompt_encoder", pe), ("mask_decoder", dec)):
        part.load_state_dict({k[len(name) + 1:]: v for k, v in state_dict.items()
                              if k.startswith(name + ".")}, strict=True)
    pe = cast_float_params(pe.to(device), dtype).eval()
    dec = cast_float_params(dec.to(device), dtype).eval()

    def fn(embedding, points, labels, mask_input, has_mask):
        sparse = pe.embed_points(points, labels)
        dense = has_mask * pe.embed_masks(mask_input)[0] + (1.0 - has_mask) * pe.no_mask_dense()
        # as SAMSegmentor._decode_chunk feeds the decoder; the embedding
        # comes in float32 and is cast to the decoder's dtype
        return dec(embedding.to(dtype), pe.dense_pe(), sparse, dense)

    z = dict(dtype=torch.float32, device=device)
    example = (torch.zeros((grid, grid, C), **z),
               torch.zeros((num_prompts, 1, 2), **z),
               torch.zeros((num_prompts, 1), dtype=torch.int64, device=device),
               torch.zeros((num_prompts, 4 * grid, 4 * grid, 1), **z),
               torch.zeros((), **z))
    return _finish(export_fn(_Program(fn, prompt_encoder=pe, mask_decoder=dec), example,
                             device), path)


def export_dinov2_describe(cfg, state_dict, batch: int = 16, path: str | None = None,
                           device="cuda", dtype: torch.dtype = torch.float32) -> bytes:
    """Export the DINOv2 descriptor program of the ISM: normalised crops
    (B, S, S, 3) in, (cls (B, C), patch (B, N, C)) descriptors out, in
    `dtype`. The network is the describe's own (`ISMPipeline`): the block
    LayerNorm affines folded (`fold_ln_affine` of the unfolded
    `state_dict`), the fused-attention kernels on, so the artifact runs K5
    (K8 when the sequence is longer than 1024 tokens) in `dtype`'s entry."""
    from ..models.dinov2 import DINOv2, fold_ln_affine

    net = DINOv2(cfg.img_size, cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads,
                 use_flash=True, ln_folded=True)
    net.load_state_dict(fold_ln_affine(state_dict), strict=True)
    net = cast_float_params(net.to(device), dtype).eval()
    example = (torch.zeros((batch, cfg.img_size, cfg.img_size, 3), dtype=torch.float32,
                           device=device),)
    return _finish(export_fn(net, example, device), path)
