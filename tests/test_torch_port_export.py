"""Deployment export of the PyTorch port (sam6d_torch/deploy/export.py) and
the `torch.ops.sam6d` operators it relies on (sam6d_torch/kernels/ops.py),
on the CPU at tiny sizes: the round trip and the wrong-shape refusal of
tests/test_export.py; for each operator its fake implementation against the
eager outputs, the CPU operator against its plain version, and its node in
an exported graph; the PEM, SAM decode and DINOv2 describe artifacts against
the JAX package (atol 1e-4); and one artifact run in an interpreter that
cannot import jax or sam6d_tpu."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sam6d_torch.deploy import (export_dinov2_describe, export_fn, export_pem_infer,
                                export_sam_decode, load_exported, pem_example_inputs,
                                save_exported)
from sam6d_torch.kernels import (attention, attention_qkv, attention_relpos, ball_query,
                                 factored, fps, nms)
from sam6d_torch.kernels.ops import OPS

from torch_port_common import (close, jax_variables, one_torch_thread,  # noqa: F401
                               tiny_cfg, tiny_dinov2_weights, tiny_inputs, tiny_ism_cfgs,
                               tiny_sam_cfgs, tiny_sam_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4          # the JAX export test's own
BF16_ATOL = 8e-3     # the bf16 kernels' tolerance


def test_export_roundtrip_simple(tmp_path):
    def f(x, y):
        return {"s": torch.sin(x) @ y, "n": torch.linalg.vector_norm(x)}

    x = torch.from_numpy(np.random.RandomState(0).rand(8, 16).astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).rand(16, 4).astype(np.float32))
    path = save_exported(export_fn(f, (x, y), device="cpu"), str(tmp_path / "f.pt2"))
    runner = load_exported(path)
    out, ref = runner(x, y), f(x, y)
    close(out["s"], ref["s"], atol=1e-6, rtol=0)
    close(out["n"], ref["n"], atol=1e-6, rtol=0)
    assert runner.device == torch.device("cpu")
    assert runner.in_specs == [((8, 16), torch.float32), ((16, 4), torch.float32)]
    assert runner.out_specs == [((8, 4), torch.float32), ((), torch.float32)]


def test_export_rejects_wrong_shape():
    runner = load_exported(export_fn(lambda x: x * 2, (torch.zeros(4, 4),), device="cpu"))
    with pytest.raises(Exception):
        runner(torch.zeros(5, 4))


# ------------------------------------------------------ the sam6d operators


def _op_case(name, dtype):
    """(public dispatch function, its plain version, args) at tiny sizes."""
    rng = np.random.RandomState(sum(map(ord, name)))

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy(((rng.rand(*shape) - offset) * scale).astype(np.float32)).to(dtype)

    if name == "farthest_point_sample":
        valid = torch.from_numpy(rng.rand(2, 50) > 0.2)
        return fps.farthest_point_sample, fps.farthest_point_sample_plain, (t(2, 50, 3), 6, valid)
    if name == "two_scale_ball_query":
        return (ball_query.two_scale_ball_query, ball_query.two_scale_ball_query_plain,
                (t(2, 40, 3), t(2, 10, 3), 0.3, 4, 0.6, 8))
    if name == "nms_fixed_point":
        overlap = torch.from_numpy(np.tril(rng.rand(24, 24) > 0.7, -1))
        return nms.nms_fixed_point, nms.nms_fixed_point_plain, (
            overlap, torch.from_numpy(rng.rand(24) > 0.2))
    sfx = "_bf16_plain" if dtype == torch.bfloat16 else "_plain"
    if name == "fused_attention_qkv":
        return (attention_qkv.fused_attention_qkv, getattr(attention_qkv, name + sfx),
                (t(2, 9, 96, offset=0.5), 2, 0.25))
    if name in ("fused_attention", "fused_attention_small"):
        # strided head-major views of a fused projection, as models/vit.py passes them
        q, k, v = t(2, 9, 3, 2, 16, offset=0.5).permute(2, 0, 3, 1, 4)
        return getattr(attention, name), getattr(attention, name + sfx), (q, k, v, 0.25)
    if name == "flash_attention_relpos":
        return (attention_relpos.flash_attention_relpos, getattr(attention_relpos, name + sfx),
                (t(2, 12, 96, offset=0.5), t(5, 16, offset=0.5), t(7, 16, offset=0.5),
                 (3, 4), 2))
    B, N, C, d, T, heads = 3, 40, 32, 16, 7, 8
    blocks = ((t(B, 5, N), t(B, N, offset=-0.5)), (t(B, 2, N), None))
    R = 7
    if name == "factored_ln_stats":
        args = (blocks, t(B, R, C, offset=0.5), t(N, C, offset=0.5), t(B, N, offset=-0.5))
    elif name == "factored_t2i_attention":
        args = (t(B, T, d, offset=0.5), t(B, R, d, offset=0.5), t(B, R, d, offset=0.5),
                blocks, t(B, N, offset=-0.5), t(N, d, offset=0.5), t(N, d, offset=0.5),
                t(N, d, offset=0.5), heads)
    else:
        args = (t(B, T, d, offset=0.5), t(B, R, d, offset=0.5), blocks, t(B, N, offset=-0.5),
                t(N, d, offset=0.5), t(N, d, offset=0.5), heads)
    return getattr(factored, name), getattr(factored, name + sfx), args


OP_CASES = [(n, torch.float32) for n in OPS] + [
    (n, torch.bfloat16) for n in OPS if n not in ("farthest_point_sample",
                                                  "two_scale_ball_query", "nms_fixed_point")]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,dtype", OP_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in OP_CASES])
def test_sam6d_op_fake_cpu_and_export(name, dtype):
    public, plain, args = _op_case(name, dtype)
    got = _flat(public(*args))
    want = _flat(plain(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)

    # the fake implementation gives what the eager outputs are
    with FakeTensorMode() as mode:
        fargs = torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
        fake = _flat(public(*fargs))
    for f, g in zip(fake, got):
        assert (tuple(f.shape), f.dtype, f.stride()) == (tuple(g.shape), g.dtype, g.stride())

    # an exported module that calls the dispatch keeps the operator as a node
    class Call(torch.nn.Module):
        def forward(self, *tensors):
            it = iter(tensors)
            return public(*torch.utils._pytree.tree_map_only(torch.Tensor,
                                                             lambda _: next(it), args))

    leaves = [x for x in torch.utils._pytree.tree_leaves(args) if isinstance(x, torch.Tensor)]
    program = torch.export.export(Call(), tuple(leaves))
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert getattr(torch.ops.sam6d, name).default in targets
    for g, e in zip(got, _flat(program.module()(*leaves))):
        assert torch.equal(g, e)


# ------------------------------------------------------------ the artifacts


def test_pem_artifact_matches_jax_apply(tmp_path):
    """The PEM artifact, fed the uniforms JAX's sampler draws from its key,
    against JAX's PEMNet.apply on the same weights. JAX is run eagerly: under
    jit, XLA folds the structure embedding's `cos_v + 0.0`, so a -0.0 on the
    diagonal gives a wedge angle of pi there instead of the reference's 0
    (test_torch_port_pem_slice.py); the port computes the reference's 0, and
    at these weights the jitted program's coarse pose is another hypothesis
    (pred_R apart by 1.9), the eager one's the same (pred_R within 6e-6)."""
    cfg = tiny_cfg()
    B = 2
    raw = tiny_inputs(np.random.RandomState(0), cfg, B)
    raw["pe_o"] = np.random.RandomState(1).rand(B, cfg.fine_npoint,
                                                cfg.fine.hidden_dim).astype(np.float32)
    jnet, variables = jax_variables(cfg)
    key = jax.random.PRNGKey(7)
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in raw.items()}, key)

    from sam6d_torch.weights.pem import pem_state_dict_from_flax
    path = str(tmp_path / "pem.pt2")
    export_pem_infer(cfg, pem_state_dict_from_flax(variables), batch_size=B, path=path,
                     device="cpu")
    runner = load_exported(path)
    example = pem_example_inputs(cfg, B, device="cpu")
    inputs = {k: torch.from_numpy(np.asarray(v)).to(example[k].dtype) for k, v in raw.items()}
    # the uniforms JAX's sampler draws from its key (ops/sampling.py)
    inputs["u"] = torch.from_numpy(np.array(jax.random.uniform(
        key, (B, 3 * cfg.coarse.nproposal1), dtype=jnp.float32)))
    assert set(inputs) == set(example)
    out = runner(inputs)
    for k in ("pred_R", "pred_t", "pred_pose_score"):
        close(out[k], want[k], atol=ATOL, rtol=0)
    R = out["pred_R"][0].numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-3)


def test_sam_decode_artifact_matches_jax_artifact(tmp_path):
    from sam6d_tpu.deploy import export_sam_decode as jax_export_sam_decode
    from sam6d_tpu.deploy import load_exported as jax_load_exported
    jcfg, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, rng=np.random.RandomState(2))
    g, C, P = pcfg.img_size // pcfg.patch_size, pcfg.prompt_embed_dim, 2
    jrun = jax_load_exported(jax_export_sam_decode(jcfg, variables, num_prompts=P,
                                                   platforms=("cpu",)))
    path = str(tmp_path / "decode.pt2")
    export_sam_decode(pcfg, sd, num_prompts=P, path=path, device="cpu")
    prun = load_exported(path)

    rng = np.random.RandomState(3)
    emb = (rng.randn(g, g, C) * 0.1).astype(np.float32)
    pts = (rng.rand(P, 1, 2) * pcfg.img_size).astype(np.float32)
    mask_in = rng.randn(P, 4 * g, 4 * g, 1).astype(np.float32)
    for has_mask in (0.0, 1.0):
        want_m, want_iou = jrun(emb, pts, np.ones((P, 1), np.int32), mask_in,
                                np.float32(has_mask))
        got_m, got_iou = prun(torch.from_numpy(emb), torch.from_numpy(pts),
                              torch.ones((P, 1), dtype=torch.int64),
                              torch.from_numpy(mask_in), torch.tensor(has_mask))
        assert got_m.shape == (P, 4, 4 * g, 4 * g) and got_iou.shape == (P, 4)
        close(got_m, want_m, atol=ATOL, rtol=0)
        close(got_iou, want_iou, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def describe(tmp_path_factory):
    """(port cfg, unfolded state dict, JAX variables, crops, fp32 artifact path)."""
    jcfg, pcfg = tiny_ism_cfgs()
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(5))
    d = pcfg.dinov2
    crops = np.random.RandomState(6).rand(3, d.img_size, d.img_size, 3).astype(np.float32)
    path = str(tmp_path_factory.mktemp("describe") / "dinov2.pt2")
    export_dinov2_describe(d, sd, batch=3, path=path, device="cpu")
    return jcfg, pcfg, sd, variables, crops, path


def test_describe_artifact_matches_jax_artifact(describe):
    from sam6d_tpu.deploy import export_dinov2_describe as jax_export_describe
    from sam6d_tpu.deploy import load_exported as jax_load_exported
    jcfg, _, _, variables, crops, path = describe
    want_cls, want_patch = jax_load_exported(jax_export_describe(
        jcfg.dinov2, variables, batch=3, platforms=("cpu",)))(crops)
    runner = load_exported(path)
    targets = [n.target for n in runner.program.graph.nodes]
    assert targets.count(torch.ops.sam6d.fused_attention_qkv.default) == jcfg.dinov2.depth
    cls, patch = runner(torch.from_numpy(crops))
    close(cls, want_cls, atol=ATOL, rtol=0)
    close(patch, want_patch, atol=ATOL, rtol=0)


def test_describe_bf16_artifact_matches_direct_bf16_describe(describe):
    from sam6d_torch.pipelines.ism import ISMPipeline
    _, pcfg, sd, _, crops, _ = describe
    runner = load_exported(export_dinov2_describe(pcfg.dinov2, sd, batch=3, device="cpu",
                                                  dtype=torch.bfloat16))
    x = torch.from_numpy(crops)
    cls, patch = runner(x)
    with torch.no_grad():
        want_cls, want_patch = ISMPipeline(pcfg, state_dict=sd, device="cpu",
                                           dtype=torch.bfloat16).dinov2(x)
    assert cls.dtype == patch.dtype == torch.bfloat16
    close(cls.float(), want_cls.float(), atol=BF16_ATOL, rtol=0)
    close(patch.float(), want_patch.float(), atol=BF16_ATOL, rtol=0)


def test_artifact_runs_where_jax_cannot_be_imported(describe, tmp_path):
    """The saved describe artifact, loaded in a fresh interpreter whose
    imports of jax, flax, jaxlib and sam6d_tpu fail, gives the outputs it
    gives here."""
    _, _, _, _, crops, path = describe
    np.save(tmp_path / "crops.npy", crops)
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sam6d_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from sam6d_torch.deploy import load_exported\n"
        f"runner = load_exported({path!r})\n"
        f"cls, patch = runner(torch.from_numpy(np.load({str(tmp_path / 'crops.npy')!r})))\n"
        f"np.save({str(tmp_path / 'cls.npy')!r}, cls.numpy())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'sam6d_tpu')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    cls, _ = load_exported(path)(torch.from_numpy(crops))
    np.testing.assert_array_equal(np.load(tmp_path / "cls.npy"), cls.numpy())
